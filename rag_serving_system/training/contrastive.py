"""Contrastive fine-tuning of the query encoder (InfoNCE, in-batch negatives).

The reference is serving-only — its corpora ship (query, passage) pairs
(data/short_facts_pairs.json, data/squad_pairs.json) but nothing trains on
them. This module closes that loop: a jit-compiled optax train
step over the e5 encoder that is mesh-shardable (dp over the batch, TP over
the weights via parallel/tp.py), so retrieval quality can be tuned on the
serving corpus.

Loss: symmetric InfoNCE over L2-normalized mean-pooled embeddings with
temperature tau; in-batch negatives (standard dense-retriever recipe).
"""

from __future__ import annotations

import logging
from typing import Iterator

import jax
import jax.numpy as jnp
import numpy as np
import optax

from rag_serving_system.models.configs import EncoderConfig
from rag_serving_system.models.e5 import encode

logger = logging.getLogger(__name__)


def _embed(params, cfg, ids, mask, dtype):
    emb = encode(params, cfg, ids, mask, pooling="mean_masked", dtype=dtype)
    norm = jnp.linalg.norm(emb, axis=-1, keepdims=True)
    return emb / jnp.maximum(norm, 1e-6)


def contrastive_loss(params, cfg: EncoderConfig, batch, tau: float = 0.05,
                     dtype=jnp.bfloat16):
    """batch = dict(q_ids, q_mask, p_ids, p_mask) all (B, L) int32."""
    q = _embed(params, cfg, batch["q_ids"], batch["q_mask"], dtype)   # (B, H)
    p = _embed(params, cfg, batch["p_ids"], batch["p_mask"], dtype)   # (B, H)
    logits = q @ p.T / tau                                            # (B, B)
    labels = jnp.arange(q.shape[0])
    loss_qp = optax.softmax_cross_entropy_with_integer_labels(logits, labels)
    loss_pq = optax.softmax_cross_entropy_with_integer_labels(logits.T, labels)
    loss = jnp.mean(loss_qp + loss_pq) * 0.5
    acc = jnp.mean((jnp.argmax(logits, axis=-1) == labels).astype(jnp.float32))
    return loss, acc


def make_train_step(cfg: EncoderConfig, optimizer, tau: float = 0.05,
                    dtype=jnp.bfloat16):
    """Returns a jitted (params, opt_state, batch) -> (params, opt_state, metrics)."""

    @jax.jit
    def train_step(params, opt_state, batch):
        def loss_fn(p):
            return contrastive_loss(p, cfg, batch, tau=tau, dtype=dtype)

        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, {"loss": loss, "in_batch_acc": acc}

    return train_step


def pair_batches(tokenizer, pairs, batch_size: int, max_len: int,
                 seed: int = 0, query_key: str = "query",
                 passage_key: str = "fact") -> Iterator[dict]:
    """Yield tokenized (query, passage) batches from a pairs list
    (data/short_facts_pairs.json schema)."""
    rng = np.random.default_rng(seed)
    order = rng.permutation(len(pairs))
    for i in range(0, len(order) - batch_size + 1, batch_size):
        chunk = [pairs[j] for j in order[i:i + batch_size]]
        q_ids, q_mask = tokenizer.encode_batch(
            ["query: " + c[query_key] for c in chunk], max_len)
        p_ids, p_mask = tokenizer.encode_batch(
            ["passage: " + c.get(passage_key, c.get("context", "")) for c in chunk],
            max_len)
        yield {"q_ids": jnp.asarray(q_ids), "q_mask": jnp.asarray(q_mask),
               "p_ids": jnp.asarray(p_ids), "p_mask": jnp.asarray(p_mask)}


def train_encoder(params, cfg: EncoderConfig, tokenizer, pairs,
                  epochs: int = 1, batch_size: int = 16, max_len: int = 64,
                  lr: float = 1e-5, tau: float = 0.05, dtype=jnp.bfloat16,
                  seed: int = 0):
    """Simple training loop. Returns (params, history)."""
    optimizer = optax.adamw(lr)
    opt_state = optimizer.init(params)
    step_fn = make_train_step(cfg, optimizer, tau=tau, dtype=dtype)
    history = []
    for epoch in range(epochs):
        for batch in pair_batches(tokenizer, pairs, batch_size, max_len,
                                  seed=seed + epoch):
            params, opt_state, metrics = step_fn(params, opt_state, batch)
            history.append({k: float(v) for k, v in metrics.items()})
        if history:
            logger.info("epoch %d: loss=%.4f acc=%.3f", epoch,
                        history[-1]["loss"], history[-1]["in_batch_acc"])
    return params, history


# ---------------------------------------------------------------------------
# checkpointing (flax serialization — plain bytes, no directory layout)
# ---------------------------------------------------------------------------

def save_checkpoint(path: str, params) -> None:
    from flax import serialization

    with open(path, "wb") as f:
        f.write(serialization.to_bytes(params))


def load_checkpoint(path: str, params_template):
    from flax import serialization

    with open(path, "rb") as f:
        return serialization.from_bytes(params_template, f.read())
