"""Contrastive training: loss sanity, a real optimization step improving the
loss, and checkpoint round-trip."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from rag_serving_system.models.configs import E5_TINY
from rag_serving_system.models.tokenizer import HashTokenizer
from rag_serving_system.models.weights import init_encoder_params
from rag_serving_system.training.contrastive import (
    contrastive_loss,
    load_checkpoint,
    make_train_step,
    pair_batches,
    save_checkpoint,
    train_encoder,
)

PAIRS = [{"fact": f"the color of object {i} is shade {i}",
          "query": f"what color is object {i}?"} for i in range(32)]


@pytest.fixture(scope="module")
def setup():
    params = init_encoder_params(E5_TINY, seed=0, dtype=jnp.float32)
    tok = HashTokenizer(E5_TINY.vocab_size, pad_id=E5_TINY.pad_token_id)
    return params, tok


def test_loss_is_finite_and_batch_shaped(setup):
    params, tok = setup
    batch = next(pair_batches(tok, PAIRS, batch_size=8, max_len=32))
    loss, acc = contrastive_loss(params, E5_TINY, batch, dtype=jnp.float32)
    assert np.isfinite(float(loss))
    assert 0.0 <= float(acc) <= 1.0


def test_train_step_reduces_loss(setup):
    params, tok = setup
    opt = optax.adamw(5e-4)
    opt_state = opt.init(params)
    step = make_train_step(E5_TINY, opt, dtype=jnp.float32)
    batch = next(pair_batches(tok, PAIRS, batch_size=16, max_len=32))
    losses = []
    for _ in range(8):
        params, opt_state, m = step(params, opt_state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0], losses


def test_train_encoder_loop_runs(setup):
    params, tok = setup
    new_params, history = train_encoder(
        params, E5_TINY, tok, PAIRS, epochs=1, batch_size=16, max_len=32,
        lr=1e-4, dtype=jnp.float32)
    assert len(history) == 2  # 32 pairs / 16
    # params actually changed
    delta = float(jnp.abs(new_params["embed"]["word"] - params["embed"]["word"]).max())
    assert delta > 0


def test_checkpoint_roundtrip(setup, tmp_path):
    params, _ = setup
    path = str(tmp_path / "enc.ckpt")
    save_checkpoint(path, params)
    restored = load_checkpoint(path, params)
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(restored)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
