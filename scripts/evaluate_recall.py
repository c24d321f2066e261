"""Recall@k evaluation over the (query, passage) pairs corpora.

The reference ships pairs files (data/short_facts_pairs.json,
data/squad_pairs.json) but no evaluation harness; the BASELINE requires
recall@5 parity on SQuAD (exact search ⇒ recall is a function of the
embeddings alone). This script embeds the queries with the serving encoder,
retrieves top-k against the corpus embeddings, and reports recall@{1,k}.

Usage:
  python scripts/evaluate_recall.py [--pairs data/short_facts_pairs.json]
      [--embeddings data/short_facts_embeddings.npy] [--k 5] [--retriever exact|sharded|simple]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--pairs", default="data/short_facts_pairs.json")
    p.add_argument("--embeddings", default="data/short_facts_embeddings.npy")
    p.add_argument("--k", type=int, default=5)
    p.add_argument("--retriever", default="exact", choices=["exact", "sharded", "simple"])
    p.add_argument("--batch-size", type=int, default=32)
    args = p.parse_args()

    import jax.numpy as jnp

    from rag_serving_system.config import get_settings
    from rag_serving_system.core.retriever import (
        ShardedRetriever, SimpleRetriever, ExactRetriever)
    from rag_serving_system.models import encoder_config_for
    from rag_serving_system.models.e5 import encode
    from rag_serving_system.models.tokenizer import HashTokenizer, get_tokenizer
    from rag_serving_system.models.weights import get_encoder_params

    with open(args.pairs) as f:
        pairs = json.load(f)
    corpus_emb = np.load(args.embeddings)
    passage_key = "fact" if "fact" in pairs[0] else "context"
    docs = [pr[passage_key] for pr in pairs]

    settings = get_settings()
    cfg = encoder_config_for(settings.model_preset)
    params, real = get_encoder_params(cfg, settings.weights_dir,
                                      settings.embed_model_name)
    tok = (get_tokenizer(settings.embed_model_name, cfg.vocab_size) if real
           else HashTokenizer(cfg.vocab_size, pad_id=cfg.pad_token_id))

    cls = {"exact": ExactRetriever, "sharded": ShardedRetriever,
           "simple": SimpleRetriever}[args.retriever]
    retriever = (cls(corpus_emb, docs) if cls is SimpleRetriever
                 else cls(corpus_emb, docs, max_k=args.k))

    hit1 = hitk = 0
    for i in range(0, len(pairs), args.batch_size):
        chunk = pairs[i:i + args.batch_size]
        ids, mask = tok.encode_batch(
            ["query: " + c["query"] for c in chunk], max_len=64)
        q_emb = np.asarray(encode(params, cfg, jnp.asarray(ids), jnp.asarray(mask)))
        results = retriever.batch_retrieve(q_emb, [args.k] * len(chunk))
        for c, got in zip(chunk, results):
            gold = c[passage_key]
            hit1 += int(len(got) > 0 and got[0] == gold)
            hitk += int(gold in got)

    n = len(pairs)
    print(json.dumps({
        "pairs": n,
        "encoder_weights": "hf" if real else "random-init",
        "retriever": args.retriever,
        "recall@1": round(hit1 / n, 4),
        f"recall@{args.k}": round(hitk / n, 4),
    }))


if __name__ == "__main__":
    main()
