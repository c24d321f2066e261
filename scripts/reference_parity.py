"""Retrieval parity on the REAL SQuAD e5 embeddings (data/squad_real_*).

BASELINE.md's north star requires recall@5 on SQuAD matching the reference
exactly — both systems do exact search, so on identical embeddings the top-k
index sets must be identical. Retrieval is embedding-in/indices-out, so this
parity check needs no model weights at all: it loads the repo's copy of the
reference's published artifacts (real multilingual-e5-large passage
embeddings, (1000, 1024) f32 L2-normalized, built by the reference's
scripts/squad_dataset.py:104-131) and compares four stacks on the same
queries:

  1. `reference_cosine_topk` — an independent numpy implementation of the
     reference CuPy retriever's MATH (reference retriever.py:594-611:
     sims = X @ Y.T / (||X||·||Y||^T + 1e-8), clipped to [-1, 1]; then
     per-row argpartition + descending argsort, retriever.py:750-769);
  2. our jnp oracle (`cosine_topk_reference`);
  3. the serving path (`cosine_topk`: GEMM + lax.top_k on the device);
  4. the mesh-sharded path (`sharded_cosine_topk`, 8 virtual devices).

Queries: (a) the passages themselves — self-retrieval on an exact index must
give recall@1 == 1.0; (b) noise-perturbed passages at several SNRs — a
realistic neighborhood structure on the true e5 geometry (clustered, not
Gaussian) where near-ties actually occur.

Usage: python scripts/reference_parity.py [--ref-data DIR]
Prints a JSON report; exits non-zero on any index-set mismatch.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def reference_cosine_topk(corpus: np.ndarray, queries: np.ndarray, k: int):
    """Numpy re-statement of the reference CuPy retriever's math
    (reference retriever.py:594-611 + 750-769). Returns (B, k) indices."""
    dots = queries.astype(np.float32) @ corpus.astype(np.float32).T
    nq = np.linalg.norm(queries, axis=1, keepdims=True)
    nc = np.linalg.norm(corpus, axis=1, keepdims=True)
    sims = dots / (nq @ nc.T + 1e-8)
    sims = np.clip(sims, -1.0, 1.0)
    out = np.empty((queries.shape[0], k), dtype=np.int64)
    for r in range(sims.shape[0]):                      # per-row, like the ref
        cand = np.argpartition(sims[r], sims.shape[1] - k)[-k:]
        out[r] = cand[np.argsort(-sims[r][cand], kind="stable")]
    return out


def run_parity(ref_data: str, n_queries: int = 128, k: int = 5,
               seed: int = 42) -> dict:
    import jax
    import jax.numpy as jnp

    from rag_serving_system.ops.topk import cosine_topk, cosine_topk_reference

    pref = ("squad_real" if os.path.exists(
        os.path.join(ref_data, "squad_real_embeddings.npy")) else "squad")
    corpus = np.load(os.path.join(ref_data, pref + "_embeddings.npy"))
    assert corpus.shape[1] == 1024, corpus.shape
    n = corpus.shape[0]

    rng = np.random.default_rng(seed)
    sel = rng.choice(n, size=n_queries, replace=False)

    report = {"corpus": list(corpus.shape), "k": k, "n_queries": n_queries,
              "backend": jax.default_backend(), "cases": {}}
    ok = True

    def check(name, queries, gold=None):
        nonlocal ok
        ref_idx = reference_cosine_topk(corpus, queries, k)
        jq = jnp.asarray(queries)
        jc = jnp.asarray(corpus)
        _, our_idx = cosine_topk_reference(jc, jq, k)
        _, sv_idx = cosine_topk(jc, jq, k)
        our_idx, sv_idx = np.asarray(our_idx), np.asarray(sv_idx)
        case = {
            "oracle_vs_reference_identical": bool((our_idx == ref_idx).all()),
            "serving_vs_reference_identical": bool((sv_idx == ref_idx).all()),
        }
        if len(jax.devices()) >= 8:
            from jax.sharding import Mesh
            from rag_serving_system.parallel.sharded_topk import (
                shard_corpus, sharded_cosine_topk)
            mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(4, 2),
                        axis_names=("data", "model"))
            _, sh_idx = sharded_cosine_topk(shard_corpus(jc, mesh), jq, k,
                                            mesh, valid_n=n)
            case["sharded_vs_reference_identical"] = bool(
                (np.asarray(sh_idx) == ref_idx).all())
        if gold is not None:
            case["recall@1"] = round(float((ref_idx[:, 0] == gold).mean()), 4)
            case[f"recall@{k}"] = round(
                float((ref_idx == gold[:, None]).any(axis=1).mean()), 4)
            case["ours_recall@1"] = round(float((our_idx[:, 0] == gold).mean()), 4)
            case[f"ours_recall@{k}"] = round(
                float((our_idx == gold[:, None]).any(axis=1).mean()), 4)
        ok &= all(v for key, v in case.items() if key.endswith("identical"))
        report["cases"][name] = case

    # (a) self-retrieval: exact search must return the passage itself first
    check("self_retrieval", corpus[sel].copy(), gold=sel)

    # (b) noisy queries at decreasing SNR — near-ties appear as noise grows
    for sigma in (0.05, 0.2, 0.5):
        noise = rng.standard_normal((n_queries, corpus.shape[1])).astype(np.float32)
        q = corpus[sel] + sigma * noise
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        check(f"noisy_sigma_{sigma}", q.astype(np.float32), gold=sel)

    report["all_identical"] = bool(ok)
    return report


def main() -> None:
    p = argparse.ArgumentParser()
    repo_data = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "data")
    p.add_argument("--ref-data", default=repo_data)
    p.add_argument("--n-queries", type=int, default=128)
    p.add_argument("--k", type=int, default=5)
    args = p.parse_args()
    if not any(os.path.exists(os.path.join(args.ref_data, f))
               for f in ("squad_real_embeddings.npy", "squad_embeddings.npy")):
        print(json.dumps({"skipped": f"no reference data at {args.ref_data}"}))
        return
    report = run_parity(args.ref_data, n_queries=args.n_queries, k=args.k)
    print(json.dumps(report, indent=1))
    sys.exit(0 if report["all_identical"] else 1)


if __name__ == "__main__":
    main()
