"""On-chip A/B + mechanics study of speculative vs sequential greedy decode.

Arms, at the decode-heavy shape (default B=32, prompt 512, mnt=64, int8
weights — the `mnt64` regime where sequential decode sits at the
weight-streaming roofline):

  prefill      — generate(mnt=1): prefill + one step (subtracted from the
                 other arms to isolate decode cost)
  base         — sequential greedy decode
  spec g=N     — production speculative arm (n-gram drafter): whatever
                 acceptance THIS workload gives (random-init weights don't
                 loop and don't copy, so expect ~0 here; trained RAG models
                 are the real market — prompt-lookup decoding literature)
  oracle pN    — CONTROLLED acceptance: drafts are the base output with a
                 fraction p of positions corrupted — maps the
                 acceptance → speedup curve of the verify machinery itself
  f32diag      — one base-vs-spec comparison in float32 (slow, REPS=1):
                 distinguishes "bf16 near-tie argmax flips under a different
                 reduction shape" (expected, same class as batch-composition
                 effects) from a logic bug (would diverge at f32 too)

Timing: chained dispatches, one host sync. Usage:
  BATCH=32 PROMPT=512 MNT=64 GAMMAS=2,4 REPS=4 python scripts/profile_spec_decode.py
Set SKIP_F32=1 to drop the f32 diagnostic (it compiles a second program set).
One JSON line per arm.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from rag_serving_system.backend import setup_compile_cache

setup_compile_cache()

from rag_serving_system.models.configs import QWEN25_15B, QWEN2_TINY
from rag_serving_system.models.qwen2 import (_spec_decode_loop, generate,
                                             prefill)
from rag_serving_system.models.weights import init_decoder_params

REPS = int(os.environ.get("REPS", "4"))
BATCH = int(os.environ.get("BATCH", "32"))
PROMPT = int(os.environ.get("PROMPT", "512"))
MNT = int(os.environ.get("MNT", "64"))
GAMMAS = [int(x) for x in os.environ.get("GAMMAS", "2,4").split(",")]
CORRUPT = [float(x) for x in os.environ.get("CORRUPT", "0,0.25,0.5").split(",")]
TINY = os.environ.get("TINY") == "1"
SKIP_F32 = os.environ.get("SKIP_F32") == "1"


def emitted_lengths(toks, pad_id):
    return (np.asarray(toks) != pad_id).sum(axis=1)


def main() -> None:
    cfg = QWEN2_TINY if TINY else QWEN25_15B
    dtype = jnp.float32 if TINY else jnp.bfloat16
    params = init_decoder_params(cfg, dtype=dtype)
    if os.environ.get("QUANT", "int8") == "int8" and not TINY:
        from rag_serving_system.ops.quant import quantize_decoder_params
        params = quantize_decoder_params(params, bits=8)

    rng = np.random.default_rng(0)
    ids = jnp.asarray(rng.integers(10, cfg.vocab_size - 10, (BATCH, PROMPT)),
                      jnp.int32)
    mask = jnp.ones((BATCH, PROMPT), jnp.int32)
    key = jax.random.PRNGKey(0)
    print(f"[spec] backend={jax.default_backend()} B={BATCH} P={PROMPT} "
          f"mnt={MNT} cfg={'tiny' if TINY else 'full'}", file=sys.stderr)

    def timed(fn):
        out = fn()
        out = jax.tree.map(np.asarray, out)    # sync via a host transfer
        t0 = time.time()
        for _ in range(REPS):
            live = fn()
        live = jax.tree.map(np.asarray, live)
        return (time.time() - t0) / REPS * 1e3, live

    # prefill-only floor: prefill + first token
    pre_ms, _ = timed(lambda: generate(
        params, cfg, ids, mask, key, max_new_tokens=1, do_sample=False,
        dtype=dtype))
    print(json.dumps({"arm": "prefill+1", "ms_per_batch": round(pre_ms, 1)}))

    base_ms, base_toks = timed(lambda: generate(
        params, cfg, ids, mask, key, max_new_tokens=MNT, do_sample=False,
        dtype=dtype))
    dec_base = base_ms - pre_ms
    step_ms = dec_base / (MNT - 1)
    print(json.dumps({
        "arm": "base", "ms_per_batch": round(base_ms, 1),
        "decode_ms": round(dec_base, 1),
        "ms_per_token_decode": round(step_ms, 2),
        "mean_emitted": float(emitted_lengths(base_toks, cfg.pad_token_id).mean())}))

    def spec_arm(gamma, draft_source, label):
        def run():
            logits0, cache = prefill(params, cfg, ids, mask, MNT + gamma,
                                     dtype=dtype)
            return _spec_decode_loop(params, cfg, logits0, cache, mask,
                                     MNT, gamma, dtype, None, PROMPT, ids,
                                     draft_source=draft_source)
        ms, (out, iters) = timed(run)
        iters = int(iters)
        em = float(emitted_lengths(out, cfg.pad_token_id).mean())
        dec = ms - pre_ms
        it_ms = dec / max(iters, 1)
        mismatch = int((np.asarray(out) != np.asarray(base_toks)).any(axis=1).sum())
        first_div = -1
        neq = np.asarray(out) != np.asarray(base_toks)
        if neq.any():
            first_div = int(np.argmax(neq.any(axis=0)))
        print(json.dumps({
            "arm": label, "ms_per_batch": round(ms, 1),
            "decode_ms": round(dec, 1),
            "verify_iters": iters,
            "ms_per_verify_iter": round(it_ms, 2),
            "iter_cost_vs_step": round(it_ms / step_ms, 2),
            "tokens_per_iter": round((em - 1) / max(iters, 1), 2),
            "speedup_vs_base_decode": round(dec_base / max(dec, 1e-9), 2),
            "rows_diverging_from_base": mismatch,
            "first_divergent_column": first_div}))

    for g in GAMMAS:
        spec_arm(g, None, f"spec_g{g}")            # production drafter
        for pcorr in CORRUPT:
            oracle = np.array(base_toks, copy=True)
            if pcorr > 0:
                r2 = np.random.default_rng(1)
                flip = r2.random(oracle.shape) < pcorr
                oracle = np.where(flip, (oracle + 7) % cfg.vocab_size, oracle)
            spec_arm(g, jnp.asarray(oracle, jnp.int32),
                     f"oracle_g{g}_corrupt{pcorr:g}")

    if not SKIP_F32 and not TINY:
        # f32 logic check on the REAL chip: algorithm bug would diverge here
        # too; bf16 near-tie flips would not
        p32 = init_decoder_params(cfg, dtype=jnp.float32)
        b32 = np.asarray(generate(p32, cfg, ids, mask, key, max_new_tokens=8,
                                  do_sample=False, dtype=jnp.float32))
        logits0, cache = prefill(p32, cfg, ids, mask, 8 + 4, dtype=jnp.float32)
        s32, _ = _spec_decode_loop(p32, cfg, logits0, cache, mask, 8, 4,
                                   jnp.float32, None, PROMPT, ids)
        print(json.dumps({"arm": "f32diag_mnt8",
                          "exact_match": bool((np.asarray(s32) == b32).all())}))


if __name__ == "__main__":
    main()
