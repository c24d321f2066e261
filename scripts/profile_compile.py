"""Cold-start compile-time decomposition.

Times each XLA program the serving engine compiles on its cold path,
separately, against a FRESH compilation cache — so the wall-clock budget of
"first batch" can be attributed per program instead of guessed.

Usage:
  python scripts/profile_compile.py            (cold: no persistent cache)
  JAX_COMPILATION_CACHE_DIR=DIR python scripts/profile_compile.py   (warm)

Prints one JSON line per program: {"program", "compile_s", "n_hlo_chars"}.
"""

from __future__ import annotations

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    import jax
    import jax.numpy as jnp

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

    from rag_serving_system.models.configs import (
        QWEN25_15B, encoder_config_for)
    from rag_serving_system.models.qwen2 import compute_prefix_kv, generate
    from rag_serving_system.models.weights import (
        init_decoder_params, init_encoder_params)

    dec_cfg = QWEN25_15B
    enc_cfg = encoder_config_for("full")
    b = int(os.environ.get("PROFILE_BATCH", "32"))
    results = []

    def timed(name, fn):
        t0 = time.time()
        out = fn()
        dt = time.time() - t0
        results.append({"program": name, "seconds": round(dt, 1)})
        print(json.dumps(results[-1]), file=sys.stderr, flush=True)
        return out

    t0 = time.time()
    dec_params = timed("init_decoder_params(1.5B)",
                       lambda: init_decoder_params(dec_cfg, dtype=jnp.bfloat16))
    enc_params = timed("init_encoder_params(e5-large)",
                       lambda: init_encoder_params(enc_cfg, dtype=jnp.bfloat16))

    from rag_serving_system.ops.quant import quantize_decoder_params
    dec_params = timed("quantize_decoder_params(int8)",
                       lambda: jax.block_until_ready(
                           quantize_decoder_params(dec_params)))

    # --- stage 1: fused encode+retrieve (engine._encode_retrieve_compiled) ---
    from rag_serving_system.core.engine import _encode_retrieve_compiled
    corpus = jnp.zeros((100, enc_cfg.hidden_size), jnp.float32)
    ids = jnp.zeros((b, 32), jnp.int32)
    mask = jnp.ones((b, 32), jnp.int32)
    timed(f"encode_retrieve b={b} len=32 (AOT compile)",
          lambda: _encode_retrieve_compiled.lower(
              enc_params, enc_cfg, ids, mask, corpus, 16, True,
              jnp.bfloat16).compile())

    # --- prefix compute (one bucket) ---
    pool_len = 128
    pids = jnp.zeros((8, pool_len), jnp.int32)
    pmask = jnp.ones((8, pool_len), jnp.int32)
    timed(f"compute_prefix_kv m=8 pl={pool_len} (AOT)",
          lambda: compute_prefix_kv.lower(
              dec_params, dec_cfg, pids, pmask, dtype=jnp.bfloat16,
              act_quant=True).compile())

    # --- generate: prefix variant at suffix bucket 32 ---
    rng = jax.random.PRNGKey(0)
    sids = jnp.zeros((b, 32), jnp.int32)
    smask = jnp.ones((b, 32), jnp.int32)
    pkv = jnp.zeros((b, dec_cfg.num_layers, 2, pool_len,
                     dec_cfg.num_kv_heads, dec_cfg.head_dim), jnp.bfloat16)
    plen = jnp.zeros((b,), jnp.int32)
    rv = jnp.ones((b,), bool)
    timed(f"generate prefix b={b} s=32 pl={pool_len} (AOT)",
          lambda: generate.lower(
              dec_params, dec_cfg, sids, smask, rng, max_new_tokens=10,
              do_sample=True, dtype=jnp.bfloat16, row_valid=rv,
              act_quant=True, prefix_kv=pkv, prefix_len=plen).compile())

    # --- generate: no-prefix at prompt bucket 64 ---
    gids = jnp.zeros((b, 64), jnp.int32)
    gmask = jnp.ones((b, 64), jnp.int32)
    timed(f"generate noprefix b={b} p=64 (AOT)",
          lambda: generate.lower(
              dec_params, dec_cfg, gids, gmask, rng, max_new_tokens=10,
              do_sample=True, dtype=jnp.bfloat16, row_valid=rv,
              act_quant=True).compile())

    print(json.dumps({"total_s": round(time.time() - t0, 1),
                      "programs": results}))


if __name__ == "__main__":
    main()
