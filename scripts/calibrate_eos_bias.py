"""Calibrate EOS_BIAS → completion-length distribution on the full-size
model (random init, sampling on — the serving default). The Poisson A/B
(scripts/server_budget_poisson_ab.sh) needs bias values whose mean lengths
land around mnt/8, mnt/4, mnt/2 to map the pool-vs-fixed crossover against
length VARIANCE.

Usage: BATCH=32 PROMPT=512 MNT=64 BIASES=2,4,6,8,10 python scripts/calibrate_eos_bias.py
One JSON line per bias: mean/std/min/max completion length.
"""

from __future__ import annotations

import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from rag_serving_system.backend import setup_compile_cache

setup_compile_cache()

from rag_serving_system.models.configs import QWEN25_15B, QWEN2_TINY
from rag_serving_system.models.qwen2 import generate
from rag_serving_system.models.weights import init_decoder_params

BATCH = int(os.environ.get("BATCH", "32"))
PROMPT = int(os.environ.get("PROMPT", "512"))
MNT = int(os.environ.get("MNT", "64"))
BIASES = [float(x) for x in os.environ.get("BIASES", "2,4,6,8,10").split(",")]
TINY = os.environ.get("TINY") == "1"


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
    for bias in BIASES:
        toks = np.asarray(generate(
            params, cfg, ids, mask, jax.random.PRNGKey(7),
            max_new_tokens=MNT, do_sample=True, dtype=dtype, eos_bias=bias))
        ln = (toks != cfg.pad_token_id).sum(axis=1)
        print(json.dumps({"eos_bias": bias, "mnt": MNT,
                          "mean_len": round(float(ln.mean()), 1),
                          "std_len": round(float(ln.std()), 1),
                          "min": int(ln.min()), "max": int(ln.max())}))


if __name__ == "__main__":
    main()
