"""EOS_BIAS: the controlled completion-length-variance knob.

Random-init weights essentially never emit EOS, so every request decodes to
max_new_tokens and the continuous-batching pool's raison d'être (rows
finishing at different lengths) cannot be exercised on this box. EOS_BIAS
adds a constant to the stop-token logits (models/qwen2.py::bias_eos):
+inf-ish → every row stops immediately; moderate positive values under
sampling → geometric-ish lengths whose mean the bias controls. Pinned here:
the knob actually shapes lengths, is honored by every decode path (fixed,
packed, pool, speculative-greedy), and 0 is a bit-exact no-op.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from rag_serving_system.models.configs import QWEN2_TINY
from rag_serving_system.models.qwen2 import generate
from rag_serving_system.models.weights import init_decoder_params

CFG = QWEN2_TINY


@pytest.fixture(scope="module")
def params():
    return init_decoder_params(CFG, dtype=jnp.float32)


def _lengths(toks):
    return (np.asarray(toks) != CFG.pad_token_id).sum(axis=1)


def _gen(params, *, eos_bias=0.0, do_sample=True, spec_gamma=0, mnt=16, b=8):
    rng = np.random.default_rng(1)
    ids = jnp.asarray(rng.integers(10, CFG.vocab_size - 10, (b, 6)), jnp.int32)
    mask = jnp.ones_like(ids)
    return generate(params, CFG, ids, mask, jax.random.PRNGKey(2),
                    max_new_tokens=mnt, do_sample=do_sample,
                    dtype=jnp.float32, eos_bias=eos_bias,
                    spec_gamma=spec_gamma)


def test_zero_bias_is_noop(params):
    np.testing.assert_array_equal(np.asarray(_gen(params, eos_bias=0.0)),
                                  np.asarray(_gen(params)))


def test_huge_bias_stops_every_row_at_one_token(params):
    toks = _gen(params, eos_bias=1e9, do_sample=False)
    assert (_lengths(toks) == 1).all()
    assert (np.asarray(toks)[:, 0] == CFG.eos_token_id).all()


def test_moderate_bias_creates_length_variance(params):
    """Under sampling, a bias that puts EOS in the nucleus gives a spread of
    completion lengths — the workload continuous batching exists for."""
    none = _lengths(_gen(params, eos_bias=0.0, b=16))
    for bias in (0.5, 1.0, 1.5, 2.0, 3.0, 6.0):
        ln = _lengths(_gen(params, eos_bias=bias, b=16))
        if ln.std() > 0 and ln.mean() < none.mean():
            break
    else:
        pytest.fail(f"no tested bias produced length variance "
                    f"(baseline mean {none.mean()})")


def test_bias_consistent_between_spec_and_sequential(params):
    """Greedy + bias must stay bit-exact between the speculative and
    sequential loops (the bias shifts argmax identically in both)."""
    # a bias large enough to flip SOME rows' argmax at SOME step but not all:
    # sweep until lengths differ across rows, then compare paths exactly
    for bias in (0.0, 2.0, 4.0, 8.0, 16.0):
        base = _gen(params, eos_bias=bias, do_sample=False)
        spec = _gen(params, eos_bias=bias, do_sample=False, spec_gamma=4)
        np.testing.assert_array_equal(np.asarray(spec), np.asarray(base))


def test_pool_honors_bias():
    """DECODE_MODE=continuous + EOS_BIAS: slots must actually free early."""
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine

    rng = np.random.default_rng(0)
    docs = [f"doc {i} " + " ".join(f"w{i}t{j}" for j in range(10))
            for i in range(16)]
    emb = rng.standard_normal((16, 64)).astype(np.float32)
    s = Settings(model_preset="tiny", dtype="float32", batch_buckets=[4],
                 max_batch_size=4, encode_len_buckets=[16],
                 prompt_len_buckets=[64], max_new_tokens=12, max_k=2,
                 do_sample=False, prefix_cache=False, packed_prefill=False,
                 decode_mode="continuous", decode_slots=8, decode_chunk=2,
                 eos_bias=1e9)
    eng = RagEngine(s, docs, emb)
    pool = eng.decode_pool
    pool.start()
    got = {}
    queries = [f"q{i}" for i in range(4)]
    prompts = eng.prepare(queries, [2] * 4)
    pool.submit([f"r{i}" for i in range(4)], prompts,
                lambda rid, res: got.__setitem__(rid, res))
    assert pool.wait_idle(300.0)
    pool.stop()
    assert len(got) == 4
    # with the huge bias the first pool-step token is EOS → empty answers
    # delivered after ~1 generated token each (not max_new_tokens)
