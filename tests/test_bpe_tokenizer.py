"""The committed byte-level BPE tokenizer (data/bpe_tokenizer) loads through
the REAL serving path — get_tokenizer -> HFTokenizer(AutoTokenizer) -> Rust
encode_batch — so host-path measurements exercise genuine BPE cost
(reference loads its tokenizers at main.py:26-31)."""

import json
import os

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOK_DIR = os.path.join(REPO, "data", "bpe_tokenizer")

pytestmark = pytest.mark.skipif(
    not os.path.exists(os.path.join(TOK_DIR, "tokenizer.json")),
    reason="committed BPE tokenizer missing")


@pytest.fixture(scope="module")
def tok():
    from rag_serving_system.models.tokenizer import get_tokenizer
    return get_tokenizer(TOK_DIR, vocab_size=151936)


def test_loads_as_hf_not_fallback(tok):
    # must resolve to the HF path (Rust backend), not the hash fallback
    from rag_serving_system.models.tokenizer import HFTokenizer
    assert isinstance(tok, HFTokenizer)
    assert getattr(tok.tok, "_tokenizer", None) is not None  # rust backend


def test_roundtrip_decode(tok):
    text = "What is the boiling point of water?"
    ids = tok.encode(text)
    assert ids[-1] == tok.eos_id  # template appends eos
    assert tok.decode(ids).strip() == text


def test_encode_many_matches_per_row(tok):
    texts = ["hello world", "the quick brown fox", "a", ""]
    rows = tok.encode_many(texts)
    assert rows == [tok.encode(t) for t in texts]
    assert tok.encode_many([]) == []


def test_encode_batch_left_pad_mask(tok):
    ids, mask = tok.encode_batch(["a b c", "d"], 8, pad_side="left")
    assert ids.shape == mask.shape == (2, 8)
    assert mask[0].sum() > mask[1].sum()
    assert (ids[mask == 0] == tok.pad_id).all()
    # left padding: real tokens at the tail
    assert mask[0, -1] == 1 and mask[0, 0] == 0


def test_token_counts_match_hash_realism(tok):
    """The hash fallback was chosen to emit realistic token counts; the real
    BPE must agree within ~15% or every committed perf number is suspect."""
    from rag_serving_system.models.tokenizer import HashTokenizer
    ctx_path = os.path.join(REPO, "data", "squad_real_contexts.json")
    if not os.path.exists(ctx_path):
        pytest.skip("squad corpus not shipped")
    with open(ctx_path) as f:
        ctx = json.load(f)[:200]
    hash_tok = HashTokenizer(vocab_size=151936)
    bpe = np.array([len(r) for r in tok.encode_many(ctx)])
    hsh = np.array([len(hash_tok.encode(c)) for c in ctx])
    ratio = bpe.sum() / hsh.sum()
    assert 0.85 < ratio < 1.15, f"BPE/hash token ratio {ratio:.2f}"


def test_engine_loads_tokenizer_only_dir():
    """Pointing LLM_MODEL_NAME/EMBED_MODEL_NAME at a local tokenizer-only
    directory loads the real tokenizer even without weight snapshots
    (host-path measurement path, round 4); an oversized vocab falls back."""
    import jax
    import numpy as np
    from rag_serving_system.config import Settings
    from rag_serving_system.core.engine import RagEngine
    from rag_serving_system.models.tokenizer import HashTokenizer, HFTokenizer

    docs = [f"document number {i} about subject {i}" for i in range(8)]
    emb = np.random.default_rng(0).normal(size=(8, 64)).astype(np.float32)
    s = Settings(model_preset="tiny", llm_model_name=TOK_DIR,
                 embed_model_name=TOK_DIR,
                 batch_buckets=[2], max_batch_size=2,
                 encode_len_buckets=[16], prompt_len_buckets=[64],
                 max_new_tokens=2, max_k=2)
    eng = RagEngine(s, docs, emb)
    # tiny decoder vocab (512) < BPE vocab (27k): the guard must fall back
    assert isinstance(eng.dec_tok, HashTokenizer)
    assert isinstance(eng.enc_tok, HashTokenizer)

    # full-size vocab (151936) fits: the BPE loads through the HF path
    # (full-size param init is too heavy for a unit test; check the
    # tokenizer-resolution seam directly)
    from rag_serving_system.models.tokenizer import get_tokenizer
    tok = RagEngine._fits_vocab(get_tokenizer(TOK_DIR, 151936), 151936)
    assert isinstance(tok, HFTokenizer)
    assert RagEngine._fits_vocab(get_tokenizer(TOK_DIR, 151936), 512) is None
