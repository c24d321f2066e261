"""Production-mode integration: real HF tokenizer artifacts + real HF
checkpoints through the FULL engine.

Round-1 gap: `HFTokenizer` and the safetensors loaders existed but had never
been exercised as a unit — this is the only seam between offline mode
(HashTokenizer + random init) and production mode (reference: main.py:26-32
loads HF tokenizers/models). Here we build tiny-but-real artifacts offline
(`save_pretrained` at exactly the *_TINY preset sizes) and run the engine
end-to-end: tokenizer pad ids, left-pad + left-truncate, weight layout, and
decode round-trip.
"""

import os

os.environ.setdefault("TRANSFORMERS_OFFLINE", "1")
os.environ.setdefault("HF_HUB_OFFLINE", "1")

import numpy as np
import pytest

import jax.numpy as jnp

torch = pytest.importorskip("torch")
transformers = pytest.importorskip("transformers")

from rag_serving_system.config import Settings
from rag_serving_system.core.engine import RagEngine
from rag_serving_system.models.configs import E5_TINY, QWEN2_TINY
from rag_serving_system.models.e5 import encode
from rag_serving_system.models.tokenizer import HFTokenizer, get_tokenizer


DOCS = [f"the answer to question {i} is {i * i} indeed" for i in range(24)]


def _train_tokenizer(specials):
    from tokenizers import Tokenizer, models, pre_tokenizers, trainers

    tok = Tokenizer(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    trainer = trainers.BpeTrainer(vocab_size=400, special_tokens=specials)
    corpus = DOCS + [f"what is the answer to question {i}?" for i in range(24)]
    tok.train_from_iterator(corpus, trainer)
    return tok


def _save_fast(tok, d, pad, eos):
    from transformers import PreTrainedTokenizerFast

    fast = PreTrainedTokenizerFast(tokenizer_object=tok, unk_token="<unk>",
                                   pad_token=pad, eos_token=eos)
    fast.save_pretrained(d)


@pytest.fixture(scope="module")
def snapshots(tmp_path_factory):
    """weights_dir layout the engine's find_snapshot resolves:
    <weights_dir>/<basename(model_name)> per model, each holding BOTH the
    safetensors checkpoint and the tokenizer files (like an HF snapshot)."""
    from transformers import (Qwen2Config, Qwen2ForCausalLM, XLMRobertaConfig,
                              XLMRobertaModel)

    root = tmp_path_factory.mktemp("snapshots")
    enc_dir, dec_dir = str(root / "enc"), str(root / "dec")

    # --- encoder at exactly E5_TINY size; pad_token_id must be 1 ---
    torch.manual_seed(0)
    XLMRobertaModel(XLMRobertaConfig(
        vocab_size=E5_TINY.vocab_size, hidden_size=E5_TINY.hidden_size,
        num_hidden_layers=E5_TINY.num_layers,
        num_attention_heads=E5_TINY.num_heads,
        intermediate_size=E5_TINY.intermediate_size,
        max_position_embeddings=E5_TINY.max_position_embeddings,
        type_vocab_size=1, pad_token_id=1, hidden_act="gelu",
    )).eval().save_pretrained(enc_dir)
    # specials ordered so <unk>=0, <pad>=1 (matches E5_TINY.pad_token_id)
    _save_fast(_train_tokenizer(["<unk>", "<pad>", "<eos>"]), enc_dir,
               pad="<pad>", eos="<eos>")

    # --- decoder at exactly QWEN2_TINY size; pad=0, eos=1 ---
    torch.manual_seed(1)
    Qwen2ForCausalLM(Qwen2Config(
        vocab_size=QWEN2_TINY.vocab_size, hidden_size=QWEN2_TINY.hidden_size,
        num_hidden_layers=QWEN2_TINY.num_layers,
        num_attention_heads=QWEN2_TINY.num_heads,
        num_key_value_heads=QWEN2_TINY.num_kv_heads,
        intermediate_size=QWEN2_TINY.intermediate_size,
        max_position_embeddings=QWEN2_TINY.max_position_embeddings,
        rope_theta=QWEN2_TINY.rope_theta, rms_norm_eps=QWEN2_TINY.rms_norm_eps,
        tie_word_embeddings=True, pad_token_id=0, eos_token_id=1, bos_token_id=2,
    )).eval().save_pretrained(dec_dir)
    # specials ordered so <pad>=0, <eos>=1 (matches QWEN2_TINY)
    _save_fast(_train_tokenizer(["<pad>", "<eos>", "<unk>"]), dec_dir,
               pad="<pad>", eos="<eos>")
    return str(root), enc_dir, dec_dir


@pytest.fixture(scope="module")
def hf_engine(snapshots):
    root, enc_dir, dec_dir = snapshots
    settings = Settings(
        model_preset="tiny", dtype="float32", weights_dir=root,
        embed_model_name=enc_dir, llm_model_name=dec_dir,
        batch_buckets=[1, 4], max_batch_size=4,
        encode_len_buckets=[16, 32], prompt_len_buckets=[64, 128],
        max_new_tokens=4, max_k=4)
    # corpus embeddings produced by the engine's own encoder + HF tokenizer,
    # mirroring scripts/fact_dataset.py ("passage: " prefix, mean pool, L2)
    tok = get_tokenizer(enc_dir, E5_TINY.vocab_size)
    assert isinstance(tok, HFTokenizer), "HF tokenizer must load from snapshot"
    from rag_serving_system.models.weights import get_encoder_params

    params, real = get_encoder_params(E5_TINY, root, enc_dir, jnp.float32)
    assert real, "encoder snapshot must be found"
    ids, mask = tok.encode_batch(["passage: " + d for d in DOCS], 32)
    emb = np.array(encode(params, E5_TINY, jnp.asarray(ids),
                          jnp.asarray(mask), dtype=jnp.float32))
    emb /= np.linalg.norm(emb, axis=-1, keepdims=True)
    return RagEngine(settings, DOCS, emb)


def test_engine_uses_hf_tokenizers(hf_engine):
    assert isinstance(hf_engine.enc_tok, HFTokenizer)
    assert isinstance(hf_engine.dec_tok, HFTokenizer)
    assert hf_engine.enc_tok.pad_id == E5_TINY.pad_token_id == 1
    assert hf_engine.dec_tok.pad_id == QWEN2_TINY.pad_token_id == 0
    assert hf_engine.dec_tok.eos_id == QWEN2_TINY.eos_token_id == 1


def test_engine_end_to_end_with_real_artifacts(hf_engine):
    results = hf_engine.process(
        ["what is the answer to question 7?", "question 3?"], [2, 2])
    assert len(results) == 2
    for r in results:
        assert isinstance(r["result"], str)
        # decoded through the REAL tokenizer: no hash placeholders
        assert "<" not in r["result"] or "unk" in r["result"]


def test_engine_retrieval_is_semantic_with_real_encoder(hf_engine):
    """A query repeating doc i's exact tokens must rank doc i first — the
    token-overlap signal survives even random-init weights, and with the HF
    tokenizer both sides share one vocabulary."""
    idx = hf_engine.embed_and_retrieve(
        [f"the answer to question {i} is {i * i} indeed" for i in (5, 11)],
        [1, 1])
    assert idx[0][0] == 5
    assert idx[1][0] == 11


def test_hf_tokenizer_left_pad_and_truncate(snapshots):
    _, _, dec_dir = snapshots
    tok = HFTokenizer(dec_dir)
    long = "the answer to question 1 is 1 " * 20 + "indeed"
    ids, mask = tok.encode_batch([long, "what is 2?"], 16, pad_side="left",
                                 truncate_side="left")
    assert ids.shape == (2, 16)
    # row 0 over-long: tail kept (left truncation) — the trailing marker
    # survives; a right-truncation would end mid-filler
    assert mask[0].all()
    assert tok.decode(ids[0]).endswith("indeed")
    # row 1 short: left-padded with the real pad id
    assert ids[1, 0] == tok.pad_id and mask[1, 0] == 0
    assert mask[1, -1] == 1


def test_hf_encode_many_matches_per_row_encode(snapshots):
    """encode_many (Rust batch path, GIL-released) must be id-exact with the
    per-row encode it replaces on the engine's hot loops —
    including specials handling and empty strings (batch pad rows)."""
    _, enc_dir, dec_dir = snapshots
    for d in (enc_dir, dec_dir):
        tok = HFTokenizer(d)
        texts = ["the answer to question 3 is 9 indeed",
                 "what is the answer to question 7?",
                 "",  # pad row
                 "the answer " * 30]
        assert tok.encode_many(texts) == [tok.encode(t) for t in texts]
        assert tok.encode_many([]) == []


def test_bringup_runbook_offline(snapshots, tmp_path):
    """scripts/bringup_real_weights.py — the full-size field procedure for
    taking downloaded HF snapshots to a verified serving engine — must run
    end-to-end against the tiny in-test checkpoints: weight loading, the
    reference-recipe embedding-parity check (torch-built 'reference'
    embeddings), recall, and a live generate batch."""
    import json
    import subprocess
    import sys

    root, enc_dir, dec_dir = snapshots

    # 'reference' embeddings: torch forward with the reference's exact recipe
    # (passage: prefix, per-batch padding, UNMASKED mean, L2 norm)
    from transformers import AutoModel, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(enc_dir)
    model = AutoModel.from_pretrained(enc_dir).eval()
    enc = tok(["passage: " + d for d in DOCS], padding=True, truncation=True,
              max_length=512, return_tensors="pt")
    with torch.no_grad():
        emb = model(**enc).last_hidden_state.mean(dim=1)
    emb = torch.nn.functional.normalize(emb, p=2, dim=1).numpy()

    ctx = tmp_path / "ctx.json"
    ctx.write_text(json.dumps(DOCS))
    npy = tmp_path / "emb.npy"
    np.save(npy, emb)
    qs = tmp_path / "q.json"
    qs.write_text(json.dumps(
        [f"what is the answer to question {i}?" for i in range(len(DOCS))]))

    env = dict(os.environ, JAX_PLATFORMS="cpu", COMPUTE_DTYPE="float32",
               EMBED_MODEL_NAME=enc_dir, LLM_MODEL_NAME=dec_dir,
               TRANSFORMERS_OFFLINE="1", HF_HUB_OFFLINE="1")
    out = subprocess.run(
        [sys.executable, "scripts/bringup_real_weights.py",
         "--weights-dir", root, "--contexts", str(ctx),
         "--embeddings", str(npy), "--queries", str(qs),
         "--n-docs", "24", "--k", "4",
         # tiny random-ish encoder: own-context recall is weak (measured
         # ~0.17 vs the real e5's ~1.0); the offline test checks the
         # MACHINERY, the default 0.9 threshold bites at full size
         "--recall-min", "0.1"],
        capture_output=True, text=True, timeout=900,
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env)
    assert out.returncode == 0, out.stdout + out.stderr
    report = json.loads(out.stdout.strip().splitlines()[-1])
    assert report["pass"] is True
    assert report["embedding_parity"] is True  # cos > 0.999 vs torch
    assert report["generate_ok"] is True
