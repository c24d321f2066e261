"""Tokenization with an offline fallback.

The reference relies on HF `AutoTokenizer` (reference: main.py:26-31; the
Qwen tokenizer is created with `padding_side='left'`). We use HF tokenizers
when a local snapshot exists, and otherwise a deterministic hashing
whitespace tokenizer so the full pipeline (tests, benchmarks, random-weight
serving) runs with zero network access. Both expose the same interface:

    encode_batch(texts, max_len, pad_side) -> (ids (B, L) i32, mask (B, L) i32)
    decode(ids) -> str
"""

from __future__ import annotations

import hashlib
import re
from typing import List, Tuple

import numpy as np


class HashTokenizer:
    """Deterministic whitespace+punctuation hashing tokenizer.

    Not linguistically meaningful, but: stable across runs/processes, injective
    enough for retrieval/pipeline testing, and produces realistic token counts
    (≈1 token per word) so performance numbers are honest.
    """

    def __init__(self, vocab_size: int, bos_id: int = 0, eos_id: int = 2,
                 pad_id: int = 1):
        # reserve low ids for specials
        self.vocab_size = vocab_size
        self.bos_id = bos_id
        self.eos_id = eos_id
        self.pad_id = pad_id
        self._reserved = 10
        self._word_re = re.compile(r"\w+|[^\w\s]")
        # native (C) fast path for ASCII strings — exact blake2b parity,
        # ~10x faster tokenize+hash, GIL released during the call
        from rag_serving_system.native import get_hashtok_lib
        self._lib = get_hashtok_lib()

    def _tok2id(self, tok: str) -> int:
        h = int.from_bytes(hashlib.blake2b(tok.encode("utf-8"), digest_size=4).digest(), "little")
        return self._reserved + (h % (self.vocab_size - self._reserved))

    def _encode_py(self, text: str) -> List[int]:
        return [self.bos_id] + [self._tok2id(t) for t in self._word_re.findall(text)] + [self.eos_id]

    def encode(self, text: str) -> List[int]:
        if self._lib is not None:
            try:
                raw = text.encode("ascii")
            except UnicodeEncodeError:
                return self._encode_py(text)  # non-ASCII: exact Python path
            import ctypes

            cap = len(raw) + 2  # bos + at most one token per byte... tokens <= bytes
            out = (ctypes.c_int32 * cap)()
            n = self._lib.hashtok_encode(
                raw, len(raw), out, cap, self.vocab_size, self._reserved,
                self.bos_id, self.eos_id)
            if n >= 0:
                return list(out[:n])
        return self._encode_py(text)

    def decode(self, ids) -> str:
        # lossy: hashing is one-way; emit token placeholders
        return " ".join(f"<{int(i)}>" for i in ids if int(i) not in
                        (self.bos_id, self.eos_id, self.pad_id))

    def encode_many(self, texts: List[str]) -> List[List[int]]:
        """Batch encode (same contract as HFTokenizer.encode_many). The C
        fast path is per-string but GIL-releasing and ~5x Python, so a plain
        loop is already the fast shape here."""
        return [self.encode(t) for t in texts]

    def encode_batch(self, texts: List[str], max_len: int,
                     pad_side: str = "right",
                     truncate_side: str = "right") -> Tuple[np.ndarray, np.ndarray]:
        rows = [self.encode(t) for t in texts]
        return pad_and_stack(rows, max_len, self.pad_id, pad_side, truncate_side)


class HFTokenizer:
    """Thin adapter over a locally cached HF tokenizer."""

    def __init__(self, model_name: str, pad_id_fallback: int = 0):
        from transformers import AutoTokenizer  # local snapshot only
        self.tok = AutoTokenizer.from_pretrained(model_name, local_files_only=True)
        if self.tok.pad_token_id is None:
            self.tok.pad_token = self.tok.eos_token
        self.pad_id = self.tok.pad_token_id
        self.eos_id = self.tok.eos_token_id

    def encode(self, text: str) -> List[int]:
        return self.tok.encode(text)

    def encode_many(self, texts: List[str]) -> List[List[int]]:
        """True batch encode through the Rust `tokenizers` batch API: one
        call tokenizes the whole batch, releasing the
        GIL and parallelizing across the rayon pool — a ~400-token prompt
        costs real BPE work per row, and a Python-side per-row loop puts all
        of it on the dispatch thread under the GIL. Exact parity with
        per-row `encode` (same add_special_tokens pipeline; pinned by
        tests/test_hf_integration.py)."""
        if not texts:
            return []
        fast = getattr(self.tok, "_tokenizer", None)  # rust backend
        if fast is not None:
            return [e.ids for e in fast.encode_batch(list(texts))]
        return [self.tok.encode(t) for t in texts]

    def decode(self, ids) -> str:
        return self.tok.decode([int(i) for i in ids], skip_special_tokens=True)

    def encode_batch(self, texts: List[str], max_len: int,
                     pad_side: str = "right",
                     truncate_side: str = "right") -> Tuple[np.ndarray, np.ndarray]:
        rows = self.encode_many(texts)
        return pad_and_stack(rows, max_len, self.pad_id, pad_side, truncate_side)


def pad_and_stack(rows: List[List[int]], max_len: int, pad_id: int,
                  pad_side: str, truncate_side: str = "right"
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Pad a ragged batch to (B, max_len) + mask. Right-pad for the encoder,
    left-pad for the decoder (reference: main.py:31 padding_side='left').

    truncate_side="left" keeps the TAIL of over-long rows — required for RAG
    prompts, where the question and answer cue sit at the end."""
    b = len(rows)
    ids = np.full((b, max_len), pad_id, dtype=np.int32)
    mask = np.zeros((b, max_len), dtype=np.int32)
    for i, row in enumerate(rows):
        row = row[:max_len] if truncate_side == "right" else row[-max_len:]
        n = len(row)
        if pad_side == "right":
            ids[i, :n] = row
            mask[i, :n] = 1
        else:
            ids[i, max_len - n:] = row
            mask[i, max_len - n:] = 1
    return ids, mask


def get_tokenizer(model_name: str, vocab_size: int):
    """HF tokenizer if locally available; otherwise the hash fallback."""
    try:
        return HFTokenizer(model_name)
    except Exception:
        return HashTokenizer(vocab_size=vocab_size)
