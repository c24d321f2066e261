"""Native (C) tokenizer vs pure-Python parity: blake2b digest, token split,
truncation, and fallback behavior."""

import json
import os

import numpy as np
import pytest

from rag_serving_system.models.tokenizer import HashTokenizer
from rag_serving_system.native import get_hashtok_lib

pytestmark = pytest.mark.skipif(get_hashtok_lib() is None,
                                reason="native lib not built (no cc)")


@pytest.fixture(scope="module")
def tok():
    t = HashTokenizer(vocab_size=50000)
    assert t._lib is not None
    return t


CASES = [
    "Water boils at 100 degrees Celsius at sea level.",
    "query: What is the boiling point of water?",
    "a",
    "",
    "   leading spaces\tand\ttabs\n\nnewlines  ",
    "punct!@#$%^&*()_+-=[]{};':\",./<>?",
    "ascii separators\x1cbetween\x1dwords\x1ehere\x1ftoo",
    "under_scores_and_digits_42 mix3d t0kens",
    "Context:\nFact 1\n---\nFact 2\n\nQuestion: why?\n\nThe Answer to this question is: ",
]


@pytest.mark.parametrize("text", CASES)
def test_c_matches_python(tok, text):
    assert tok.encode(text) == tok._encode_py(text)


def test_non_ascii_falls_back(tok):
    text = "héllo wörld — ünïcode"
    # must not crash and must equal the python path (fallback)
    assert tok.encode(text) == tok._encode_py(text)


def test_corpus_parity(tok):
    data = "data/short_facts_contexts.json"
    if not os.path.exists(data):
        pytest.skip("corpus not built")
    with open(data) as f:
        docs = json.load(f)
    for d in docs:
        assert tok.encode("passage: " + d) == tok._encode_py("passage: " + d)


def test_batch_encode_uses_native(tok):
    texts = ["hello world"] * 4 + ["héllo"]  # mixed ascii / fallback
    ids, mask = tok.encode_batch(texts, max_len=8)
    ids2 = [tok._encode_py(t)[:8] for t in texts]
    for row, expect, m in zip(ids, ids2, mask):
        assert list(row[:len(expect)]) == expect
        assert m[:len(expect)].all()


def test_random_ascii_fuzz(tok, rng):
    import string

    chars = string.printable
    for _ in range(200):
        n = int(rng.integers(0, 80))
        s = "".join(chars[i] for i in rng.integers(0, len(chars), n))
        assert tok.encode(s) == tok._encode_py(s), repr(s)
