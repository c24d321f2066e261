"""Train a genuine byte-level BPE tokenizer on the shipped corpus.

Why this exists: host-path numbers measured under the HashTokenizer
fallback understate tokenization cost, whose per-prompt cost (blake2b
over whitespace splits) is far below real BPE merges. The actual serving
models' tokenizers (reference: main.py:26-31, AutoTokenizer for
multilingual-e5 + Qwen2.5) cannot be downloaded in this environment — so we
train a REAL byte-level BPE (the same algorithm family as Qwen2's GPT-2
style tokenizer, via the same Rust `tokenizers` crate HF AutoTokenizer
wraps) on the shipped SQuAD + short_facts text, and save it in HF format.

Serving then loads it through the exact code path real weights would use:

    LLM_MODEL_NAME=data/bpe_tokenizer  ->  HFTokenizer(AutoTokenizer)
    -> encode_many -> Rust encode_batch (GIL-released, rayon-parallel)

so host-path measurements (scripts/profile_host.py, load sweeps) exercise
real BPE cost per token, real special-token handling, and the real batch
API — everything but the exact merge table of the production checkpoint.

Usage: python scripts/train_bpe_tokenizer.py [--vocab 32768] [--out DIR]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def corpus_lines():
    """All shipped natural-language text: SQuAD contexts + queries and the
    short_facts documents + queries (same text the benches serve)."""
    lines = []
    for name in ("squad_real_contexts.json", "squad_real_queries.json",
                 "documents.json", "queries.json"):
        path = os.path.join(REPO, "data", name)
        if not os.path.exists(path):
            continue
        with open(path) as f:
            payload = json.load(f)
        if isinstance(payload, dict):
            payload = list(payload.values())
        lines.extend(str(x) for x in payload)
    if not lines:
        raise SystemExit("no corpus text found under data/")
    return lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--vocab", type=int, default=32768)
    ap.add_argument("--out", default=os.path.join(REPO, "data", "bpe_tokenizer"))
    args = ap.parse_args()

    from tokenizers import Tokenizer, models, pre_tokenizers, decoders, trainers
    from tokenizers.processors import TemplateProcessing

    # GPT-2/Qwen2-style byte-level BPE: no unk token (byte alphabet covers
    # everything), byte-level pre-tokenizer with the standard space prefix
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    trainer = trainers.BpeTrainer(
        vocab_size=args.vocab,
        special_tokens=["<|endoftext|>", "<|pad|>"],
        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
        show_progress=False,
    )
    lines = corpus_lines()
    tok.train_from_iterator(lines, trainer=trainer)
    eos = tok.token_to_id("<|endoftext|>")
    tok.post_processor = TemplateProcessing(
        single="$A <|endoftext|>", pair="$A $B <|endoftext|>",
        special_tokens=[("<|endoftext|>", eos)])

    os.makedirs(args.out, exist_ok=True)
    tok.save(os.path.join(args.out, "tokenizer.json"))
    with open(os.path.join(args.out, "tokenizer_config.json"), "w") as f:
        json.dump({
            "tokenizer_class": "PreTrainedTokenizerFast",
            "eos_token": "<|endoftext|>",
            "pad_token": "<|pad|>",
            "model_max_length": 131072,
        }, f, indent=1)

    # report compression so the benches' token-count realism is on record
    import numpy as np
    sample = lines[: min(len(lines), 500)]
    enc = tok.encode_batch(sample)
    toks = np.array([len(e.ids) for e in enc])
    words = np.array([len(s.split()) for s in sample])
    print(f"trained byte-level BPE: vocab={tok.get_vocab_size()} "
          f"on {len(lines)} lines -> {args.out}")
    print(f"tokens/word over {len(sample)} sample lines: "
          f"{toks.sum() / max(1, words.sum()):.2f} "
          f"(real Qwen2 English text is ~1.3)")


if __name__ == "__main__":
    main()
