"""chip_smoke.py's phases at toy size on the CPU: the same checks the card
runs at full width (kernels through the CPU's plain paths), and its refusal
to run without a GPU."""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402


@pytest.fixture(scope="module")
def squad():
    return chip_smoke._load_squad()


def test_topk_phase_small(squad):
    _, _, emb = squad
    chip_smoke.check_topk(emb, big_n=20_000)


def test_attention_phase_small():
    chip_smoke.check_attention(packed_t=2048, ps=(128,), b=4, p_row=256)


def test_logits_phase_tiny_model(squad):
    from rag_serving_system.models import QWEN2_TINY

    docs, questions, _ = squad
    chip_smoke.check_logits(docs, questions, cfg=QWEN2_TINY, b=4, p=128)


def test_four_card_phase_on_virtual_devices(squad):
    docs, questions, _ = squad
    emb64 = np.random.default_rng(0).standard_normal(
        (len(docs), 64)).astype(np.float32)
    chip_smoke.phase_four_cards(docs, questions, emb64, model_preset="tiny")


def test_chip_smoke_refuses_cpu(tmp_path):
    """No GPU → non-zero exit and no result line, both from the checkout
    and from a directory that holds chip_smoke.py alone."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    alone = tmp_path / "alone"
    alone.mkdir()
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    for cwd, why in ((REPO, "no GPU"), (str(alone), "rag_serving_system")):
        r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode != 0, r.stdout
        assert '"ok"' not in r.stdout
        assert why in r.stderr, r.stderr
