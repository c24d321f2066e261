"""Pin retrieval parity on the repo's REAL SQuAD e5 embeddings.

Loads data/squad_real_embeddings.npy — real multilingual-e5-large passage
embeddings, imported from the reference's published data artifacts — and
asserts that the jnp oracle, the serving top-k and the 8-device sharded
path return top-k index lists IDENTICAL to an independent numpy
implementation of the reference CuPy retriever's math (reference
retriever.py:594-611, 750-769). Exact search on identical embeddings ⇒
identical recall, the BASELINE.md north star.
"""

import os

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "data")


def test_topk_index_sets_identical_on_real_squad_embeddings():
    from scripts.reference_parity import run_parity

    report = run_parity(DATA, n_queries=64, k=5)
    assert report["all_identical"], report
    # exact search: self-retrieval recall@1 must be perfect on both sides
    case = report["cases"]["self_retrieval"]
    assert case["recall@1"] == 1.0 and case["ours_recall@1"] == 1.0
    # and recall numbers agree at every noise level
    for name, case in report["cases"].items():
        if "recall@1" in case:
            assert case["recall@1"] == case["ours_recall@1"], name
            assert case["recall@5"] == case["ours_recall@5"], name
