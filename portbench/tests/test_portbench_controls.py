"""The lower-precision control comes out not correct: the program's W8A8
encoder and its int8 decoder put in place of the bf16 ones, and a float8
top-k in the index's place.  On the card at each cell's own size against
its committed limits (``python -m pytest portbench/tests -m card`` on the
chip); on the CPU the encoder's and the top-k's at the tiny size against
the tiny limits (the tiny float32 decoder's 24 served tokens part from no
reference argmax under int8, so its control is held on the card only)."""

import pytest

from portbench import harness
from portbench.tests import tiny


@pytest.mark.parametrize("name,number", [("tiny_ingest", "embedding_l2_msq"),
                                         ("tiny_answers", "retrieval_scores_off")])
def test_control_fails_at_tiny_size(tiny_root, name, number, monkeypatch):
    root, bench = tiny_root
    monkeypatch.delenv("PATHWAY_ENCODER_QUANTIZE", raising=False)
    from pathway_tpu_torch.models.encoder import shared_sentence_encoder

    shared_sentence_encoder.cache_clear()
    try:
        res = harness.run_cell(bench, tiny.workload(bench, name), 31, 1.5, False, device="cpu",
                               reference_device="cpu", control=True, root=root)
    finally:
        import os

        os.environ.pop("PATHWAY_ENCODER_QUANTIZE", None)
        shared_sentence_encoder.cache_clear()
    failed = {c["name"] for c in res["checks"] if c["value"] > c["limit"]}
    assert not res["correct"] and number in failed, res["checks"]


@pytest.mark.card
@pytest.mark.parametrize("name", ["bge_ingest_backlog", "rag_mistral7b_answer"])
def test_control_fails_at_cell_size(card, name):
    root = harness.HERE.parent
    bench = harness.load_json(root / "BENCHMARK.json")
    workload = next(w for w in bench["workloads"] if w["name"] == name)
    for seed in (2**31 + 101, 2**31 + 102, 2**31 + 103):
        res = harness.run_cell(bench, workload, seed, 10.0, False, control=True)
        assert not res["correct"], (seed, res["checks"])
