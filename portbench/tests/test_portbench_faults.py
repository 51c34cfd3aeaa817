"""The whole run, on the CPU at a tiny size, with the timed path broken
underneath: ``correct`` comes out false for each fault the cells can
have (an answer, a token or a retrieval altered where it is produced),
and true without one."""

import numpy as np
import pytest

from portbench import harness
from portbench.tests import tiny


def run(tiny_root, name, seed=21, seconds=1.5):
    root, bench = tiny_root
    return harness.run_cell(bench, tiny.workload(bench, name), seed, seconds, False, device="cpu",
                            reference_device="cpu", root=root)


@pytest.mark.parametrize("name", ["tiny_ingest", "tiny_answers"])
def test_sound_runs_are_correct(tiny_root, name):
    res = run(tiny_root, name)
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0


def failing(res) -> set:
    return {c["name"] for c in res["checks"] if c["value"] > c["limit"]}


def test_an_embedding_altered_where_produced(tiny_root, monkeypatch):
    from pathway_tpu_torch.models.encoder import SentenceEncoder

    encode = SentenceEncoder.encode

    def altered(self, texts, *a, **k):
        out = np.array(encode(self, texts, *a, **k))
        out[:, :8] += 0.25
        return out

    monkeypatch.setattr(SentenceEncoder, "encode", altered)
    res = run(tiny_root, "tiny_ingest")
    assert not res["correct"] and "embedding_l2_msq" in failing(res)


def test_a_chunk_altered_where_split(tiny_root, monkeypatch):
    from pathway_tpu_torch.xpacks.llm.splitters import TokenCountSplitter

    chunk = TokenCountSplitter.chunk

    def altered(self, text, metadata=None):
        out = chunk(self, text, metadata)
        return [(c.rsplit(" ", 1)[0] if i == 0 and " " in c else c, m) for i, (c, m) in enumerate(out)]

    monkeypatch.setattr(TokenCountSplitter, "chunk", altered)
    res = run(tiny_root, "tiny_ingest")
    assert not res["correct"] and "chunks_not_as_split" in failing(res)


def test_a_token_altered_where_generated(tiny_root, monkeypatch):
    from pathway_tpu_torch.serving.generation import GenerationScheduler

    decode = GenerationScheduler._run_decode

    def altered(self, rows):
        reqs = [self._slots[i].req for i in rows if self._slots[i] is not None]
        out = decode(self, rows)
        for req in reqs:
            if req.out:
                req.out[-1] = (req.out[-1] + 1) % self.cfg.vocab_size
        return out

    monkeypatch.setattr(GenerationScheduler, "_run_decode", altered)
    res = run(tiny_root, "tiny_answers")
    assert not res["correct"] and "served_logit_gap_mean" in failing(res)


def test_retrievals_out_of_order(tiny_root, monkeypatch):
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnIndex

    search = BruteForceKnnIndex.search_many
    monkeypatch.setattr(BruteForceKnnIndex, "search_many", lambda self, reqs: [r[::-1] for r in search(self, reqs)])
    res = run(tiny_root, "tiny_answers")
    assert not res["correct"] and "retrievals_not_sorted" in failing(res)


def half_store(search):
    """A top-k over every other vector the index holds: right in form and
    order, wrong in what it finds."""
    def call(self, reqs):
        held = self._vectors
        self._vectors = dict(list(held.items())[::2])
        self._dirty, self._version = True, self._version + 1
        try:
            return search(self, reqs)
        finally:
            self._vectors = held
            self._dirty, self._version = True, self._version + 1
    return call


def worst_k(search):
    """The k chunks farthest from the query, given best first."""
    def call(self, reqs):
        full = search(self, [(q, len(self._vectors), f) for q, _k, f in reqs])
        return [res[::-1][: (3 if k is None else k)][::-1] for res, (_q, k, _f) in zip(full, reqs)]
    return call


def scores_shifted(search):
    """Each chunk given with the score of the one ranked after it."""
    def call(self, reqs):
        return [[(key, s) for (key, _s), (_k, s) in zip(res[:-1], res[1:])] + res[-1:] for res in search(self, reqs)]
    return call


@pytest.mark.parametrize("fault,fails", [(half_store, "retrievals_off_topk"), (worst_k, "retrievals_off_topk"),
                                         (scores_shifted, "retrieval_scores_off")])
def test_a_retrieval_wrong_but_sorted(tiny_root, monkeypatch, fault, fails):
    from pathway_tpu_torch.stdlib.indexing.nearest_neighbors import BruteForceKnnIndex

    monkeypatch.setattr(BruteForceKnnIndex, "search_many", fault(BruteForceKnnIndex.search_many))
    res = run(tiny_root, "tiny_answers")
    assert not res["correct"] and fails in failing(res), res["checks"]
