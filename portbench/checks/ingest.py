"""``correct`` for a document backlog: the splitter's chunks of every
committed document, the token ids, the index's vectors against the
encoder's, and the embeddings of a sample of the chunks the index took in
the window against the reference encoder."""

from __future__ import annotations

import collections

import numpy as np

from portbench import corpus
from portbench.checks import common
from portbench.reference import text


class Check:
    def __init__(self, cell, sys_, stream, commits, window):
        self.cell, self.stream, self.commits, self.window = cell, stream, list(commits), window
        self.tree = sys_["tree"]

    def run(self) -> dict:
        cell, cfg, probe = self.cell, self.cell.config, self.cell.probe
        ref_chunks = collections.Counter(
            c for commit in self.commits for d in self.stream.commit(commit)
            for c in text.split_chunks(d, cfg["splitter_min_tokens"], cfg["splitter_max_tokens"]))
        embedded = collections.Counter(t for _t, texts, _v in probe.of("encode") for t in texts)
        chunk_diff = sum(((ref_chunks - embedded) + (embedded - ref_chunks)).values())
        adds = probe.of("index_add")
        in_window = probe.of("index_add", self.window)
        by_vector = common.encoded_texts(probe)
        found = [by_vector.get(np.asarray(v, np.float32).tobytes()) for _t, _i, _k, v in in_window]
        longest = max(range(len(found)), key=lambda i: len(found[i] or ""), default=0)
        picked = corpus.sample_indices(len(in_window), cell.traffic["check_chunks"], cell.seed, 1, must=[longest])
        unmatched = sum(found[i] is None for i in picked)
        pairs = [(found[i], in_window[i][3]) for i in picked if found[i] is not None]
        ids = common.reference_ids([t for t, _v in pairs], cfg)
        ref = common.reference_embeddings(self.tree, ids, cfg, cell.reference_device)
        got = np.stack([np.asarray(v, np.float32) for _t, v in pairs]) if pairs else np.zeros((0, 1))
        numbers = {
            "chunks_not_as_split": chunk_diff,
            "chunks_not_indexed": abs(len(adds) - sum(ref_chunks.values())),
            "index_vectors_not_encoded": unmatched,
            "token_id_mismatches": common.id_mismatches([t for t, _v in pairs], ids, probe),
            **common.gap_stats("embedding_l2", common.l2_gaps(got, ref)),
        }
        return {"numbers": numbers, "attempted": sum(ref_chunks.values()),
                "failed": max(0, sum(ref_chunks.values()) - len(adds))}
