"""Hidden Markov Model decoding as an incremental reducer.

Parity target: ``python/pathway/stdlib/ml/hmm.py`` —
``create_hmm_reducer(graph, beam_size, num_results_kept)`` builds an
accumulator for ``pw.reducers.udf_reducer`` that maintains the Viterbi
decoding of a growing observation sequence; each new observation refines
the most-likely state path, emitting retraction + new path per step.

Design difference: the reference replays a deque of observations through
a forward Viterbi pass.  Here the accumulator is a true semigroup — it
stores, per (entry-state, exit-state) pair, the best log-probability
path *through its span of observations* (min-plus matrix form), so
``update`` composes two spans associatively via the transition edges.
That keeps the reducer correct under any update order and maps the
per-pair maximization onto dense array ops.
"""

from __future__ import annotations

from typing import Any

from pathway_tpu_torch.internals.reducers import BaseCustomAccumulator


def create_hmm_reducer(
    graph: Any, beam_size: int | None = None, num_results_kept: int | None = None
):
    """Reducer decoding an HMM; see reference docstring for the contract.

    ``graph`` is a ``networkx.DiGraph``: nodes carry
    ``calc_emission_log_ppb(observation) -> float``, edges carry
    ``log_transition_ppb``, ``graph.graph["start_nodes"]`` lists initial
    states.
    """
    states = list(graph.nodes)
    start_nodes = list(graph.graph.get("start_nodes", states))
    emission = {s: graph.nodes[s]["calc_emission_log_ppb"] for s in states}
    transition = {
        (u, v): data["log_transition_ppb"] for u, v, data in graph.edges(data=True)
    }

    class HmmAccumulator(BaseCustomAccumulator):
        """best[(entry, exit)] = (log_ppb, path tuple) over the span."""

        __slots__ = ("best",)

        def __init__(self, best: dict):
            self.best = best

        @classmethod
        def from_row(cls, row):
            (observation,) = row
            best = {}
            for s in states:
                lp = emission[s](observation)
                if lp is not None:
                    best[(s, s)] = (float(lp), (s,))
            return cls(best)

        def update(self, other: "HmmAccumulator") -> None:
            combined: dict = {}
            for (i, j), (lp_left, path_left) in self.best.items():
                for (k, l), (lp_right, path_right) in other.best.items():
                    t = transition.get((j, k))
                    if t is None:
                        continue
                    score = lp_left + t + lp_right
                    cur = combined.get((i, l))
                    if cur is None or score > cur[0]:
                        combined[(i, l)] = (score, path_left + path_right)
            self.best = _prune(combined)

        def compute_result(self) -> tuple:
            candidates = [
                entry
                for (i, _j), entry in self.best.items()
                if i in start_nodes
            ]
            if not candidates:
                return ()
            _, path = max(candidates, key=lambda e: e[0])
            if num_results_kept is not None:
                path = path[-num_results_kept:]
            return path

    def _prune(best: dict) -> dict:
        if beam_size is None:
            return best
        # beam over exit states: keep the beam_size best exits (the states
        # a longer decoding could continue from)
        by_exit: dict = {}
        for (i, j), entry in best.items():
            cur = by_exit.get(j)
            if cur is None or entry[0] > cur[0]:
                by_exit[j] = entry
        kept_exits = {
            j
            for j, _ in sorted(
                by_exit.items(), key=lambda e: e[1][0], reverse=True
            )[:beam_size]
        }
        return {k: v for k, v in best.items() if k[1] in kept_exits}

    HmmAccumulator.__name__ = "hmm"
    return HmmAccumulator
