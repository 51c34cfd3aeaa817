"""A backlog of long documents pushed into a ``DocumentStore``.

A ``pw.io.python`` subject commits ``commit_docs`` documents at a time
and keeps ``ahead_commits`` commits staged beyond what the splitter has
taken in, so the pipeline never waits for input and the backlog stays
bounded.  The window opens once ``warmup_chunks`` chunks are indexed and
counts the chunks the index takes during it.  Then the subject stops,
the pipeline drains, and every chunk of every committed document is
checked.
"""

from __future__ import annotations

import threading
import time

from portbench import corpus
from portbench.checks import ingest as ingest_check
from portbench.systems import docstore

WAIT_S = 120.0


def run(cell) -> dict:
    import pathway_tpu_torch as pw

    p, cfg = cell.traffic, cell.config
    t_setup = time.perf_counter()
    stream = corpus.DocumentStream(p, cell.seed)
    state = {"committed_docs": 0, "commits": [], "stop": False}
    split = threading.Condition()
    probe = cell.probe

    class Docs(pw.Schema):
        data: bytes

    class Backlog(pw.io.python.ConnectorSubject):
        def run(self):
            c = 0
            while True:
                with split:
                    while not state["stop"] and state["committed_docs"] - probe.count("split") >= \
                            p["ahead_commits"] * p["commit_docs"]:
                        split.wait()
                    if state["stop"]:
                        return
                docs = stream.commit(c)
                for text in docs:
                    self.next(data=text.encode())
                self.commit()
                with split:
                    state["committed_docs"] += len(docs)
                    state["commits"].append(c)
                c += 1

    class NoQueries(pw.io.python.ConnectorSubject):
        def run(self):
            with split:
                while not state["stop"]:
                    split.wait()

    table = pw.io.python.read(Backlog(), schema=Docs, autocommit_duration_ms=None)
    sys_ = docstore.build(cfg, table, cell.seed, cell.device, probe)
    docstore.instrument(sys_, probe, cell.trace)

    def on_split():
        with split:
            split.notify_all()

    probe.watch("split", on_split)
    store = sys_["store"]
    # the index exists only under a query stream: an empty one
    queries = pw.io.python.read(NoQueries(), schema=type(store).RetrieveQuerySchema)
    pw.io.subscribe(store.retrieve_query(queries), on_change=lambda *a, **k: None)

    errors: list = []

    def runner():
        try:
            pw.run()
        except BaseException as exc:  # noqa: BLE001 - reported by the harness
            errors.append(repr(exc))

    thread = threading.Thread(target=runner, name="portbench:run", daemon=True)
    thread.start()
    deadline = time.perf_counter() + WAIT_S * 3
    while probe.count("index_add") < p["warmup_chunks"]:
        if errors or time.perf_counter() > deadline:
            raise RuntimeError(f"warm-up did not index {p['warmup_chunks']} chunks: {errors}")
        time.sleep(0.01)
    setup_s = time.perf_counter() - t_setup
    window = cell.measure()
    with split:
        state["stop"] = True
        split.notify_all()
    thread.join(WAIT_S)
    if thread.is_alive() or errors:
        raise RuntimeError(f"the pipeline did not drain: alive {thread.is_alive()}, {errors}")
    added = probe.of("index_add", window)
    obs = {
        "setup_s": setup_s,
        "window": window,
        "window_s": window[1] - window[0],
        "chunks_indexed": len(added),
        "diagnostics": {"encode_calls": len(probe.of("encode", window)), "docs_split": len(probe.of("split", window))},
    }
    check = ingest_check.Check(cell, sys_, stream, state["commits"], window)
    return {"obs": obs, "check": check, "system": sys_}


def release(out: dict) -> None:
    """Drop the dataflow graph; the encoder's weights are small and the
    reference reads its own tree."""
    import pathway_tpu_torch as pw

    pw.G.clear()
