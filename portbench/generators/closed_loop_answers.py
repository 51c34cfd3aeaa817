"""A closed loop of clients asking the RAG server's ``/v2/answer``.

Set-up fills the store through a ``pw.io.python`` subject, starts the
served run, then starts ``clients`` clients ``start_stagger_s`` apart so
that their requests do not reach the decoder's slots in lock step.  Each
client asks its own seeded questions in turn, the next as soon as it has
its answer, and states in the ``X-Pathway-Deadline-Ms`` header how long
it waits: ``deadline_ms``, and for a request sent inside the window no
later than the window's close.  The window opens once every client has
started and ``warmup_answers`` answers have come back.  No request is
sent after it closes; those sent before it opened are awaited, and those
sent inside it that the server has not answered by the close lapse there
(504) and are neither attempted nor failed.

The window's rate counts, of every answer that reached its client, the
tokens the scheduler generated inside the window (each decode step's
tokens at the time of that step).
"""

from __future__ import annotations

import json
import threading
import time
import urllib.error
import urllib.request

from portbench import corpus
from portbench.checks import answers as answers_check
from portbench.reference import text
from portbench.systems import rag as rag_system

WAIT_S = 300.0


def ask(url: str, question: str, deadline_ms: float, cut: bool) -> dict:
    """POST ``question``, waiting ``deadline_ms`` (stated to the server) and
    half a minute more for the reply.  ``cut``: the deadline is the
    window's close, not the client's own."""
    body = json.dumps({"prompt": question}).encode()
    headers = {"Content-Type": "application/json", "X-Pathway-Deadline-Ms": str(int(deadline_ms))}
    req = urllib.request.Request(url, data=body, method="POST", headers=headers)
    t0 = time.perf_counter()
    sent = {"sent": t0, "deadline_ms": int(deadline_ms), "cut": cut}
    try:
        with urllib.request.urlopen(req, timeout=deadline_ms / 1000.0 + 30.0) as resp:
            status, raw = resp.status, resp.read()
    except urllib.error.HTTPError as exc:
        status, raw = exc.code, exc.read()
    except OSError as exc:
        return {"status": None, "error": repr(exc), **sent, "done": time.perf_counter()}
    try:
        value = json.loads(raw) if raw else None
    except ValueError:
        value = None
    return {"status": status, "body": value, **sent, "done": time.perf_counter()}


def lapsed_at_close(r: dict) -> bool:
    """A request sent inside the window that the server let lapse at the
    window's close, as its deadline asked."""
    return r["cut"] and r["status"] == 504 and r["done"] >= r["sent"] + r["deadline_ms"] / 1000.0 - 0.05


def run(cell) -> dict:
    import pathway_tpu_torch as pw

    p, cfg, store_cfg, probe = cell.traffic, cell.config, cell.store_config, cell.probe
    t_setup = time.perf_counter()
    data = corpus.rag_store(p, cell.seed)
    expected_chunks = sum(len(text.split_chunks(d, store_cfg["splitter_min_tokens"], store_cfg["splitter_max_tokens"]))
                          for d in data["texts"])
    stop = threading.Event()

    class Docs(pw.Schema):
        data: bytes

    class StoreDocs(pw.io.python.ConnectorSubject):
        def run(self):
            for at in range(0, len(data["texts"]), p["commit_docs"]):
                for d in data["texts"][at : at + p["commit_docs"]]:
                    self.next(data=d.encode())
                self.commit()
            stop.wait()

    table = pw.io.python.read(StoreDocs(), schema=Docs, autocommit_duration_ms=None)
    sys_ = rag_system.build(cfg, store_cfg, table, cell.seed, cell.device, probe, cell.port, control=cell.control)
    rag_system.instrument(sys_, probe, cell.trace)
    server = sys_["rag"].server
    errors: list = []

    def runner():
        try:
            sys_["rag"].run_server(threaded=False, with_cache=False)
        except BaseException as exc:  # noqa: BLE001 - reported by the harness
            errors.append(repr(exc))

    thread = threading.Thread(target=runner, name="portbench:run", daemon=True)
    thread.start()
    deadline = time.perf_counter() + WAIT_S
    while not _indexed(probe, expected_chunks):
        if errors or time.perf_counter() > deadline:
            raise RuntimeError(f"the store did not index its {expected_chunks} chunks: {errors}")
        time.sleep(0.02)
    while not server.webserver._ready.is_set():
        if errors or time.perf_counter() > deadline:
            raise RuntimeError(f"the server did not come up: {errors}")
        time.sleep(0.02)

    url = f"http://127.0.0.1:{cell.port}/v2/answer"
    pool = data["questions"]
    n = p["clients"]
    results: list[list] = [[] for _ in range(n)]
    closing = threading.Event()
    close_at: list = []  # the window's close, once it is open
    started = [threading.Event() for _ in range(n)]

    def client(c: int) -> None:
        time.sleep(c * p["start_stagger_s"])
        started[c].set()
        i = 0
        while not closing.is_set():
            q = pool[(c + i * n) % len(pool)]
            deadline_ms, cut = float(p["deadline_ms"]), False
            if close_at:
                left_ms = (close_at[0] - time.perf_counter()) * 1000.0
                if left_ms < deadline_ms:
                    deadline_ms, cut = max(1.0, left_ms), True
            results[c].append((q, ask(url, q, deadline_ms, cut)))
            i += 1

    clients = [threading.Thread(target=client, args=(c,), name=f"portbench:client{c}", daemon=True)
               for c in range(n)]
    for t in clients:
        t.start()
    while not (all(e.is_set() for e in started) and sum(len(r) for r in results) >= p["warmup_answers"]):
        if errors or time.perf_counter() > deadline + WAIT_S:
            raise RuntimeError(f"warm-up answers did not come: {errors}")
        time.sleep(0.01)
    setup_s = time.perf_counter() - t_setup
    close_at.append(time.perf_counter() + cell.seconds)
    window = cell.measure()
    closing.set()
    for t in clients:
        t.join(p["deadline_ms"] / 1000.0 + 60.0)
    drain_s = time.perf_counter() - window[1]
    server.close()
    stop.set()
    thread.join(WAIT_S)
    if any(t.is_alive() for t in clients) or thread.is_alive() or errors:
        raise RuntimeError(f"the served run did not end: {errors}")
    answers = [(q, r) for rs in results for q, r in rs if not lapsed_at_close(r)]
    lapsed = [(q, r) for rs in results for q, r in rs if lapsed_at_close(r)]
    delivered = _delivered_requests(probe, answers)
    ids = {id(req) for req in delivered}
    steps = probe.of("decoded", window)
    tokens = sum(n_ for _t, rows in steps for req, n_ in rows if id(req) in ids)
    diagnostics = {
        "decode_steps": len(steps),
        "rows_per_step": sum(len(rows) for _t, rows in steps) / max(1, len(steps)),
        "answers_done_in_window": sum(1 for _q, r in answers if window[0] <= r["done"] < window[1]),
        "short_answers": sum(1 for req in delivered if len(req.out) < cfg["max_new_tokens"]),
        "lapsed_at_close": len(lapsed),
        "drain_s": drain_s,
        **latency_readings([r for _q, r in answers if r["status"] == 200 and window[0] <= r["done"] < window[1]]),
    }
    obs = {"setup_s": setup_s, "window": window, "window_s": window[1] - window[0], "answer_tokens": tokens,
           "diagnostics": diagnostics}
    check = answers_check.Check(cell, sys_, data, answers, window, lapsed)
    return {"obs": obs, "check": check, "system": sys_}


def latency_readings(done: list) -> dict:
    """The answers' latencies, and the share of them over the program's
    default deadline: those a client that states none would get as 504."""
    from pathway_tpu_torch.internals.config import ENV_REGISTRY

    default_s = float(ENV_REGISTRY["PATHWAY_SERVE_DEADLINE_MS"].default) / 1000.0
    lat = sorted(r["done"] - r["sent"] for r in done)
    if not lat:
        return {}
    return {"latency_p50_s": lat[len(lat) // 2], "latency_max_s": lat[-1],
            "share_over_default_deadline": sum(x > default_s for x in lat) / len(lat)}


def _indexed(probe, expected: int) -> bool:
    counts: dict = {}
    for _t, index, _key, _v in probe.of("index_add"):
        counts[index] = counts.get(index, 0) + 1
    return bool(counts) and min(counts.values()) >= expected


def _delivered_requests(probe, answers) -> list:
    """The scheduler's requests whose answers reached their client."""
    ok = {q for q, r in answers if r["status"] == 200}
    return [req for _t, prompt, req in probe.of("submit")
            if prompt is not None and answers_check.question_of(prompt) in ok]


def release(out: dict) -> None:
    import pathway_tpu_torch as pw

    rag_system.release(out["system"])
    pw.G.clear()
