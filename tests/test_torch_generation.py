"""The port's continuous-batching scheduler.

Mirrors ``tests/test_generation_scheduler.py`` where it needs no metrics
registry or fault hooks.  White-box tests drive ``_tick()`` by hand (no
worker thread); end-to-end tests go through ``submit_ids`` and the worker
thread.  Greedy continuous batching must emit exactly the tokens of the
static ``generate_ids`` — the port's and the JAX package's, with the JAX
weights carried across — under slot churn.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

from pathway_tpu.models import decoder as jdec  # noqa: E402
from pathway_tpu_torch.engine import serving as edge  # noqa: E402
from pathway_tpu_torch.models import decoder as tdec  # noqa: E402
from pathway_tpu_torch.serving import generation  # noqa: E402

MODEL = "pw-tiny-decoder"
MAX_CACHE = 64


@pytest.fixture(scope="module")
def lms():
    """The JAX package's shared tiny decoder and the port's, with the JAX
    weights."""
    jlm = jdec.shared_decoder(MODEL, max_cache=MAX_CACHE)
    tlm = tdec.DecoderLM(MODEL, max_cache=MAX_CACHE, device="cpu")
    tlm.params = tdec.from_jax_decoder_params(jax.device_get(jlm.params), tlm.config, "cpu")
    return jlm, tlm


@pytest.fixture
def lm(lms):
    return lms[1]


def _prompt(rng, n):
    return [int(t) for t in rng.integers(1, 500, n)]


def _drive(sched, max_ticks=500):
    """Run manual ticks until idle (white-box: the thread never starts)."""
    for _ in range(max_ticks):
        with sched._lock:
            idle = not sched._queue and all(s is None for s in sched._slots)
        if idle:
            return
        sched._tick()
    raise AssertionError("scheduler did not drain")


def _enqueue(sched, req):
    with sched._lock:
        sched._queue.append(req)


# ---------------------------------------------------------------------------
# End-to-end through the worker thread
# ---------------------------------------------------------------------------


def test_greedy_matches_static_batching_and_jax(lms):
    """THE determinism pin: slots=2 and 5 requests of mixed length force
    queueing and slot reuse; every request gets exactly the static greedy
    tokens of the port and of the JAX package."""
    jlm, tlm = lms
    rng = np.random.default_rng(7)
    prompts = [_prompt(rng, n) for n in (3, 11, 1, 7, 20)]
    news = [6, 4, 8, 5, 3]
    ref = [tlm.generate_ids([p], max_new_tokens=mn)[0] for p, mn in zip(prompts, news)]
    assert ref == [jlm.generate_ids([p], max_new_tokens=mn)[0] for p, mn in zip(prompts, news)]
    sched = generation.GenerationScheduler(tlm, slots=2, page_size=16, prefill_chunk=8, queue_limit=16)
    try:
        futs = [sched.submit_ids(p, max_new_tokens=mn) for p, mn in zip(prompts, news)]
        got = [f.result(timeout=120) for f in futs]
        assert got == ref
        snap = sched.snapshot()
        assert snap["active"] == 0 and snap["queued"] == 0
        # every page went back and every reservation unwound
        assert snap["pages_used"] == 0 and snap["pages_reserved"] == 0
        assert 0 < snap["kv_bytes_peak"] < snap["kv_bytes_dense"]
        assert snap["requests"] == 5 and snap["tokens_total"] == sum(news)
        assert snap["decode_steps"] >= max(news) and snap["prefill_chunks"] >= 3
    finally:
        sched.shutdown()


def test_snapshot_has_the_jax_panel_keys(lm):
    from pathway_tpu.serving import generation as jgen

    jsched = jgen.GenerationScheduler(jdec.shared_decoder(MODEL, max_cache=MAX_CACHE), slots=1)
    sched = generation.GenerationScheduler(lm, slots=1)
    try:
        assert set(jsched.snapshot()) <= set(sched.snapshot())
    finally:
        jsched.shutdown()
        sched.shutdown()


def test_pool_exhaustion_queues_instead_of_oom(lm):
    """A pool sized for one request at a time: three requests complete
    serially via admission backpressure."""
    rng = np.random.default_rng(8)
    # each request spans 2 pages (prompt 4 + 8 new, page 8); 3 usable pages
    sched = generation.GenerationScheduler(lm, slots=2, page_size=8, pages=4, prefill_chunk=8, queue_limit=16)
    try:
        prompts = [_prompt(rng, 4) for _ in range(3)]
        futs = [sched.submit_ids(p, max_new_tokens=8) for p in prompts]
        got = [f.result(timeout=120) for f in futs]
        for p, out in zip(prompts, got):
            assert out == lm.generate_ids([p], max_new_tokens=8)[0]
        assert sched.allocator.peak_pages <= 3
    finally:
        sched.shutdown()


def test_sampled_requests_stay_in_support(lm):
    """Sampled slots beside greedy ones: the greedy request keeps its
    static tokens, and top_p = 0 (only the top token survives) samples
    the greedy chain too."""
    sched = generation.GenerationScheduler(lm, slots=3, page_size=8, prefill_chunk=8, queue_limit=8, seed=1)
    try:
        greedy = sched.submit_ids([5, 9, 17], max_new_tokens=6)
        nucleus0 = sched.submit_ids([5, 9, 17], max_new_tokens=6, temperature=0.9, top_p=0.0)
        wide = sched.submit_ids([2, 4, 6, 8], max_new_tokens=6, temperature=1.0, min_p=0.0)
        ref = lm.generate_ids([[5, 9, 17]], max_new_tokens=6)[0]
        assert greedy.result(timeout=60) == ref
        assert nucleus0.result(timeout=60) == ref
        out = wide.result(timeout=60)
        assert len(out) == 6 and all(0 <= t < lm.config.vocab_size for t in out)
    finally:
        sched.shutdown()


def test_queue_overflow_raises_overloaded(lm):
    """Bounded queue, not OOM: with a pool too small to ever admit, the
    queue fills and the edge answers 429 with a retry hint."""
    sched = generation.GenerationScheduler(lm, slots=1, page_size=8, pages=2, prefill_chunk=8, queue_limit=2)
    sched._running = True  # white-box: keep the worker thread off
    try:
        f1 = sched.submit_ids([1, 2, 3], max_new_tokens=10)
        f2 = sched.submit_ids([1, 2, 3], max_new_tokens=10)
        with pytest.raises(edge.OverloadedError) as exc_info:
            sched.submit_ids([1, 2, 3], max_new_tokens=10)
        assert exc_info.value.retry_after_s == 1.0 and exc_info.value.status == 429
    finally:
        sched._running = False
        sched.shutdown()
    # shutdown fails the stuck queue entries instead of hanging clients
    assert isinstance(f1.exception(), edge.RequestFailedError)
    assert isinstance(f2.exception(), edge.RequestFailedError)


def test_submit_rejects_unservable_max_new_tokens(lm):
    sched = generation.GenerationScheduler(lm, slots=1, page_size=16, prefill_chunk=8, queue_limit=2)
    sched._running = True
    try:
        with pytest.raises(ValueError, match="max_new_tokens"):
            sched.submit_ids([1], max_new_tokens=MAX_CACHE)
    finally:
        sched._running = False
        sched.shutdown()


# ---------------------------------------------------------------------------
# White-box ticks
# ---------------------------------------------------------------------------


def test_admit_skips_unreservable_head_of_queue(lm):
    """A request that cannot reserve pages yet must not block small ones
    behind it: admission scans the whole queue."""
    sched = generation.GenerationScheduler(lm, slots=2, page_size=8, pages=5, prefill_chunk=8, queue_limit=16)
    big = generation.GenRequest([1] * 8, 40)  # 48 tokens -> 6 pages: never fits
    small = generation.GenRequest([1, 2], 4)  # 6 tokens -> 1 page
    _enqueue(sched, big)
    _enqueue(sched, small)
    sched._tick()
    with sched._lock:
        active = [s.req for s in sched._slots if s is not None]
    assert small in active and big not in active
    assert big in sched._queue
    for _ in range(200):
        if small.future.done():
            break
        sched._tick()
    assert small.future.result(timeout=5) is not None
    assert big in sched._queue and not big.future.done()
    sched.shutdown()
    assert isinstance(big.future.exception(), edge.RequestFailedError)


def test_deadline_shed_mid_generation(lm):
    """A row whose deadline lapses mid-generation is evicted at the next
    tick, counted, and its future says how far it got."""
    sched = generation.GenerationScheduler(lm, slots=1, page_size=16, prefill_chunk=8, queue_limit=4)
    req = generation.GenRequest([5, 6, 7], 40, deadline=edge.Deadline.from_ms(60_000))
    _enqueue(sched, req)
    sched._tick()  # admit + prefill + first decode
    sched._tick()
    assert len(req.out) >= 1 and not req.future.done()
    req.deadline = edge.Deadline.from_ms(0)  # lapse it, mid-generation
    sched._tick()
    assert sched.snapshot()["deadline_shed"]["decode"] == 1
    with pytest.raises(edge.DeadlineExceededError, match="token"):
        req.future.result(timeout=1)
    with sched._lock:
        assert all(s is None for s in sched._slots)
    assert sched.allocator.used_pages == 0 and sched.allocator.reserved == 0
    sched.shutdown()


def test_lapsed_queued_request_is_shed_from_queue(lm):
    sched = generation.GenerationScheduler(lm, slots=1, page_size=16, prefill_chunk=8, queue_limit=4)
    sched._running = True
    with pytest.raises(edge.DeadlineExceededError):
        sched.submit_ids([1], max_new_tokens=4, deadline=edge.Deadline.from_ms(0))
    # the ambient deadline of the caller's context applies too
    with edge.deadline_scope(edge.Deadline.from_ms(0)):
        with pytest.raises(edge.DeadlineExceededError):
            sched.submit_ids([1], max_new_tokens=4)
    req = generation.GenRequest([1], 4, deadline=edge.Deadline.from_ms(60_000))
    _enqueue(sched, req)
    req.deadline = edge.Deadline.from_ms(0)
    sched._tick()
    assert sched.snapshot()["deadline_shed"]["generate-queue"] == 3
    with pytest.raises(edge.DeadlineExceededError):
        req.future.result(timeout=1)
    sched._running = False
    sched.shutdown()


def test_chunked_prefill_does_not_stall_short_prompts(lm):
    """While a long prompt prefills in fixed chunks, a short prompt
    admitted beside it reaches its first token in the first tick."""
    sched = generation.GenerationScheduler(lm, slots=2, page_size=16, prefill_chunk=4, queue_limit=8)
    rng = np.random.default_rng(9)
    long = generation.GenRequest(_prompt(rng, 20), 4)  # 5 prefill chunks
    short = generation.GenRequest(_prompt(rng, 2), 4)
    _enqueue(sched, long)
    _enqueue(sched, short)
    sched._tick()
    assert short.first_token_at is not None
    assert long.first_token_at is None
    _drive(sched)
    assert short.future.result(timeout=5) == lm.generate_ids([short.prompt_ids], max_new_tokens=4)[0]
    assert long.future.result(timeout=5) == lm.generate_ids([long.prompt_ids], max_new_tokens=4)[0]
    sched.shutdown()


def test_tick_failure_fails_requests_not_the_thread(lm):
    """A failing tick fails the in-flight futures, frees their pages, and
    the worker thread goes on serving."""
    sched = generation.GenerationScheduler(lm, slots=1, page_size=16, prefill_chunk=8, queue_limit=4)
    boom = RuntimeError("device fell over")
    real_prefill = sched._run_prefill
    calls = []

    def failing_prefill(rows):
        calls.append(rows)
        if len(calls) == 1:
            raise boom
        return real_prefill(rows)

    sched._run_prefill = failing_prefill
    try:
        first = sched.submit_ids([1, 2], max_new_tokens=4)
        assert first.exception(timeout=30) is boom
        assert sched.allocator.used_pages == 0 and sched.allocator.reserved == 0
        second = sched.submit_ids([1, 2], max_new_tokens=4)
        assert second.result(timeout=30) == lm.generate_ids([[1, 2]], max_new_tokens=4)[0]
        assert sched._thread.is_alive()
    finally:
        sched.shutdown()
    assert not sched._thread.is_alive()


def test_allocator_never_surfaces_page_exhausted_under_churn(lm):
    """Random scripted churn against a small pool: the reservation
    discipline keeps alloc() infallible for admitted rows."""
    sched = generation.GenerationScheduler(lm, slots=3, page_size=8, pages=9, prefill_chunk=8, queue_limit=64)
    rng = np.random.default_rng(13)
    reqs = []
    try:
        for t in range(60):
            if t < 30 and rng.random() < 0.5:
                req = generation.GenRequest(_prompt(rng, int(rng.integers(1, 10))), int(rng.integers(2, 12)))
                _enqueue(sched, req)
                reqs.append(req)
            with sched._lock:
                idle = not sched._queue and all(s is None for s in sched._slots)
            if idle and t >= 30:
                break
            sched._tick()
        _drive(sched)
        assert all(r.future.done() for r in reqs)
        for r in reqs:
            assert r.future.result() == lm.generate_ids([r.prompt_ids], max_new_tokens=r.max_new_tokens)[0]
        assert sched.allocator.used_pages == 0 and sched.allocator.reserved == 0
    finally:
        sched.shutdown()


# ---------------------------------------------------------------------------
# Shared-scheduler wiring and knobs
# ---------------------------------------------------------------------------


def test_shared_scheduler_is_per_model_singleton():
    try:
        a = generation.shared_scheduler(MODEL, max_cache=MAX_CACHE, device="cpu")
        b = generation.shared_scheduler(MODEL, max_cache=MAX_CACHE, device="cpu")
        assert a is b
        c = generation.shared_scheduler(MODEL, max_cache=32, device="cpu")
        assert c is not a
        # the JAX package's defaults: 8 slots, page 16, chunk 32, queue 128,
        # and a pool of half the dense worst case plus the null page
        assert (a.slots, a.page_size, a.prefill_chunk, a.queue_limit) == (8, 16, 32, 128)
        assert a.num_pages == 8 * (MAX_CACHE // 16) // 2 + 1
    finally:
        generation.reset_shared_schedulers()


def test_env_knobs(monkeypatch, lm):
    monkeypatch.delenv("PATHWAY_GENERATE_CONTINUOUS", raising=False)
    assert generation.continuous_enabled()  # on by default
    monkeypatch.setenv("PATHWAY_GENERATE_CONTINUOUS", "0")
    assert not generation.continuous_enabled()
    monkeypatch.setenv("PATHWAY_GENERATE_CONTINUOUS", "yes")
    assert generation.continuous_enabled()
    monkeypatch.setenv("PATHWAY_GENERATE_SLOTS", "3")
    monkeypatch.setenv("PATHWAY_GENERATE_PAGES", "7")
    monkeypatch.setenv("PATHWAY_GENERATE_PREFILL_CHUNK", "not-a-number")
    sched = generation.GenerationScheduler(lm)
    assert (sched.slots, sched.num_pages, sched.prefill_chunk) == (3, 7, 32)
    sched.shutdown()


def test_text_submit_decodes(lm):
    sched = generation.GenerationScheduler(lm, slots=2, queue_limit=4)
    try:
        text = sched.generate("streaming answer", max_new_tokens=5)
        ids = lm.generate_ids([lm._encode_prompt("streaming answer")], max_new_tokens=5)[0]
        assert text == lm.tokenizer.decode(ids)
        assert asyncio.run(sched.agenerate("streaming answer", max_new_tokens=5)) == text
    finally:
        sched.shutdown()


def test_request_churn_fault_injects_a_burst(lm):
    """The ``request_churn`` fault fires at admission, as in the JAX
    package: ``count`` short requests join the queue, counted by
    ``generate.churn.synthetic``."""
    from pathway_tpu_torch.engine import faults, metrics

    churn = metrics.get_registry().counter("generate.churn.synthetic")
    before = churn.value
    sched = generation.GenerationScheduler(lm, slots=2)
    faults.install_plan(faults.FaultPlan([{"kind": "request_churn", "source": MODEL, "nth": 1, "count": 3}]))
    try:
        _enqueue(sched, generation.GenRequest([5, 9, 17], 4))  # white-box: no worker thread
        with sched._lock:
            sched._admit()
            queued = len(sched._queue) + sum(s is not None for s in sched._slots)
    finally:
        faults.clear_plan()
        sched.shutdown()
    assert queued == 4 and churn.value - before == 3
