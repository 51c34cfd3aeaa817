"""Continuous-batching generation scheduler over the paged KV cache.

Counterpart of ``pathway_tpu/serving/generation.py``:

* **Slots** — a fixed device batch of ``S`` generation slots.  At every
  tick, finished or lapsed rows are evicted and queued requests are
  admitted into the freed slots.
* **Paged KV** — each slot's cache lives in fixed-size pages of the
  preallocated pool (``models/decoder.py::init_kv_pool``), allocated as
  tokens arrive and freed at eviction.  Admission reserves a request's
  worst case up front, so the pool never runs out mid-generation; requests
  queue (bounded) instead.
* **Chunked prefill** — prompts prefill in fixed-width chunks interleaved
  with decode ticks, so a long prompt cannot stall other requests.
* **Deadlines** — requests carry an ``engine.serving.Deadline``; a row that
  lapses mid-generation is shed at the next tick.

A worker thread runs the tick (evict → admit → chunked prefill → one
decode step → deliver) under ``torch.inference_mode()`` on the model's
device, with one host sync per tick.

The JAX package's host hooks: the ``generate.*`` families of the metrics
registry (requests, tokens, prefill chunks, decode steps, TTFT histogram,
slot/queue/page/KV gauges), the snapshot as the flight recorder's
generation supplier, the request trace captured at submit (spans
``generate.queue``, ``generate.prefill.chunk``, ``generate.ttft`` and
``generate.decode``) and the ``request_churn`` fault.  The counts are also
plain ints in :meth:`GenerationScheduler.snapshot`.  One addition: a
prompt longer than the cache budget keeps its tail, as in the JAX package,
and is counted (``generate.prompt.truncated``, ``prompts_truncated``).
"""

from __future__ import annotations

import asyncio
import threading
import time
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from pathway_tpu_torch.engine import flight_recorder as _blackbox
from pathway_tpu_torch.engine import metrics as em
from pathway_tpu_torch.engine import serving as edge
from pathway_tpu_torch.engine import tracing
from pathway_tpu_torch.internals.config import env_bool, env_int
from pathway_tpu_torch.models import decoder as dec

__all__ = [
    "GenRequest",
    "GenerationScheduler",
    "continuous_enabled",
    "reset_shared_schedulers",
    "shared_scheduler",
]

def continuous_enabled() -> bool:
    """``PATHWAY_GENERATE_CONTINUOUS`` (on by default): route chat
    generation through the continuous scheduler."""
    return env_bool("PATHWAY_GENERATE_CONTINUOUS")


def _pow2_bucket(n: int, cap: int) -> int:
    b = 1
    while b < n and b < cap:
        b <<= 1
    return min(b, cap)


class GenRequest:
    """One queued/running generation request."""

    __slots__ = (
        "prompt_ids", "max_new_tokens", "temperature", "top_p", "min_p",
        "deadline", "future", "submitted_at", "first_token_at",
        "finished_at", "out", "pages_reserved", "trace", "submitted_wall",
        "first_token_wall",
    )

    def __init__(
        self,
        prompt_ids: list[int],
        max_new_tokens: int,
        *,
        temperature: float = 0.0,
        top_p: float | None = None,
        min_p: float | None = None,
        deadline=None,
        trace=None,
    ):
        self.prompt_ids = prompt_ids
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_p = top_p
        self.min_p = min_p
        self.deadline = deadline
        self.future: Future = Future()
        self.submitted_at = time.monotonic()
        # request trace (engine/tracing.py): captured at submit in the
        # caller's context, spans recorded from the scheduler thread with
        # wall-clock starts
        self.trace = trace
        self.submitted_wall = time.time()
        self.first_token_wall: float | None = None
        self.first_token_at: float | None = None
        self.finished_at: float | None = None
        self.out: list[int] = []
        self.pages_reserved = 0

    @property
    def ttft_s(self) -> float | None:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.submitted_at


class _Slot:
    """Device-slot state: which request occupies row ``i`` of the batch."""

    __slots__ = ("req", "pages", "seq_len", "prefill_done", "prompt_len")

    def __init__(self, req: GenRequest):
        self.req = req
        self.pages: list[int] = []
        self.seq_len = 0  # tokens written into the paged cache
        self.prompt_len = len(req.prompt_ids)
        self.prefill_done = False


class GenerationScheduler:
    """Continuous-batching scheduler for one :class:`DecoderLM`.

    A worker thread runs the tick loop; ``submit_ids`` / ``submit`` are
    thread-safe and return ``concurrent.futures.Future``.  The KV pool and
    every tensor of the tick live on the model's device.
    """

    def __init__(
        self,
        lm,
        *,
        slots: int | None = None,
        page_size: int | None = None,
        pages: int | None = None,
        prefill_chunk: int | None = None,
        queue_limit: int | None = None,
        seed: int = 0,
    ):
        self.lm = lm
        self.cfg = lm.config
        self.device = lm.device
        self.max_cache = lm.max_cache
        self.slots = slots if slots is not None else env_int("PATHWAY_GENERATE_SLOTS")
        self.page_size = page_size if page_size is not None else env_int("PATHWAY_GENERATE_PAGE_SIZE")
        self.prefill_chunk = (
            prefill_chunk if prefill_chunk is not None else env_int("PATHWAY_GENERATE_PREFILL_CHUNK")
        )
        self.queue_limit = queue_limit if queue_limit is not None else env_int("PATHWAY_GENERATE_QUEUE")
        self.pages_per_seq = -(-self.max_cache // self.page_size)
        n_pages = pages if pages is not None else env_int("PATHWAY_GENERATE_PAGES")
        if n_pages <= 0:
            # auto: half the dense worst case, floored so at least one
            # full-cache request always fits
            n_pages = max(self.slots * self.pages_per_seq // 2, self.pages_per_seq) + 1
        self.num_pages = n_pages
        bytes_per_token = dec.kv_bytes_per_token(self.cfg)
        self.dense_kv_bytes = self.slots * self.max_cache * bytes_per_token
        self.allocator = dec.PageAllocator(self.num_pages, self.page_size, bytes_per_token)
        self._k_pool, self._v_pool = dec.init_kv_pool(
            self.cfg, self.num_pages, self.page_size, self.device
        )
        self._logits = torch.zeros((self.slots, self.cfg.vocab_size), dtype=torch.float32, device=self.device)
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._block_tables = np.zeros((self.slots, self.pages_per_seq), np.int64)
        self._seq_lens = np.zeros(self.slots, np.int64)
        self._temps = np.zeros(self.slots, np.float32)
        self._top_ps = np.ones(self.slots, np.float32)
        self._min_ps = np.zeros(self.slots, np.float32)

        self._lock = threading.Condition()
        self._queue: list[GenRequest] = []
        self._slots: list[_Slot | None] = [None] * self.slots
        self._running = False
        self._thread: threading.Thread | None = None
        # the registry's counts, also kept as plain ints for snapshot()
        self._requests = 0
        self._tokens_total = 0
        self._prefill_chunks = 0
        self._decode_steps = 0
        self._truncated = 0
        self._shed = {"decode": 0, "generate-queue": 0}
        self._tok_window: list[tuple[float, int]] = []  # (t, tokens) per tick

        reg = self._reg = em.get_registry()
        self._m_requests = reg.counter("generate.requests", "generation requests accepted")
        self._m_tokens = reg.counter("generate.tokens", "tokens generated across all requests")
        self._m_prefill_chunks = reg.counter("generate.prefill.chunks", "chunked-prefill programs dispatched")
        self._m_decode_steps = reg.counter("generate.decode.steps", "continuous decode ticks dispatched")
        self._m_ttft = reg.histogram(
            "generate.ttft.ms", "request submit -> first token (ms)", buckets=em.MS_BUCKETS
        )
        self._m_churn = reg.counter(
            "generate.churn.synthetic", "synthetic burst requests injected by the request_churn fault"
        )
        self._m_truncated = reg.counter(
            "generate.prompt.truncated", "prompts cut to their tail to fit the cache budget"
        )
        _blackbox.get_recorder().set_generation_supplier(self.snapshot)

    # -- submission --------------------------------------------------------

    def submit_request(
        self,
        prompt_ids: list[int],
        *,
        max_new_tokens: int = 64,
        temperature: float = 0.0,
        top_p: float | None = None,
        min_p: float | None = None,
        deadline=None,
    ) -> GenRequest:
        """Enqueue one request and return it; its ``.future`` resolves to
        the generated id list, and it carries the request's timings.

        Raises :class:`OverloadedError` when the bounded queue is full and
        :class:`DeadlineExceededError` when the request arrives lapsed."""
        if max_new_tokens >= self.max_cache:
            raise ValueError(
                f"max_new_tokens={max_new_tokens} must be < max_cache={self.max_cache}"
            )
        if deadline is None:
            deadline = edge.current_deadline()
        if deadline is not None and deadline.expired():
            edge.note_deadline_shed("generate-queue")
            with self._lock:
                self._shed["generate-queue"] += 1
            raise edge.DeadlineExceededError("request deadline lapsed before generation was queued")
        limit = self.max_cache - max_new_tokens
        truncated = len(prompt_ids) > limit
        prompt_ids = list(prompt_ids[-limit:]) if truncated else list(prompt_ids)
        if not prompt_ids:
            prompt_ids = [0]
        req = GenRequest(
            prompt_ids, max_new_tokens, temperature=temperature,
            top_p=top_p, min_p=min_p, deadline=deadline,
            trace=tracing.current_trace(),
        )
        with self._lock:
            if len(self._queue) >= self.queue_limit:
                raise edge.OverloadedError("generation queue full", retry_after_s=1.0)
            self._queue.append(req)
            self._requests += 1
            self._truncated += truncated
            self._ensure_thread()
            self._lock.notify_all()
        self._m_requests.inc()
        if truncated:
            self._m_truncated.inc()
        return req

    def submit_ids(self, prompt_ids: list[int], **kwargs) -> Future:
        """Enqueue one request; resolves to the generated id list."""
        return self.submit_request(prompt_ids, **kwargs).future

    def submit(self, prompt: str, **kwargs) -> Future:
        """Text-in/text-out: resolves to the decoded completion."""
        inner = self.submit_ids(self.lm._encode_prompt(prompt), **kwargs)
        outer: Future = Future()

        def _done(f: Future) -> None:
            exc = f.exception()
            if exc is not None:
                outer.set_exception(exc)
            else:
                outer.set_result(self.lm.tokenizer.decode(f.result()))

        inner.add_done_callback(_done)
        return outer

    def generate(self, prompt: str, timeout: float | None = 120.0, **kwargs) -> str:
        return self.submit(prompt, **kwargs).result(timeout=timeout)

    async def agenerate(self, prompt: str, **kwargs) -> str:
        return await asyncio.wrap_future(self.submit(prompt, **kwargs))

    # -- worker loop -------------------------------------------------------

    def _ensure_thread(self) -> None:
        if self._running:
            return
        self._running = True
        self._thread = threading.Thread(target=self._loop, daemon=True, name="pathway:generate")
        self._thread.start()

    def _loop(self) -> None:
        while True:
            with self._lock:
                while self._running and not self._queue and all(s is None for s in self._slots):
                    self._update_gauges()
                    self._lock.wait(timeout=0.5)
                if not self._running:
                    return
            try:
                self._tick()
            except Exception as exc:  # noqa: BLE001 - fail requests, not the thread
                self._fail_all(exc)

    def shutdown(self) -> None:
        """Stop the worker; queued/active requests fail rather than hang."""
        with self._lock:
            self._running = False
            self._lock.notify_all()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._fail_all(edge.RequestFailedError("generation scheduler shut down"))
        _blackbox.get_recorder().set_generation_supplier(None)

    def _fail_all(self, exc: BaseException) -> None:
        with self._lock:
            victims = list(self._queue)
            self._queue.clear()
            for i, slot in enumerate(self._slots):
                if slot is not None:
                    victims.append(slot.req)
                    self._release_slot(i)
            for r in victims:
                if not r.future.done():
                    r.future.set_exception(exc)

    # -- the tick ----------------------------------------------------------

    def _tick(self) -> None:
        t0 = time.monotonic()
        with self._lock:
            self._evict_lapsed(t0)
            self._admit()
            prefill_rows = [i for i, s in enumerate(self._slots) if s is not None and not s.prefill_done]
            decode_rows = [i for i, s in enumerate(self._slots) if s is not None and s.prefill_done]
        # inference mode is per thread: entered here, where the device work is
        with torch.inference_mode():
            if prefill_rows:
                decode_rows.extend(self._run_prefill(prefill_rows))
            if decode_rows:
                self._run_decode(decode_rows)
        with self._lock:
            self._update_gauges()
        self._tok_window.append((t0, len(decode_rows)))
        if len(self._tok_window) > 256:
            del self._tok_window[:128]

    def _evict_lapsed(self, now: float) -> None:
        """Shed active rows whose deadline lapsed mid-generation, and
        queued requests that lapsed while waiting.  Runs under the lock."""
        for i, slot in enumerate(self._slots):
            if slot is None:
                continue
            d = slot.req.deadline
            if d is not None and d.expired(now):
                edge.note_deadline_shed("decode")
                self._shed["decode"] += 1
                req = slot.req
                self._release_slot(i)
                if not req.future.done():
                    req.future.set_exception(edge.DeadlineExceededError(
                        f"deadline lapsed mid-generation ({len(req.out)} token(s) produced)"
                    ))
        kept = []
        for req in self._queue:
            d = req.deadline
            if d is not None and d.expired(now):
                edge.note_deadline_shed("generate-queue")
                self._shed["generate-queue"] += 1
                if not req.future.done():
                    req.future.set_exception(
                        edge.DeadlineExceededError("deadline lapsed while queued for generation")
                    )
            else:
                kept.append(req)
        self._queue[:] = kept

    def _admit(self) -> None:
        """Fill free slots from the queue.  The whole queue is scanned: a
        request that cannot reserve pages yet must not block smaller ones
        behind it.  Runs under the lock."""
        self._maybe_inject_churn()
        free = [i for i, s in enumerate(self._slots) if s is None]
        if not free:
            return
        remaining: list[GenRequest] = []
        for req in self._queue:
            if not free:
                remaining.append(req)
                continue
            need = self.allocator.pages_for(len(req.prompt_ids) + req.max_new_tokens)
            if not self.allocator.can_reserve(need):
                remaining.append(req)
                continue
            self.allocator.reserve(need)
            req.pages_reserved = need
            i = free.pop(0)
            if req.trace is not None:
                # queue-wait span: submit → slot grant
                req.trace.add_span(
                    "generate.queue", req.submitted_wall, max(0.0, time.time() - req.submitted_wall),
                    slot=i, pages=need,
                )
            self._slots[i] = _Slot(req)
            self._block_tables[i, :] = 0
            self._seq_lens[i] = 0
            self._temps[i] = req.temperature
            self._top_ps[i] = 1.0 if req.top_p is None else req.top_p
            self._min_ps[i] = 0.0 if req.min_p is None else req.min_p
        self._queue[:] = remaining

    def _maybe_inject_churn(self) -> None:
        """The ``request_churn`` fault: a burst of short synthetic requests
        lands mid-generation (runs under the lock)."""
        from pathway_tpu_torch.engine import faults

        spec = faults.check("request_churn", source=self.lm.model_name)
        if spec is None:
            return
        for n in range(int(spec.count or 4)):
            req = GenRequest([1 + (n % 7)], 4, temperature=0.0)
            if len(self._queue) < self.queue_limit:
                self._queue.append(req)
                self._m_churn.inc()

    def _ensure_pages(self, i: int, tokens_needed: int) -> None:
        """Grow slot ``i``'s block table to cover ``tokens_needed`` tokens
        (allocation against the admission-time reservation)."""
        slot = self._slots[i]
        while len(slot.pages) * self.page_size < tokens_needed:
            page = self.allocator.alloc()
            slot.pages.append(page)
            self._block_tables[i, len(slot.pages) - 1] = page

    def _release_slot(self, i: int) -> None:
        slot = self._slots[i]
        if slot is None:
            return
        unreserve = max(slot.req.pages_reserved - len(slot.pages), 0)
        self.allocator.release(slot.pages, unreserve=unreserve)
        self._slots[i] = None
        self._block_tables[i, :] = 0
        self._seq_lens[i] = 0
        self._temps[i] = 0.0
        self._top_ps[i] = 1.0
        self._min_ps[i] = 0.0

    def _table_width(self) -> int:
        """Power-of-two block-table width covering every active slot."""
        most = max([1] + [len(s.pages) for s in self._slots if s is not None])
        return _pow2_bucket(most, self.pages_per_seq)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Upload a host array without waiting on the device: a copy from
        pageable memory synchronises the stream, so on CUDA it goes
        through pinned memory, asynchronously.  The tick's one sync is
        then the read of its tokens."""
        t = torch.from_numpy(a)
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _run_prefill(self, rows: list[int]) -> list[int]:
        """One fixed-width prefill chunk for every prefilling slot;
        returns the rows whose prompt completed (now decode-ready)."""
        T = self.prefill_chunk
        ids = np.zeros((self.slots, T), np.int64)
        chunk_lens = np.zeros(self.slots, np.int64)
        starts = np.zeros(self.slots, np.int64)
        take = np.zeros(self.slots, bool)
        finishing: list[int] = []
        traced_chunks: list[tuple] = []
        with self._lock:
            for i in rows:
                slot = self._slots[i]
                if slot is None:
                    continue
                done = slot.seq_len
                n = min(T, slot.prompt_len - done)
                if n <= 0:
                    continue
                self._ensure_pages(i, done + n)
                ids[i, :n] = slot.req.prompt_ids[done:done + n]
                chunk_lens[i] = n
                starts[i] = done
                if slot.req.trace is not None:
                    traced_chunks.append((slot.req.trace, n, done))
                if done + n >= slot.prompt_len:
                    take[i] = True
                    finishing.append(i)
            bt = self._block_tables[:, : self._table_width()].copy()
        chunk_started = time.time()
        logits, self._k_pool, self._v_pool = dec.paged_prefill_chunk(
            self.lm.params, self._k_pool, self._v_pool, self._to_device(bt),
            self._to_device(ids), self._to_device(chunk_lens), self._to_device(starts), self.cfg,
        )
        self._logits = torch.where(self._to_device(take)[:, None], logits, self._logits)
        self._m_prefill_chunks.inc()
        if traced_chunks:
            # one shared prefill chunk, one span per traced request: the
            # wall duration is the whole chunk's launch (work is fused)
            chunk_s = max(0.0, time.time() - chunk_started)
            for trace, n, done in traced_chunks:
                trace.add_span("generate.prefill.chunk", chunk_started, chunk_s,
                               chunk_len=int(n), prompt_start=int(done))
        with self._lock:
            self._prefill_chunks += 1
            for i in rows:
                slot = self._slots[i]
                if slot is None:
                    continue
                slot.seq_len += int(chunk_lens[i])
                self._seq_lens[i] = slot.seq_len
                if take[i]:
                    slot.prefill_done = True
        return finishing

    def _sample(self, temps: np.ndarray, top_ps: np.ndarray, min_ps: np.ndarray) -> torch.Tensor:
        """Each slot's next token from the current logits: argmax where its
        temperature is 0, else a draw after its top-p / min-p filters."""
        tok = self._logits.argmax(dim=-1)
        if not (temps > 0).any():
            return tok
        temp = self._to_device(temps)
        sampled = dec.sample_logits(
            self._logits, self._generator, temp.clamp(min=1e-6)[:, None],
            top_p=self._to_device(top_ps)[:, None], min_p=self._to_device(min_ps)[:, None],
        )
        return torch.where(temp > 0, sampled, tok)

    def _run_decode(self, rows: list[int]) -> None:
        """One continuous decode step: sample every decode-ready row's next
        token, write paged KV, deliver/evict finished rows."""
        with self._lock:
            for i in rows:
                slot = self._slots[i]
                if slot is not None:
                    self._ensure_pages(i, slot.seq_len + 1)
            bt = self._block_tables[:, : self._table_width()].copy()
            sl = self._seq_lens.copy()
            temps, top_ps, min_ps = self._temps.copy(), self._top_ps.copy(), self._min_ps.copy()
        tok = self._sample(temps, top_ps, min_ps)
        self._logits, self._k_pool, self._v_pool = dec.paged_decode_step(
            self.lm.params, self._k_pool, self._v_pool, self._to_device(bt),
            self._to_device(sl), tok, self.cfg,
        )
        htok = tok.cpu().numpy()  # the one host sync per tick
        self._m_decode_steps.inc()
        t_now = time.monotonic()
        eos = self.lm.eos_id
        produced = 0
        with self._lock:
            self._decode_steps += 1
            for i in rows:
                slot = self._slots[i]
                if slot is None or not slot.prefill_done:
                    continue
                req = slot.req
                t = int(htok[i])
                slot.seq_len += 1
                self._seq_lens[i] = slot.seq_len
                if req.first_token_at is None:
                    req.first_token_at = t_now
                    req.first_token_wall = time.time()
                    ttft_s = t_now - req.submitted_at
                    self._m_ttft.observe(ttft_s * 1e3, trace_id=req.trace.trace_id if req.trace is not None else None)
                    if req.trace is not None:
                        req.trace.add_span("generate.ttft", req.submitted_wall, ttft_s, prompt_len=slot.prompt_len)
                stop = eos is not None and t == eos
                if not stop:
                    req.out.append(t)
                    produced += 1
                if stop or len(req.out) >= req.max_new_tokens:
                    req.finished_at = t_now
                    if req.trace is not None:
                        start = req.first_token_wall or req.submitted_wall
                        req.trace.add_span("generate.decode", start, max(0.0, time.time() - start),
                                           tokens=len(req.out), eos=bool(stop))
                    self._release_slot(i)
                    if not req.future.done():
                        req.future.set_result(req.out)
            self._tokens_total += produced
        if produced:
            self._m_tokens.inc(produced)

    # -- observability -----------------------------------------------------

    def _update_gauges(self) -> None:
        """The ``generate.*`` gauges (runs under the lock)."""
        reg, a = self._reg, self.allocator
        reg.gauge("generate.slots.active", "occupied generation slots").set(
            sum(1 for s in self._slots if s is not None))
        reg.gauge("generate.slots.total", "configured generation slots").set(self.slots)
        reg.gauge("generate.queue.depth", "requests queued for a slot").set(len(self._queue))
        reg.gauge("generate.pages.used", "KV pool pages holding live tokens").set(a.used_pages)
        reg.gauge("generate.pages.total", "KV pool pages (page 0 reserved)").set(self.num_pages - 1)
        reg.gauge("generate.kv.bytes.live", "KV bytes backing live tokens").set(a.live_bytes)
        reg.gauge("generate.kv.bytes.peak", "high-water mark of live KV bytes").set(a.peak_bytes)
        reg.gauge("generate.kv.bytes.dense",
                  "what the dense slots x max_cache layout would hold resident").set(self.dense_kv_bytes)
        now = time.monotonic()
        window = [(t, n) for (t, n) in self._tok_window if now - t <= 5.0]
        span = (now - window[0][0]) if len(window) > 1 else 0.0
        rate = sum(n for _, n in window) / span if span > 0 else 0.0
        reg.gauge("generate.tokens_per_s", "sustained decode throughput (5 s window)").set(rate)

    def snapshot(self) -> dict[str, Any]:
        """The JAX package's generation panel, plus the counts its metrics
        registry keeps."""
        with self._lock:
            active = sum(1 for s in self._slots if s is not None)
            prefilling = sum(1 for s in self._slots if s is not None and not s.prefill_done)
            return {
                "slots": self.slots,
                "active": active,
                "prefilling": prefilling,
                "queued": len(self._queue),
                "pages_total": self.num_pages - 1,
                "pages_used": self.allocator.used_pages,
                "pages_reserved": self.allocator.reserved,
                "kv_bytes_live": self.allocator.live_bytes,
                "kv_bytes_peak": self.allocator.peak_bytes,
                "kv_bytes_dense": self.dense_kv_bytes,
                "tokens_total": self._tokens_total,
                "requests": self._requests,
                "prompts_truncated": self._truncated,
                "prefill_chunks": self._prefill_chunks,
                "decode_steps": self._decode_steps,
                "deadline_shed": dict(self._shed),
            }


# ---------------------------------------------------------------------------
# Shared schedulers
# ---------------------------------------------------------------------------

_shared: dict[tuple, GenerationScheduler] = {}
_shared_lock = threading.Lock()


def shared_scheduler(
    model_name: str, max_cache: int = 1024, quantize: str | None = None, device=None
) -> GenerationScheduler:
    """Process-wide scheduler per (model, cache, quant, device): every
    caller feeds one continuous batch per model."""
    key = (model_name, max_cache, quantize, None if device is None else str(device))
    with _shared_lock:
        sched = _shared.get(key)
        if sched is None:
            sched = GenerationScheduler(
                dec.shared_decoder(model_name, max_cache=max_cache, quantize=quantize, device=device)
            )
            _shared[key] = sched
        return sched


def reset_shared_schedulers() -> None:
    """Shut down and drop every shared scheduler."""
    with _shared_lock:
        scheds = list(_shared.values())
        _shared.clear()
    for s in scheds:
        s.shutdown()
