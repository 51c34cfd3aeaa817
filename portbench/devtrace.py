"""The device's side of a traced window, from ``torch.profiler``.

``Window`` profiles the CPU and the card between ``start`` and ``stop``
and reads the raw events (no per-event Python objects beyond one pass):
the union of device activity (busy seconds), the device time of the
kernels launched inside each of the probe's host ranges, the kernels that
took most time, and the longest idle gaps named by what the host was
doing.  The profiler records CPU operators on its own thread only, so the
host side comes from the probe's ranges, tied to the trace's launch calls
by time (``summarize``).
"""

from __future__ import annotations

import bisect
import time


class Window:
    def __init__(self):
        import torch

        self._prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA],
            record_shapes=False, with_stack=False, profile_memory=False,
        )
        self.t0_ns = self.t1_ns = 0

    def start(self) -> None:
        self._prof.start()
        self.t0_ns = time.time_ns()

    def stop(self, ranges=(), foreign=None) -> dict:
        import torch

        torch.cuda.synchronize()
        self.t1_ns = time.time_ns()
        self._prof.stop()
        return summarize(self._prof.profiler.kineto_results.events(), self.t0_ns, self.t1_ns, ranges,
                         foreign=foreign)


def _is_device(ev) -> bool:
    return ev.device_type().name in ("CUDA", "PrivateUse1")


def _merge(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[list[int]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _innermost(lst: list, starts: list, t: int):
    """The innermost of one thread's nested ranges ``(start, end, name)``
    that holds ``t``, or None."""
    i = bisect.bisect_right(starts, t) - 1
    for _ in range(256):  # siblings that ended before t, then the parent
        if i < 0:
            return None
        if lst[i][1] >= t:
            return lst[i]
        i -= 1
    return None


def summarize(events, t0_ns: int, t1_ns: int, ranges=(), top: int = 10, foreign=None) -> dict:
    """Busy and window seconds; the device seconds of the kernels launched
    inside each host range ``(name, start_ns, end_ns, thread)``; the
    ``top`` kernels by device seconds; the ``top`` longest idle gaps, each
    named by the host ranges open across it.

    The trace gives every launch one thread, so a kernel is tied to ranges
    by its launch's time alone: to the innermost range on each thread that
    holds it, and of those to the one that began last, where every other
    thread's range spans it whole (a caller waiting on it, as an epoch
    waits on the scheduler) and is not one of its ``foreign`` names (work
    that another thread launches then, as the encoder's while a query is
    embedded).  Otherwise the kernel counts for no range
    (``ambiguous_kernel_s``)."""
    foreign = foreign or {}
    device, launches = [], {}
    for ev in events:
        start, dur = ev.start_ns(), ev.duration_ns()
        name = ev.name()
        if _is_device(ev):
            if ev.is_user_annotation() or dur <= 0:
                continue
            device.append((start, start + dur, name, ev.correlation_id()))
        elif "Launch" in name or name.startswith(("cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")):
            launches[ev.correlation_id()] = start
    busy = _merge([(max(a, t0_ns), min(b, t1_ns)) for a, b, _n, _c in device if b > t0_ns and a < t1_ns])
    busy_ns = sum(b - a for a, b in busy)

    by_kernel: dict[str, float] = {}
    for a, b, name, _c in device:
        by_kernel[name] = by_kernel.get(name, 0.0) + (b - a) / 1e9
    top_ops = sorted(by_kernel.items(), key=lambda kv: -kv[1])[:top]

    by_thread: dict = {}
    for name, a, b, ids in ranges:
        by_thread.setdefault(ids[0] if isinstance(ids, tuple) else ids, []).append((a, b, name))
    threads = [(lst, [r[0] for r in lst]) for lst in (sorted(v) for v in by_thread.values())]
    flat = sorted(r for lst, _st in threads for r in lst)
    flat_starts = [r[0] for r in flat]
    range_s: dict[str, float] = {}
    range_kernels: dict[str, dict] = {}
    ambiguous_s = 0.0
    for a, b, kname, corr in device:
        t = launches.get(corr)
        if t is None:
            continue
        held = [r for r in (_innermost(lst, st, t) for lst, st in threads) if r is not None]
        if not held:
            continue
        last = max(held, key=lambda r: r[0])
        if any(r is not last and not (r[0] <= last[0] and r[1] >= last[1] and r[2] not in foreign.get(last[2], ()))
               for r in held):
            ambiguous_s += (b - a) / 1e9
            continue
        rname = last[2]
        range_s[rname] = range_s.get(rname, 0.0) + (b - a) / 1e9
        names = range_kernels.setdefault(rname, {})
        names[kname[:80]] = names.get(kname[:80], 0) + 1

    gaps = []
    prev = t0_ns
    for a, b in busy + [(t1_ns, t1_ns)]:
        if a > prev:
            gaps.append((a - prev, prev, a))
        prev = max(prev, b)
    gaps.sort(reverse=True)
    idle = []
    for length, a, b in gaps[:top]:
        mid = (a + b) // 2
        j = bisect.bisect_right(flat_starts, mid)
        covering = [r[2] for r in flat[max(0, j - 4096) : j] if r[1] >= mid]
        idle.append([" > ".join(dict.fromkeys(covering)) or "no traced host range", length / 1e9])
    return {
        "busy_s": busy_ns / 1e9,
        "window_s": (t1_ns - t0_ns) / 1e9,
        "range_kernel_s": range_s,
        "range_kernels": range_kernels,
        "ambiguous_kernel_s": ambiguous_s,
        "range_threads": len(by_thread),
        "launches": len(launches),
        "device_ops": [[name[:160], s] for name, s in top_ops],
        "idle_gaps": idle,
        "device_events": len(device),
    }
