"""The traced window's reduction, on hand-made profiler events laid out as
the card's trace lays them out: every launch on one thread (1), so a
kernel is tied to the probe's host ranges by its launch's time alone.
Busy time is the union of device intervals inside the window, and idle
gaps are named by the ranges open across them."""

from types import SimpleNamespace

import pytest

from portbench import devtrace


class Ev:
    def __init__(self, name, start, dur, device, corr):
        self._n, self._s, self._d, self._dev, self._c = name, start, dur, device, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return SimpleNamespace(name="CUDA" if self._dev else "CPU")

    def is_user_annotation(self):
        return False

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return 1  # the card's trace names every launch's thread 1


def kernel(name, launch, start, dur, corr):
    return [Ev("cudaLaunchKernel", launch, 2, False, corr), Ev(name, start, dur, True, corr)]


def thread(native_id):
    return (native_id, native_id * 1000, native_id * 1000)


def test_busy_time_and_idle_gaps():
    events = [
        *kernel("attn_kernel", 100, 150, 100, 1),
        *kernel("gemm", 120, 200, 100, 2),  # overlaps the first: the union counts
        *kernel("gemm", 600, 700, 50, 3),
        Ev("gemm", 990, 100, True, 99),  # runs past the window's end, launched before it
    ]
    ranges = [("epoch", 300, 690, thread(5))]
    s = devtrace.summarize(events, 100, 1000, ranges)
    assert s["window_s"] == 900e-9
    assert s["busy_s"] == (300 - 150 + 750 - 700 + 1000 - 990) * 1e-9
    assert s["idle_gaps"][0] == ["epoch", 400e-9]  # 300..700 under the epoch range
    assert [op[0] for op in s["device_ops"]][0] == "gemm"


def test_a_kernel_goes_to_the_innermost_range_that_began_last():
    events = [
        *kernel("attn", 150, 160, 10, 1),  # executor thread in encoder_attention, caller in encode
        *kernel("mlp", 180, 190, 10, 2),  # scheduler thread in tick, past its attention
        *kernel("paged", 320, 330, 10, 3),  # scheduler in decode_attention, an epoch waiting on it
    ]
    ranges = [
        ("encode", 100, 200, thread(5)), ("encoder_attention", 140, 170, thread(7)),
        ("tick", 175, 400, thread(9)), ("decode_attention", 176, 178, thread(9)),
        ("epoch", 250, 900, thread(5)), ("decode_attention", 310, 340, thread(9)),
    ]
    s = devtrace.summarize(events, 0, 1000, ranges, foreign={"decode_attention": ("encode", "search")})
    assert s["range_kernel_s"] == {"encoder_attention": 10e-9, "decode_attention": 10e-9}
    # the mlp kernel: encode (another thread) ends inside the tick, so it may be the encoder's
    assert s["ambiguous_kernel_s"] == 10e-9


def test_kernels_launched_while_another_thread_works_drop_out():
    events = [
        *kernel("paged", 320, 330, 10, 1),  # another thread embeds a query across the whole range
        *kernel("paged", 512, 530, 10, 2),  # another thread's range ends inside this one
        *kernel("paged", 720, 730, 10, 3),  # nothing else open: counts
    ]
    ranges = [
        ("encode", 300, 400, thread(5)), ("decode_attention", 310, 340, thread(9)),
        ("search", 450, 515, thread(5)), ("decode_attention", 510, 540, thread(9)),
        ("decode_attention", 710, 740, thread(9)),
    ]
    s = devtrace.summarize(events, 0, 1000, ranges, foreign={"decode_attention": ("encode", "search")})
    assert s["range_kernel_s"] == {"decode_attention": 10e-9}
    assert s["ambiguous_kernel_s"] == 20e-9


def test_every_range_of_a_long_window_is_found():
    events, ranges = [], []
    for i in range(6000):
        at = 1000 * i
        ranges.append(("decode_attention", at + 10, at + 40, thread(9)))
        events += kernel("paged", at + 20, at + 50, 7, i)
    ranges.append(("tick", 0, 6000 * 1000, thread(9)))
    s = devtrace.summarize(events, 0, 6000 * 1000, ranges)
    assert s["range_kernel_s"] == {"decode_attention": pytest.approx(6000 * 7e-9)}
    assert s["ambiguous_kernel_s"] == 0.0
