"""The least time for the paged attention of the window's decode steps
(the live K/V pages read once, each row's query read and output written
once, or the FLOPs, whichever bound is longer) over the device time of
the kernels launched inside the program's paged-attention calls of those
steps, in percent."""

from portbench import arith


def read(obs):
    cfg = obs["config"]
    trace = obs["trace"] or {}
    kernel_s = trace.get("range_kernel_s", {}).get("decode_attention")
    steps = obs["probe"].of("decode_step", obs["window"])
    if not kernel_s or not steps:
        return None
    least = sum(arith.roofline_s(arith.decode_attention_flops(cfg, ctx),
                                 arith.decode_attention_bytes(cfg, live, len(ctx)))
                for _t, ctx, live in steps if ctx)
    return 100.0 * least / kernel_s
