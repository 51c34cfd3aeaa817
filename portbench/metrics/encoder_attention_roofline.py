"""The least time the card could take for the window's encoder-attention
calls (FLOPs at the bf16 peak or bytes at HBM bandwidth, whichever is
longer, from each call's shape) over the device time of the kernels
launched inside those calls, in percent."""

from portbench import arith


def read(obs):
    trace = obs["trace"] or {}
    kernel_s = trace.get("range_kernel_s", {}).get("encoder_attention")
    calls = obs["probe"].of("attention", obs["window"])
    if not kernel_s or not calls:
        return None
    least = sum(arith.roofline_s(arith.encoder_attention_flops(B, S, H), arith.encoder_attention_bytes(B, S, H))
                for _t, B, S, H in calls)
    return 100.0 * least / kernel_s
