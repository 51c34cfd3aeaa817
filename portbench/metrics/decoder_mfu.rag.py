"""Model FLOPs of the prefill and decode tokens the decoder processed in
the window (real tokens only, attention over each one's context), over
the window's seconds and the card's bf16 peak, in percent."""

from portbench import arith


def read(obs):
    cfg, probe, window = obs["config"], obs["probe"], obs["window"]
    prefill = probe.of("prefill", window)
    decode = probe.of("decode_step", window)
    if not prefill and not decode:
        return None
    flops = 0.0
    for _t, chunks in prefill:
        for n, start in chunks:
            flops += sum(arith.decoder_token_flops(cfg, start + j + 1, logits=(j == n - 1)) for j in range(n))
    for _t, contexts, _live in decode:
        flops += sum(arith.decoder_token_flops(cfg, c, logits=True) for c in contexts)
    return 100.0 * flops / obs["window_s"] / arith.PEAK_BF16_FLOPS
