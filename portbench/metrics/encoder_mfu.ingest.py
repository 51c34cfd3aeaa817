"""Model FLOPs of the window's forwards, counted over each row's real
length (``portbench/arith.py``), over the window's seconds and the
card's bf16 peak, in percent."""

from portbench import arith


def read(obs):
    cfg = obs["config"]
    rows = obs["probe"].of("rows", obs["window"])
    if not rows:
        return None
    flops = sum(arith.bert_sequence_flops(n, cfg["hidden_size"], cfg["num_hidden_layers"], cfg["intermediate_size"])
                for _t, lens in rows for n in lens)
    return 100.0 * flops / obs["window_s"] / arith.PEAK_BF16_FLOPS
