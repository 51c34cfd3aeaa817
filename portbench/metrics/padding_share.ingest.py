"""Padded token slots over all token slots of the window's forwards, in
percent: the forwards' shapes against the real lengths of their rows."""


def read(obs):
    window = obs["window"]
    slots = sum(b * s for _t, b, s in obs["probe"].of("forward", window))
    real = sum(sum(lens) for _t, lens in obs["probe"].of("rows", window))
    return 100.0 * (slots - real) / slots if slots else None
