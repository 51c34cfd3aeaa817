"""The share of the traced window in which no operation ran on the card,
in percent."""


def read(obs):
    trace = obs["trace"]
    if not trace or not trace["window_s"]:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
