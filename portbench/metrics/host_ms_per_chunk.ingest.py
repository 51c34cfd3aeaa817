"""Host milliseconds inside the runner's epochs in the window, per chunk
indexed in the window."""


def read(obs):
    epochs = obs["probe"].of("epoch", obs["window"])
    n = len(obs["probe"].of("index_add", obs["window"]))
    return 1e3 * sum(dt for _t, dt in epochs) / n if epochs and n else None
