"""Rows per call of the encoder's ``encode`` in the window: how full the
micro-batcher makes each batch."""


def read(obs):
    calls = obs["probe"].of("encode", obs["window"])
    return sum(len(texts) for _t, texts, _v in calls) / len(calls) if calls else None
