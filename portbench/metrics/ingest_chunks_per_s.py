"""Chunks the index took during the window, over the window's seconds."""


def read(obs):
    return obs["chunks_indexed"] / obs["window_s"]
