"""Tokens generated during the window, of answers that reached their
client, over the window's seconds."""


def read(obs):
    return obs["answer_tokens"] / obs["window_s"]
