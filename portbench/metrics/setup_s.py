"""Set-up seconds: building the system from the seed, filling what the
cell's traffic needs, and the warm-up, up to the window's opening."""


def read(obs):
    return obs["setup_s"]
