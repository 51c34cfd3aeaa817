"""``import pathway_tpu_torch.universes`` — module-path parity with the
reference's ``pathway/universes.py``."""

from pathway_tpu_torch.internals.universes import *  # noqa: F401,F403
