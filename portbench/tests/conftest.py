"""Tests of the benchmark itself.  ``card`` marks a test that needs the
NVIDIA card; its ``card`` fixture skips it elsewhere."""

import pytest


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs an NVIDIA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: run `python -m pytest portbench/tests -m card` on the chip")
    return torch.device("cuda")


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory):
    from portbench.tests import tiny

    root = tmp_path_factory.mktemp("tinybench")
    bench = tiny.make(root)
    return root, bench
