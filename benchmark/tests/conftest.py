"""Settings of the benchmark's own tests (``python -m pytest
benchmark/tests``): the marker of the tests that need the card, which
skip themselves without one."""

import torch

torch.set_num_threads(2)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device; skips itself without one")
