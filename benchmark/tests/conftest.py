"""The benchmark's CPU tests: small sizes, one torch thread a process."""

import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def few_threads():
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(old)


@pytest.fixture
def small_towers(monkeypatch):
    from benchmark.tests import tiny

    tiny.patch_towers(monkeypatch)
