"""One torch thread for the port's CPU tests.

The driver runs the suite in six worker processes on one host: with
torch's default of one OpenMP thread per core in every worker, the
workers' threads spin against each other, and the port's tests take
several times their single-process time. Each port test module imports
`one_torch_thread`, an autouse fixture that runs the module on one torch
thread and gives the previous count back after it (the JAX package's
modules, which may share the worker, keep theirs)."""

import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def test_the_module_runs_on_one_torch_thread():
    assert torch.get_num_threads() == 1
