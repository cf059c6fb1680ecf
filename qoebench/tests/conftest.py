"""The smoke cells run the engine on the wall clock, so their tests need
the CPU's time: each takes at most two threads while it runs, and gives
them back after, so that test workers side by side do not starve one
another."""
import pytest


@pytest.fixture(autouse=True)
def _few_threads():
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)
