"""On the card: the control (the reference in fp8, put in the program's
place) fails each cell's limit, and the program passes it, on three
seeds each, at the cell's own size and load over a short window. Skips
where there is no CUDA device; run on the chip with

    PYTHONPATH=src python -m pytest -q -m cuda qoebench/tests
"""
import pytest

from qoebench import harness, registry

SEEDS = (2**31 + 101, 2**31 + 202, 2**31 + 303)


@pytest.fixture
def card():
    import gc
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cells run the port's CUDA "
                    "kernels, which have no CPU mode")
    yield torch
    # one cell's engine (its KV pool) leaves the card before the next's
    gc.collect()
    torch.cuda.empty_cache()


def _cells():
    b = registry.benchmark(registry.HERE.parent)
    return [w["name"] for w in b["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", _cells())
def test_control_fails_and_program_passes_the_limit(card, cell):
    from qoebench.session import Session
    s = Session(cell, SEEDS[0])
    limit = s.check["widest_gap_limit"]
    for seed in SEEDS:
        rec = s.window(seed, 10.0)
        sample = harness.sample_served(rec, s.check, seed)
        res = harness.check_served(s.cfgd, s.params, sample, "cuda",
                                   quant="fp8")
        assert res["requests"] >= 2
        assert res["widest_gap"] <= limit, res
        assert res["control_widest_gap"] > limit, res
