"""The plain reference against the port's Model at smoke size on the CPU,
and the whole harness over the smoke cells: in float32 the tokens the
engine serves to one-token requests are the reference's first choices."""
import time

import numpy as np
import pytest
import torch

from qoebench import harness, registry, smoke, weights
from qoebench.reference.model import served_gaps


def _model(name):
    from repro_torch.models.model import Model
    cfgd = {"name": name, "source": "smoke", "model": smoke.TINY[name]}
    model = Model(harness.model_config(cfgd), device="cpu")
    params = weights.make_params(model.abstract_params(torch.float32), 11,
                                 "cpu", torch.float32)
    return cfgd["model"], model, params


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_reference_logits_match_the_ports_forward(name):
    """The reference is a causal LM; its gap of any token equals the one
    the port's full forward gives (the moe over the prompt
    alone, one call whose capacity both count the same way)."""
    cfg, model, params = _model(name)
    rng = np.random.default_rng(0)
    prompt = rng.integers(0, cfg["vocab_size"], 40).astype(np.int32)
    n_served = 1 if cfg["kind"] == "moe" else 12
    served = rng.integers(0, cfg["vocab_size"], n_served).astype(np.int32)
    seq = np.concatenate([prompt, served[:-1]])
    with torch.no_grad():
        logits, _ = model.forward_train(
            params, {"tokens": torch.as_tensor(seq)[None].long()})
    rows = logits[0, len(prompt) - 1:]
    want = (rows.max(-1).values
            - rows.gather(1, torch.as_tensor(served).long()[:, None])[:, 0])
    got = served_gaps(cfg, params,
                      [{"prompt": prompt, "served": served}],
                      device="cpu")[0]["served"]
    np.testing.assert_allclose(got, want.numpy(), atol=2e-4, rtol=0)


def test_the_fp8_control_moves_logits_more_than_rounding():
    cfg, _model_, params = _model("tiny-dense")
    rng = np.random.default_rng(1)
    req = {"prompt": rng.integers(0, 512, 60), "served": rng.integers(0, 512,
                                                                      30)}
    out = served_gaps(cfg, params, [req], quant="fp8",
                      device="cpu")[0]
    assert out["served"].shape == out["control"].shape == (30,)
    assert (out["control"] >= 0).all()


def run_smoke_cell(tmp_path, cell, seconds=4.0, **kw):
    from qoebench.cell import run_cell
    bench = smoke.write_base(tmp_path, **kw)
    entry = registry.workload(bench, cell)
    return run_cell(bench, entry, 2**31 + 5, seconds, False, device="cpu",
                    t_start=time.monotonic(), base=tmp_path)


def _closed_loop(record, clients=4):
    """Each client's first request due at 0, each next one at a finish."""
    dues = sorted(r["due"] for r in record["requests"])
    assert dues[:clients] == [0.0] * clients
    fin = {r["finish"] for r in record["requests"]}
    assert all(d in fin for d in dues[clients:])
    assert len(dues) == clients + sum(f is not None for f in fin)


@pytest.mark.parametrize("cell", ["tiny-dense.score", "tiny-moe.score"])
def test_harness_serves_what_the_reference_would(tmp_path, cell):
    result, record = run_smoke_cell(tmp_path, cell, seconds=6.0)
    assert result["correct"], result
    assert result["checks"]["widest_gap"]["value"] < 1e-3
    assert record["check"]["requests"] == 8
    assert record["check"]["tokens"] == 8
    assert all(r["output_len"] == 1 for r in record["requests"])
    _closed_loop(record)
    assert set(result["metrics"]) == {"tokens_per_s", "setup_s"}
    assert list(result)[-1] == "checks"
    assert record["tick_sleep_s"] >= 0.0


@pytest.mark.parametrize("cell", ["tiny-dense.chat", "tiny-moe.burst",
                                  "tiny-dense.batch"])
def test_harness_drives_and_judges_the_decoding_mixes(tmp_path, cell):
    """The decoding mixes run end to end and their served tokens, many to
    a request, reach the check, whose verdict is its widest gap against
    its limit."""
    closed = cell.endswith(".batch")
    result, record = run_smoke_cell(tmp_path, cell,
                                    seconds=6.0 if closed else 4.0)
    check = record["check"]
    assert check["requests"] >= 1
    assert check["tokens"] > check["requests"]
    assert result["correct"] == (result["checks"]["widest_gap"]["value"]
                                 <= result["checks"]["widest_gap"]["limit"])
    if closed:
        _closed_loop(record)
    else:
        assert result["attempted"] == round(2.0 * 4.0)
    assert set(result["metrics"]) == {"tokens_per_s", "setup_s"}


@pytest.mark.parametrize("name,plen", [("tiny-dense", 63), ("tiny-dense", 64),
                                       ("tiny-dense", 9), ("tiny-moe", 40)])
def test_the_ports_batch1_path_is_the_references(name, plen):
    """The port's own batch-1 path (the prompt prefilled at its length,
    then one decode step per served token at the next position) picks the
    reference's first choice at every position, whether or not the prompt
    fills a power of two."""
    from qoebench.readings import batch1_choices
    cfg, model, params = _model(name)
    cfgd = {"dtype": "float32", "model": cfg, "serving": {"max_seq": 256}}
    rng = np.random.default_rng(plen)
    prompt = rng.integers(0, cfg["vocab_size"], plen).astype(np.int32)
    served = rng.integers(0, cfg["vocab_size"], 24).astype(np.int32)
    choices = batch1_choices(model, params, cfgd, prompt, served)
    got = served_gaps(cfg, params, [{"prompt": prompt, "served": served,
                                     "judge": choices}],
                      device="cpu")[0]["served"]
    assert float(got.max()) < 1e-4
