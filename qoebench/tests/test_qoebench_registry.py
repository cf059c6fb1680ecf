"""Everything is found by name, and BENCHMARK.json keeps to the shape the
harness and its checker read."""
import json
import re

import pytest

from qoebench import registry

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_a_dropped_in_config_mix_cell_and_metric_are_found(tmp_path):
    for folder in ("configs", "traffic", "cells", "metrics"):
        (tmp_path / folder).mkdir()
    (tmp_path / "configs" / "dummy-model.json").write_text(
        json.dumps({"name": "dummy-model", "model": {"num_layers": 1}}))
    (tmp_path / "traffic" / "trickle.json").write_text(
        json.dumps({"name": "trickle", "rate": 0.5}))
    (tmp_path / "cells" / "dummy-model.trickle.json").write_text(
        json.dumps({"check": {"sample": 1}}))
    (tmp_path / "metrics" / "steps.total.py").write_text(
        'NAME = "steps.total"\nUNIT = "1"\nLAYER = "engine loop"\n'
        '\n\ndef read(record):\n'
        '    return record.get("steps")\n')
    assert registry.config("dummy-model", tmp_path)["model"] == {
        "num_layers": 1}
    assert registry.traffic("trickle", tmp_path)["rate"] == 0.5
    assert registry.cell("dummy-model.trickle", tmp_path)["check"] == {
        "sample": 1}
    m = registry.metric("steps.total", tmp_path)
    assert (m.NAME, m.UNIT, m.LAYER) == ("steps.total", "1", "engine loop")
    # a quantity split by what it moves in each cell has one reader
    assert registry.metric("steps.total.serve", tmp_path) is not None
    got = registry.read_metrics(
        [{"name": "steps.total.serve", "unit": "1"}], {"steps": 7}, tmp_path)
    assert got == {"steps.total.serve": {"value": 7.0, "unit": "1"}}
    with pytest.raises(FileNotFoundError):
        registry.metric("steps", tmp_path)
    got = registry.read_metrics(
        [{"name": "steps.total", "unit": "1"}], {"steps": 7}, tmp_path)
    assert got == {"steps.total": {"value": 7.0, "unit": "1"}}
    # a reader with nothing to read leaves its metric out
    assert registry.read_metrics(
        [{"name": "steps.total", "unit": "1"}], {}, tmp_path) == {}
    with pytest.raises(FileNotFoundError):
        registry.config("absent", tmp_path)


def _bench():
    return registry.benchmark(registry.HERE.parent)


def test_benchmark_names_units_and_files():
    b = _bench()
    assert b["paths"] == ["qoebench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    names += [w["name"] for w in b["workloads"]]
    names += [c["name"] for c in b["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert "setup_s" in {m["name"] for m in b["end_to_end"]}
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        mod = registry.metric(m["name"])
        assert (mod.UNIT, mod.LAYER) == (m["unit"], m["layer"])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    for c in b["configs"]:
        cfg = registry.config(c["name"])
        assert c["file"] == f"qoebench/configs/{c['name']}.json"
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
    for w in b["workloads"]:
        assert w["chips"] == 1
        assert len(w["why"]) <= 200
        registry.config(w["config"])
        registry.traffic(w["traffic"])
        assert registry.cell(w["name"])["check"]["widest_gap_limit"] > 0
        assert registry.per_layer_for(b, w["name"])


def test_the_no_jax_check_compares_whole_top_level_names():
    from qoebench.run import forbidden_modules
    port = ["torch", "repro_torch", "repro_torch.serving.engine", "numpy"]
    assert forbidden_modules(port) == []
    assert forbidden_modules(port + ["repro.core.qoe"]) == ["repro"]
    assert forbidden_modules(port + ["jax._src.api", "jaxlib", "flax"]) == \
        ["flax", "jax", "jaxlib"]
