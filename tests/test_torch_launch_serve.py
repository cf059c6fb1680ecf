"""The port's serving launcher against the JAX reference's (CPU).

- ``--mode sim`` (150 requests at 6 req/s over 20000 KV tokens, so
  requests are preempted): the port's report equals, character for
  character, what the reference's ``run_sim`` prints for the namespace
  the port's parser makes, ``dataset="sharegpt"`` by default (the
  reference's parser defines no ``--dataset``, so its own ``--mode sim``
  raises); ``--dataset multiround`` likewise.
- ``--mode engine --arch llama3-8b --smoke --requests 8 --device cpu``,
  run as ``python -m repro_torch.launch.serve``: its engine line equals
  the reference CLI's line for the same flags exactly (the virtual clock
  depends on lengths and batch composition only; EOS is off).
- Without ``--device`` on a machine with no card, ``--mode engine``
  raises ``resolve_device``'s error: the launcher never falls back to
  the CPU.

The reference runs in subprocesses with ``JAX_PLATFORMS=cpu``.
"""
import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.launch import serve

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
SIM = ["--requests", "150", "--rate", "6", "--kv-capacity", "20000"]
ENGINE = ["--mode", "engine", "--arch", "llama3-8b", "--smoke",
          "--requests", "8"]

REFERENCE_SIM = r"""
import argparse, json, sys
from repro.launch.serve import run_sim
run_sim(argparse.Namespace(**json.loads(sys.argv[1])))
"""


def _env():
    return dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                JAX_PLATFORMS="cpu")


def _reference(code_args):
    out = subprocess.run([sys.executable, *code_args], capture_output=True,
                         text=True, env=_env(), timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


@pytest.mark.parametrize("dataset", [None, "multiround"])
def test_sim_report_equals_reference(monkeypatch, dataset):
    """The port's parser's namespace (``--dataset`` defaulting to
    sharegpt) through both packages' ``run_sim``."""
    args = SIM + (["--dataset", dataset] if dataset else [])
    ns = {}
    run_sim = serve.run_sim
    monkeypatch.setattr(serve, "run_sim", lambda a: ns.update(vars(a)))
    serve.main(["--mode", "sim", *args])
    assert ns["dataset"] == (dataset or "sharegpt")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        run_sim(argparse.Namespace(**ns))
    got = buf.getvalue()
    want = _reference(["-c", REFERENCE_SIM, json.dumps(ns)])
    assert got == want
    assert got.startswith("scheduler=andes rate=6.0 n=150\n")
    preempt = float(got.split("preemptions")[1].split()[0])
    assert preempt > 0           # the capacity is tight enough to preempt


def test_engine_line_equals_reference_cli():
    got = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", *ENGINE,
         "--device", "cpu"],
        capture_output=True, text=True, env=_env(), timeout=300, cwd=ROOT)
    assert got.returncode == 0, got.stderr[-3000:]
    want = _reference(["-m", "repro.launch.serve", *ENGINE])
    line = [ln for ln in got.stdout.splitlines() if ln.startswith("engine:")]
    want_line = [ln for ln in want.splitlines() if ln.startswith("engine:")]
    assert line == want_line and len(line) == 1
    assert line[0].startswith("engine: 8/8 finished")


def test_engine_without_device_takes_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default takes it")
    with pytest.raises(RuntimeError, match="no CUDA device is available"):
        serve.main(ENGINE)
