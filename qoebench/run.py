"""Run one cell of the benchmark once and print its result line.

    python -m qoebench.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (BENCHMARK.json names the cells). The last
line of standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device`` and, when traced,
``breakdown``; ``checks`` comes last, each compared number beside its
limit, as do the last lines of standard error. The run exits non-zero and
prints no result when the card is missing, when the port cannot be
imported, or when JAX or the JAX package was loaded.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; the port importable;
    libraries kept from loading JAX by themselves."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"
    src = str(ROOT / "src")
    if src not in sys.path:
        sys.path.insert(0, src)


def forbidden_modules(names=None) -> list:
    """Loaded modules (`names`, default ``sys.modules``) whose top-level
    name is JAX's or the JAX package's (whole names: ``repro_torch`` is
    not ``repro``)."""
    tops = {name.split(".", 1)[0] for name in list(names or sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--record", default=None,
                    help="also write the run's record (JSON) to this path")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    _environment()
    from qoebench import harness, registry
    bench = registry.benchmark(ROOT)
    entry = registry.workload(bench, args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(entry["chips"]):
        harness.log(f"needs {entry['chips']} CUDA device(s); found "
                    f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        harness.log(f"the port is not importable: {e}")
        return 2
    from qoebench.cell import run_cell
    result, record = run_cell(bench, entry, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    if args.record:
        Path(args.record).parent.mkdir(parents=True, exist_ok=True)
        Path(args.record).write_text(json.dumps(record))
    bad = forbidden_modules()
    if bad:
        harness.log(f"loaded in this process: {', '.join(bad)}; refusing "
                    "to report")
        return 3
    for name, c in result["checks"].items():
        harness.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    code = main()
    sys.stdout.flush()
    sys.stderr.flush()
    # leave without the interpreter's teardown: the profiler's CUDA
    # tracing library can crash there after a traced run has reported
    os._exit(code)
