"""Import hygiene of the port: it imports neither JAX nor the reference.

Every ``.py`` under ``src/repro_torch/``, ``chip_smoke.py`` and the port's
scripts (those that import ``repro_torch``) are parsed with ``ast``; an
import of ``jax`` (or ``jaxlib``) or of ``repro`` / ``repro.*`` anywhere
in them — at top level or inside a function — fails. The GPU machine has
no JAX, so an import there would break the port's entry points. A fresh
interpreter then imports the port's server and entry modules and must
leave ``jax`` and ``repro`` out of ``sys.modules``; so must the cluster
layer, the workload generators, training and its launcher, the serving
launcher, the meshes, the distributed layer and the dry run with its
HLO parser.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    files += [p for p in sorted((ROOT / "scripts").glob("*.py"))
              if "repro_torch" in p.read_text()]
    return files


def _forbidden_imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for name in names:
            if name.split(".")[0] in FORBIDDEN:
                bad.append((node.lineno, name))
    return bad


def test_port_sources_found():
    files = _port_files()
    names = {p.relative_to(ROOT).as_posix() for p in files}
    for want in ("src/repro_torch/server/app.py",
                 "src/repro_torch/obs/metrics.py",
                 "src/repro_torch/api/client.py",
                 "src/repro_torch/serving/tolerance.py",
                 "src/repro_torch/serving/engine.py",
                 "src/repro_torch/serving/simulator.py",
                 "src/repro_torch/cluster/cluster_sim.py",
                 "src/repro_torch/serving/speculative.py",
                 "src/repro_torch/models/moe.py",
                 "src/repro_torch/serving/modality.py",
                 "src/repro_torch/serving/frontend.py",
                 "src/repro_torch/workload/sharegpt.py",
                 "src/repro_torch/training/train.py",
                 "src/repro_torch/training/optimizer.py",
                 "src/repro_torch/training/checkpoint.py",
                 "src/repro_torch/training/data.py",
                 "src/repro_torch/launch/train.py",
                 "src/repro_torch/launch/serve.py",
                 "src/repro_torch/launch/mesh.py",
                 "src/repro_torch/launch/dryrun.py",
                 "src/repro_torch/launch/hlo_stats.py",
                 "src/repro_torch/distributed/sharding.py",
                 "src/repro_torch/distributed/moe_ep.py", "chip_smoke.py"):
        assert want in names, want


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_reference_import(path):
    assert _forbidden_imports(path) == []


def test_checker_sees_nested_imports(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import os\n"
                 "def g():\n"
                 "    import jax.numpy as jnp\n"
                 "    from repro.core import qoe\n"
                 "    from repro_torch.core import qoe as q\n"
                 "    from . import repro\n")
    assert _forbidden_imports(f) == [(3, "jax.numpy"), (4, "repro.core")]


def test_server_import_leaves_jax_out():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    code = ("import sys\n"
            "import repro_torch.server, repro_torch.server.__main__\n"
            "import repro_torch.api, repro_torch.obs, repro_torch.serving\n"
            "import repro_torch.kernels.cuda, repro_torch.bridge\n"
            "import repro_torch.cluster, repro_torch.workload\n"
            "import repro_torch.serving.request\n"
            "import repro_torch.serving.modality\n"
            "import repro_torch.serving.frontend\n"
            "import repro_torch.training, repro_torch.launch.train\n"
            "import repro_torch.launch.serve, repro_torch.launch.mesh\n"
            "import repro_torch.distributed.sharding\n"
            "import repro_torch.distributed.moe_ep\n"
            "import repro_torch.launch.dryrun, repro_torch.launch.hlo_stats\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            f"{FORBIDDEN!r})\n"
            "print(bad)\n"
            "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, (res.stdout, res.stderr)
