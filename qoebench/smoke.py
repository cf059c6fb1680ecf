"""A smoke-size copy of the benchmark's layout, for rehearsals and tests
on the CPU: tiny dense and moe configurations with the real cells'
serving settings scaled down, the real traffic mixes at a low rate, the
real metric files, written into a folder of their own. The tiny models'
projections are drawn five times wider than the real ones' (std 0.1), so
that at two layers their greedy tokens depend on the context, as a
full-width model's do. The tiny moe routes every token to all 4 of its
experts, so no expert's capacity is ever reached: it checks the routed
and shared arithmetic and the exact-length prefill, not drops."""
from __future__ import annotations

import json
import shutil
from pathlib import Path

from qoebench import registry

TINY = {
    "tiny-dense": {
        "kind": "dense", "num_layers": 2, "d_model": 512, "num_heads": 8,
        "num_kv_heads": 2, "head_dim": 64, "d_ff": 1024, "vocab_size": 512,
        "tie_embeddings": False, "qkv_bias": False, "gated_mlp": True,
        "norm_eps": 1e-05, "rope_theta": 10000.0},
    "tiny-moe": {
        "kind": "moe", "num_layers": 2, "d_model": 512, "num_heads": 4,
        "num_kv_heads": 4, "head_dim": 128, "d_ff": 256, "vocab_size": 512,
        "tie_embeddings": False, "qkv_bias": True, "gated_mlp": True,
        "norm_eps": 1e-06, "rope_theta": 1000000.0,
        "moe": {"num_experts": 4, "num_shared_experts": 1, "top_k": 4,
                "d_expert": 256, "capacity_factor": 1.25}},
}


RATE, LEAD_IN_S, POOL_TOKENS, LIMIT = 2.0, 1.0, 4096, 1e-3


def _cell_file(dest: Path, cell: str) -> None:
    (dest / "cells" / f"{cell}.json").write_text(json.dumps(
        {"check": {"sample": 8, "preempted": 2, "widest_gap_limit": LIMIT}}))


def write_base(dest: Path) -> dict:
    """Fill `dest` with configs, traffic, cells and metrics of the smoke
    cells (``tiny-dense.score`` and ``tiny-moe.score``, one-token requests
    from a closed loop; ``tiny-dense.chat``, ``tiny-moe.burst`` and the
    closed loop ``tiny-dense.batch``, which decode); returns their
    BENCHMARK dict (the real end-to-end and per-layer entries)."""
    dest = Path(dest)
    for folder in ("configs", "traffic", "cells"):
        (dest / folder).mkdir(parents=True, exist_ok=True)
    shutil.copytree(registry.HERE / "metrics", dest / "metrics",
                    dirs_exist_ok=True)
    real = json.loads((registry.HERE.parent / "BENCHMARK.json").read_text())
    cells = []

    def add(cell, config, mix):
        _cell_file(dest, cell)
        cells.append({"name": cell, "config": config, "traffic": mix,
                      "chips": 1, "why": "smoke"})

    for name, model in TINY.items():
        cfg = {"name": name, "source": "smoke", "reduced": [],
               "model": model, "dtype": "float32", "weights_std": 0.1,
               "serving": {"num_slots": 8, "max_seq": 2048, "page_size": 16,
                           "preemption": "swap", "scheduler": "andes",
                           "pool_tokens": POOL_TOKENS}}
        (dest / "configs" / f"{name}.json").write_text(json.dumps(cfg))
        mix = "chat" if model["kind"] == "dense" else "burst"
        t = registry.traffic(mix)
        t.update(rate=RATE, lead_in_s=LEAD_IN_S)
        (dest / "traffic" / f"{mix}.json").write_text(json.dumps(t))
        add(f"{name}.{mix}", name, mix)
        add(f"{name}.score", name, "score")
    # no lead-in: the first wave is due inside the window however slowly
    # the CPU serves it
    for mix, per in (("batch", 16), ("score", 64)):
        t = dict(registry.traffic(mix), clients=4, per_client=per,
                 lead_in_s=0.0)
        (dest / "traffic" / f"{mix}.json").write_text(json.dumps(t))
    add("tiny-dense.batch", "tiny-dense", "batch")
    # every smoke cell reports every metric: the real cells' lists name
    # real cells
    strip = [{k: v for k, v in m.items() if k != "workloads"}
             for m in real["end_to_end"] + real["per_layer"]]
    n = len(real["end_to_end"])
    return {"workloads": cells, "end_to_end": strip[:n],
            "per_layer": strip[n:]}
