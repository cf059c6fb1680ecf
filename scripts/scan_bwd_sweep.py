#!/usr/bin/env python3
"""Time the selective-scan backward kernel's cluster size and what its dB /
dC sum over lanes costs, on one GPU.

    python3 scripts/scan_bwd_sweep.py

The shapes are 13a's of `chip_smoke.py`: falcon-mamba-7b's Mamba-1 (8 x
512, D 8192, N 16) on the Mamba-1 body and zamba2-2.7b's Mamba-2 (8 x 512,
NH 80, HD 64, N 64, A per channel) on the Mamba-2 body, f32 and bf16. The
kernel as built runs with 8 (its own), 4, 2 and 1 channel blocks a
thread-block cluster (`kernels/cuda.py:scan_bwd_cluster` replaced; the dB
/ dC partials grow as the cluster shrinks). "no butterfly" is a
diagnostic, not a candidate: a copy of `csrc/selective_scan_bwd.cu`
without the warp's transposing sum of its dB / dC values, built by nvcc
into `build/scan_bwd_sweep/`, whose dB and dC are wrong, to show what that
sum costs. Each run is checked against the plain version (f32) or the
kernel at 8 blocks a cluster (bf16), relative to each gradient's max
magnitude, and timed as `chip_smoke.py` times it (CUDA events, L2 flushed
before each launch). Prints the card's name and power limit.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

OUT = ROOT / "build" / "scan_bwd_sweep"
BUTTERFLY = "warp_transpose_sum<2 * NPL, 16>(v, lane);"


def build_no_butterfly(build, kc):
    """The diagnostic copy's ctypes entry point."""
    src = (build.CSRC / "selective_scan_bwd.cu").read_text()
    if src.count(BUTTERFLY) != 1:
        cs.fail(f"{BUTTERFLY!r} is not once in the source")
    OUT.mkdir(parents=True, exist_ok=True)
    path, lib = OUT / "no_butterfly.cu", OUT / "libno_butterfly.so"
    path.write_text(src.replace(BUTTERFLY, ""))
    done = subprocess.run([build.nvcc(), *build.FLAGS, "-I", str(build.CSRC),
                           "-o", str(lib), str(path)], capture_output=True,
                          text=True)
    if done.returncode:
        cs.fail(f"the diagnostic copy did not build:\n{done.stderr[-4000:]}")
    f = ctypes.CDLL(str(lib)).selective_scan_bwd
    f.argtypes = kc._SIGS["selective_scan_bwd"]
    f.restype = ctypes.c_int
    return f


def rel_errs(got, want):
    return max(((g.float() - w.float()).abs().max()
                / w.float().abs().max().clamp_min(1e-30)).item()
               for g, w in zip(got, want))


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import build, ops, ref
    from repro_torch.kernels import cuda as kc
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.nvidia_smi(), flush=True)
    build.build_all()
    built, cluster = kc._fn("selective_scan_bwd"), kc.scan_bwd_cluster
    runs = [(f"as built, {cl} blocks a cluster", built, cl)
            for cl in (8, 4, 2, 1)]
    runs.append(("no butterfly (diagnostic)", build_no_butterfly(build, kc),
                 8))
    flush = cs._L2Flush(torch)
    gen = torch.Generator().manual_seed(2)
    for dt in (torch.float32, torch.bfloat16):
        for label, kind in (("falcon-mamba Mamba-1 8 x 512", "mamba1"),
                            ("zamba2 Mamba-2 8 x 512", "mamba2")):
            if kind == "mamba1":
                args = cs.scan_inputs(torch, gen, [512] * 8, dt)
            else:
                args = ops.ssd_channel_args(
                    *cs.ssd_inputs(torch, gen, [512] * 8, dt))
            _, states, plan = kc.selective_scan(*args, save_states=True)
            dy = torch.randn(args[0].shape, generator=gen).to("cuda", dt)
            want = (ref.selective_scan_bwd_ref(*args, dy)
                    if dt == torch.float32 else None)
            print(f"{label}, {str(dt)[6:]}, {kind} body (forward plan "
                  f"{plan.steps} steps per chunk):", flush=True)
            for name, f, cl in runs:
                kc._fns["selective_scan_bwd"] = f
                kc.scan_bwd_cluster = lambda d, cl=cl: min(
                    cl, cluster(d))
                try:
                    got = kc.selective_scan_bwd(*args, states, dy, plan)
                    torch.cuda.synchronize()
                    if want is None:
                        want = got
                    err = rel_errs(got, want)
                    ms = cs.time_ms(torch, lambda: kc.selective_scan_bwd(
                        *args, states, dy, plan), flush)
                finally:
                    kc._fns["selective_scan_bwd"] = built
                    kc.scan_bwd_cluster = cluster
                print(f"  {name}: {ms:.4f} ms, max|err|/max|grad| "
                      f"{err:.2e}", flush=True)
            del args, states, dy, want


if __name__ == "__main__":
    main()
