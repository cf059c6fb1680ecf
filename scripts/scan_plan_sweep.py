#!/usr/bin/env python3
"""Time the selective-scan kernel under fixed launch plans, on one GPU.

    python3 scripts/scan_plan_sweep.py

For the falcon-mamba-7b prefill shape (rows of a 512 bucket, d_inner 8192,
N 16, B and C as column slices of the x_proj output) and the zamba2-2.7b
Mamba-2 prefill mapped onto the scan (`ops.ssd_channel_args`: 80 heads of 64
channels, D 5120, N 64) at 1 x 512 (the engine's usual prefill group) and
at B=4 with ragged lengths, each
(states per thread, steps per chunk) the kernel takes replaces the
wrapper's plan (`scan_plan`); each variant is checked against the plain
version (bf16 2e-2 and f32 1e-5 relative to max |y|, the final state
1e-4) and timed in bf16 with the final state as `chip_smoke.py` times it
(CUDA events, L2 flushed before each launch). Each shape ends with the
wrapper's own plan and the bound. Needs a CUDA device; prints the card's
name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

def mamba2_inputs(torch, gen, lengths, dtype):
    """zamba2's Mamba-2 inputs as the scan kernel receives them."""
    from repro_torch.kernels import ops
    return ops.ssd_channel_args(*cs.ssd_inputs(torch, gen, lengths, dtype))


SHAPES = [(make, lengths) for make in (cs.scan_inputs, mamba2_inputs)
          for lengths in ([512], [512, 389, 200, 64])]


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels import ref
    print(cs.nvidia_smi(), flush=True)
    flush = cs._L2Flush(torch)
    gen = torch.Generator().manual_seed(0)
    plan = kc.scan_plan
    for make, lengths in SHAPES:
        cases = []
        for dtype, tol in ((torch.float32, cs.F32_SCAN_TOL),
                           (torch.bfloat16, cs.BF16_TOL)):
            args = make(torch, gen, lengths, dtype)
            cases.append((dtype, tol, args,
                          ref.selective_scan_with_state_ref(*args)))
        b, s, d = args[0].shape
        n = args[3].shape[-1]
        b_ms, b_by, _ = cs.scan_bound(torch, b, s, d, n)
        print(f"B={b} S={s} D={d} N={n}, lengths {lengths}; bound "
              f"{b_ms:.4f} ms ({b_by}); wrapper's plan {plan(b, s, d, n)}",
              flush=True)
        variants = [(p, t) for p in kc.scan_npl_options(n)
                    for t in sorted(kc.SCAN_STEPS)]
        for variant in variants + [None]:
            kc.scan_plan = (plan if variant is None else
                            (lambda b_, s_, d_, n_, *_, v=variant: kc.ScanPlan(
                                v[0], v[1], (-(-d_ // 32), b_),
                                32 * n_ // v[0])))
            errs = []
            for dtype, tol, a, (y_ref, h_ref) in cases:
                y, h = kc.selective_scan(*a, return_state=True)
                errs.append((cs.rel_err(y, y_ref), cs.rel_err(h, h_ref)))
                if not (errs[-1][0] <= tol and errs[-1][1] <= cs.STATE_TOL):
                    cs.fail(f"plan {variant}, {dtype}: relative error "
                            f"{errs[-1]}")
            ms = cs.time_ms(torch, lambda: kc.selective_scan(
                *args, return_state=True), flush)
            label = ("wrapper's plan" if variant is None else
                     f"{variant[0]} states per thread, {variant[1]} steps")
            print(f"  {label}: {ms:.4f} ms ({ms / b_ms:.2f}x bound)  "
                  f"relative y/h err f32 {errs[0][0]:.2e}/{errs[0][1]:.2e}"
                  f"  bf16 {errs[1][0]:.2e}/{errs[1][1]:.2e}", flush=True)
        kc.scan_plan = plan


if __name__ == "__main__":
    main()
