#!/usr/bin/env python3
"""Time the tensor-core flash body with 4 and 8 warps per block, on one GPU.

    python3 scripts/flash_tile_sweep.py

At the llama3-8b prefill shapes (H=32, KV=8, hd=128, causal, bf16, 512
bucket) for several row counts, each warp count replaces the wrapper's
choice (`flash_plan`: 16 query rows per warp); the output is checked
against the plain version (2e-2) and timed as `chip_smoke.py` times
kernels (CUDA events, L2 flushed before each launch). The last line of
each shape is the wrapper's own choice and SDPA on the same inputs.
Needs a CUDA device; prints the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

SHAPES = ([512, 389, 200, 64], [512], [512, 512], [128], [300])


def main() -> None:
    import torch
    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels import ref
    print(cs.nvidia_smi(), flush=True)
    flush = cs._L2Flush(torch)
    sdpa = cs._sdpa(torch)
    gen = torch.Generator().manual_seed(0)
    h, kv, hd = 32, 8, 128
    plan = kc.flash_plan
    for lens in SHAPES:
        # the engine's bucket: the next power of two, at least 128
        b, s = len(lens), max(128, 1 << (max(lens) - 1).bit_length())
        q = torch.randn((b, s, h, hd), generator=gen).to("cuda", torch.bfloat16)
        k = torch.randn((b, s, kv, hd), generator=gen).to("cuda",
                                                           torch.bfloat16)
        v = torch.randn((b, s, kv, hd), generator=gen).to("cuda",
                                                           torch.bfloat16)
        lengths = torch.tensor(lens, dtype=torch.int32).cuda()
        expect = ref.attention_ref(q, k, v, causal=True, lengths=lengths)
        print(f"{b} x {s}, lengths {lens} (wrapper's choice "
              f"{plan(b, s, h)} warps)", flush=True)
        for warps in (4, 8, None):
            kc.flash_plan = plan if warps is None else (
                lambda *_, w=warps: w)

            def fn():
                return kc.flash_attention(q, k, v, causal=True,
                                          lengths=lengths)
            err = (fn().float() - expect.float()).abs().max().item()
            if err > cs.BF16_TOL:
                cs.fail(f"{warps} warps: error {err}")
            ms = cs.time_ms(torch, fn, flush)
            label = "wrapper's choice" if warps is None else f"{warps} warps"
            print(f"  {label}: {ms:.4f} ms  max|err| {err:.3e}", flush=True)
        kc.flash_plan = plan
        if sdpa is not None:
            qpos = torch.arange(s, device="cuda")
            valid = ((qpos[None, None, :] <= qpos[None, :, None])
                     & (qpos[None, None, :] < lengths[:, None, None]))
            lib = cs.time_ms(torch, lambda: sdpa(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                attn_mask=valid[:, None], enable_gqa=True), flush)
            print(f"  SDPA: {lib:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
