#!/usr/bin/env python3
"""Time the split-KV decode kernels under fixed chunk sizes, on one GPU.

    python3 scripts/decode_plan_sweep.py

For the llama3-8b decode shape (H=32, KV=8, hd=128, cache depth 1024,
bf16) at B=8 with ragged lengths and at B=1 with the full depth, each
chunk size in CHUNKS replaces the wrapper's plan (`decode_plan`); the
contiguous and the paged (page 16) kernels are checked against the plain
version (2e-2) and against each other (bitwise), then timed as
`chip_smoke.py` times them (CUDA events, L2 flushed before each launch).
The last line compares with the wrapper's own plan and SDPA on the same
inputs. Needs a CUDA device; prints the card's name and power limit.
"""
from __future__ import annotations

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

CHUNKS = (16, 32, 48, 64, 96, 112)


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
    h, kv, hd, s = 32, 8, 128, 1024
    plan = kc.decode_plan
    for b in (8, 1):
        lengths = torch.randint(1, s + 1, (b,), generator=gen).to(torch.int32)
        lengths[0] = s
        lengths = lengths.cuda()
        q = torch.randn((b, h, hd), generator=gen).to("cuda", torch.bfloat16)
        k = torch.randn((b, s, kv, hd), generator=gen).to("cuda",
                                                           torch.bfloat16)
        v = torch.randn((b, s, kv, hd), generator=gen).to("cuda",
                                                           torch.bfloat16)
        kp, vp, bt = cs._paginate(torch, k, v, lengths, 16, gen)
        expect = ref.decode_attention_ref(q, k, v, lengths)
        print(f"B={b} lengths {lengths.tolist()} (default plan "
              f"{plan(s, b, kv, hd, 2)})", flush=True)
        for chunk in CHUNKS + (None,):
            kc.decode_plan = (plan if chunk is None else
                              (lambda cap, *_, c=chunk: (c, -(-cap // c))))
            out = kc.decode_attention(q, k, v, lengths)
            pout = kc.paged_decode_attention(q, kp, vp, bt, lengths)
            err = (out.float() - expect.float()).abs().max().item()
            if err > cs.BF16_TOL or not torch.equal(out, pout):
                cs.fail(f"chunk {chunk}: error {err} or paged != contiguous")
            ms = cs.time_ms(torch, lambda: kc.decode_attention(q, k, v,
                                                                lengths),
                            flush)
            pms = cs.time_ms(torch, lambda: kc.paged_decode_attention(
                q, kp, vp, bt, lengths), flush)
            label = "wrapper's plan" if chunk is None else f"chunk {chunk}"
            print(f"  {label}: decode {ms:.4f} ms  paged16 {pms:.4f} ms  "
                  f"max|err| {err:.3e}", flush=True)
        kc.decode_plan = plan
        if sdpa is not None:
            mask = torch.arange(s, device="cuda")[None, :] < lengths[:, None]
            qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
            lib = cs.time_ms(torch, lambda: sdpa(
                qs, ks, vs, attn_mask=mask[:, None, None, :],
                enable_gqa=True), flush)
            print(f"  SDPA: {lib:.4f} ms", flush=True)


if __name__ == "__main__":
    main()
