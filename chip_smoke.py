#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's three main paths — the Andes serving engine over the
full-width, full-depth Llama-3-8B, Falcon-Mamba-7B and Zamba2-2.7B configs
with random bf16 weights made from a seed — the HTTP/SSE server over the
Llama-3-8B engine on the wall clock, and the cluster layer over
engine-backed Llama-3-8B replicas, and holds every hand-written CUDA
kernel on those paths against its plain PyTorch version. Phases, in
order:

1. the device: name and power limit from nvidia-smi;
2. build the CUDA kernels (one nvcc per source, in parallel), and count
   the tensor-core instructions (HGMMA/HMMA) in each library's SASS: the
   flash library must have some;
3. each kernel against its plain version at the main path's shapes, with
   its time, the plain version's time, the time of one PyTorch library
   call computing the same function where there is one (SDPA; a yardstick
   only, the port never calls it) and the least time the card could take
   (bytes over the HBM rate against operations over their peak rate:
   bf16 tensor-core FLOPs for attention; f32 FLOPs and SFU exponentials
   for the scan). Attention in bf16 (tolerance 2e-2 absolute); the
   selective scan in bf16 (2e-2 relative to max |y|, final state 1e-4)
   and once in f32 (1e-5). Also timed: flash and the scan at 1 x 512 (the
   engine's usual prefill group; flash beside SDPA) and decode at B=1,
   each beside its bound, the scan with the launch plan it took; the
   paged kernel must equal the contiguous one bitwise. At zamba2's shapes:
   flash (1 x 512) and decode (B=8, depth 1024) with H = KV = 32, hd 80,
   beside SDPA, and the scan through Mamba-2's mapping
   (`ops.ssd_with_state`: NH 80, HD 64, N 64, 1 x 512 and B=4 ragged)
   against the plain Mamba-2 recurrence in f32 and bf16, timed beside the
   function's bound and the kernel's exponential bound;
4. the smoke-size engines on the card against the same engines on the CPU
   (plain versions), f32, with a capacity that forces preemption: llama3
   over the contiguous cache and the page pool, falcon-mamba and zamba2
   in swap and in recompute mode. Identical virtual timing and tokens identical up to
   documented near-ties — the repo's differential check on a small input;
5. the full-width llama3-8b engine, twice: over the physical page pool
   (page 16, paged decode kernel) and over the contiguous cache (decode
   kernel), with the launch counters set to 0 before and read after. Both
   runs must finish every request with its full output, share one timing
   fingerprint, and agree on tokens up to bf16 near-ties; every flash
   launch must have run the tensor-core body, and the decode plan of
   that cache must split it;
6. the full-width falcon-mamba-7b engine, twice over the contiguous state
   cache: with ample capacity and with a capacity that forces swap
   preemptions, the launch counters set to 0 before each run and read
   after: the scan kernel runs once per layer of every prefill group.
   Both runs must finish every request and agree on tokens up to bf16
   near-ties;
7. the full-width zamba2-2.7b engine, the same two runs over its hybrid
   cache (k/v of the 9 shared-attention applications beside 45 Mamba-2
   states): per prefill group 45 scan and 9 flash launches (hd 80), per
   decode iteration 9 decode launches, no paged decode; the tight run
   swaps whole hybrid slots out and back;
8. the HTTP/SSE server (``repro_torch.server``) over a wall-clock engine
   on phase 5's llama3-8b model and weights (8 slots, max_seq 1024,
   paced by the TPU_V5E latency model): 8 concurrent streams (prompts
   64-512 tokens, 32-64 out) that must be well formed, /healthz, and
   /metrics counting every streamed token; a client that hangs up after 3
   tokens, whose request must be cancelled and its slot freed; a drain
   with 2 live streams, which must finish while a new stream gets 503;
   the 8 requests again, at the arrivals the server stamped, through a
   virtual-clock engine, tokens equal up to bf16 near-ties. It prints the
   measured TTFT, TDS and QoE (on the engine's emit stamps, and at the
   socket: each token when its frame was written) beside the modelled
   ones, the tolerance report of the two, the share of wall ticks that
   slept to the modelled schedule against those that drifted behind it,
   the wall per decode iteration (under the server and in the direct
   virtual run), the SSE flush delay and the kernel launches under the
   server (launch counters set to 0 before the first stream, read after
   the drain). Then ``python -m repro_torch.server`` runs as a subprocess
   on the card: 2 streams, SIGTERM, and it must print "DRAINED done" and
   exit 0;
9. the cluster layer (``repro_torch.cluster``) over ``engine_backend``
   replicas that share phase 5's llama3-8b model and bf16 weights (Andes,
   TPU_V5E virtual clock, contiguous caches), each replica's launches
   counted on its own: (9a) phase 5's trace through a 1-replica cluster
   (8 slots, max_seq 1024) must give the bare engine's timing fingerprint
   and tokens exactly; (9b) a 2-replica round-robin engine fleet against
   a 2-replica simulator fleet, per replica the same rids, generated
   counts, TTFT within max(0.05 s, 20%) and QoE within 0.1; (9c) a
   ShareGPT surge from ``repro_torch.workload`` (24 requests at 3 req/s,
   about twice the fleet's modelled capacity) through the QoE router with
   admission that sheds (8 slots, max_seq 2048, 16384 tokens per
   replica): every admitted request must finish, shed + admitted = 24.
   In every run a replica's flash launches must be 32 per prefill group
   and its decode launches 32 per decode iteration. It prints the
   admitted, shed and defer counts, preemptions, the fleet QoE and TTFT
   modelled by TPU_V5E, and the card's wall per decode iteration and per
   prefill group per replica.

It prints the kernels' JSON line, the card line, and last the result
line {"ok": true, "device": {...}}. With no CUDA device, or outside a
checkout of the repo, it exits non-zero and prints no result. Every
process it starts (nvcc, nvidia-smi, the CLI server) ends before it
returns.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

BF16_TOL = 2e-2            # the reference's bf16 kernel tolerance
F32_SCAN_TOL = 1e-5        # the reference's Pallas-vs-ref scan bound (f32)
STATE_TOL = 1e-4           # the scan's final state, f32 in both versions
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same source
F32_FLOPS = 67e12          # f32 outside the tensor cores, same source
# expf issues one MUFU.EX2 on the SFU: 16 per SM per clock on compute
# capability 9.0 (CUDA C++ Programming Guide, arithmetic instruction
# throughput table); the rate is that times the SMs and the max SM clock
EXP_PER_SM_CLOCK = 16
SPIN_CYCLES = 200_000_000  # ~0.1 s of SM clock: covers the host's enqueueing
# A token flip between the two full-width runs is a near-tie when the
# exact-length path's top-2 margin is within a few bf16 rounding steps of
# the logits: bf16 keeps 8 significant bits, so at the |logit| ~ 4..8 this
# random-weight model reaches, one step is 2^-5..2^-4 (0.03..0.06).
BF16_FLIP_TOL = 0.125


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi(query="name,power.limit", units=True) -> str:
    fmt = "csv,noheader" + ("" if units else ",nounits")
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", f"--format={fmt}"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


def exp_rate(torch) -> float:
    """expf per second: SFU issue rate x SMs x max SM clock."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = float(nvidia_smi("clocks.max.sm", units=False))
    return EXP_PER_SM_CLOCK * sms * mhz * 1e6


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------

class _L2Flush:
    """Overwrite a buffer larger than the 50 MB L2 before each timed
    launch: on the main path every layer reads a different cache slice,
    so the kernel finds it cold."""

    def __init__(self, torch):
        self.buf = torch.empty(128 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self):
        self.buf.zero_()


def time_ms(torch, fn, flush, iters=20, warmup=3) -> float:
    """Mean device time of fn() over `iters` launches: CUDA events around
    each launch, L2 flushed before each. A spin kernel queued first keeps
    the card busy while the host enqueues every launch, so the events
    measure device time and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(SPIN_CYCLES)
    for a, b in events:
        flush()
        a.record()
        fn()
        b.record()
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in events) / iters


def bound_ms(bytes_moved: float, *ops):
    """The least time for the work: the bytes over the HBM rate against
    each (count, peak rate per second) of operations."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = max(n / rate * 1e3 for n, rate in ops)
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels at the main path's shapes
# ---------------------------------------------------------------------------

def _paginate(torch, k, v, lengths, page, gen):
    """Shuffled page pool holding the contiguous rows (noise elsewhere)."""
    b, s, kvh, hd = k.shape
    max_pages = -(-s // page)
    needed = [-(-int(n) // page) for n in lengths.tolist()]
    p_total = sum(needed) + 8
    perm = torch.randperm(p_total, generator=gen).tolist()
    k_pool = torch.randn((p_total, page, kvh, hd), device="cuda").to(k.dtype)
    v_pool = torch.randn((p_total, page, kvh, hd), device="cuda").to(k.dtype)
    tables = torch.full((b, max_pages), p_total, dtype=torch.int32)
    rows_b, rows_p, ids = [], [], []
    for bi in range(b):
        for pi in range(needed[bi]):
            tables[bi, pi] = perm[len(ids)]
            ids.append(perm[len(ids)])
            rows_b.append(bi)
            rows_p.append(pi)
    pad = max_pages * page - s
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad)).view(
        b, max_pages, page, kvh, hd)
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad)).view(
        b, max_pages, page, kvh, hd)
    ids_t = torch.tensor(ids, device="cuda")
    k_pool[ids_t] = kp[rows_b, rows_p]
    v_pool[ids_t] = vp[rows_b, rows_p]
    return k_pool, v_pool, tables.cuda()


def _sdpa(torch):
    """SDPA with GQA, or None where this torch lacks `enable_gqa`."""
    f = torch.nn.functional.scaled_dot_product_attention
    x = torch.zeros((1, 2, 1, 64), device="cuda", dtype=torch.bfloat16)
    try:
        f(x, x[:, :1], x[:, :1], enable_gqa=True)
    except TypeError:
        return None
    return f


def check_kernels(torch):
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels import ref

    flush = _L2Flush(torch)
    sdpa = _sdpa(torch)
    gen = torch.Generator().manual_seed(0)
    dt = torch.bfloat16
    rows = {}

    def rnd(*shape):
        return torch.randn(shape, generator=gen).to("cuda", dt)

    def record(name, out, expect, fn, plain, lib, nbytes, flops, extra=""):
        err = (out.float() - expect.float()).abs().max().item()
        ms = time_ms(torch, fn, flush)
        plain_ms = time_ms(torch, plain, flush, iters=5, warmup=1)
        lib_ms = time_ms(torch, lib, flush) if lib is not None else None
        b_ms, b_by = bound_ms(nbytes, (flops, BF16_FLOPS))
        vs = (f" ({lib_ms / ms:.2f}x SDPA's speed)" if lib_ms is not None
              else "")
        print(f"  {name}{extra}: max|err| {err:.3e} (tol {BF16_TOL})  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"library {('%.4f ms' % lib_ms) if lib_ms is not None else 'n/a'}"
              f"  bound {b_ms:.4f} ms ({b_by}){vs}", flush=True)
        if not err <= BF16_TOL:
            fail(f"{name}{extra} disagrees with its plain version: {err}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    def decode_case(b, lengths, extra="", heads=(32, 8, 128)):
        """Decode over a (b, 1024, KV, hd) cache with `heads` = (H, KV,
        hd); returns the inputs."""
        s = 1024
        h, kv, hd = heads
        q = rnd(b, h, hd)
        k, v = rnd(b, s, kv, hd), rnd(b, s, kv, hd)
        lengths = lengths.cuda()
        ctx = int(lengths.sum())
        nbytes = 2 * ctx * kv * hd * 2 + 2 * b * h * hd * 2 + b * 4
        mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])
        qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
        lib = (lambda: sdpa(qs, ks, vs, attn_mask=mask[:, None, None, :],
                            enable_gqa=True)) if sdpa else None
        row = record(
            "decode_attention", kc.decode_attention(q, k, v, lengths),
            ref.decode_attention_ref(q, k, v, lengths),
            lambda: kc.decode_attention(q, k, v, lengths),
            lambda: ref.decode_attention_ref(q, k, v, lengths), lib,
            nbytes, 4 * h * hd * ctx, extra=extra)
        return row, (q, k, v, lengths, ctx, nbytes)

    # ---- decode: B=8, H=32, KV=8, hd=128, cache depth 1024, ragged ----
    lengths = torch.randint(1, 1024 + 1, (8,), generator=gen).to(torch.int32)
    lengths[0] = 1024
    rows["decode_attention"], (q, k, v, lengths, ctx, nbytes) = decode_case(
        8, lengths)
    dense = kc.decode_attention(q, k, v, lengths)

    # ---- paged: the same, page 16 (main path) and page 1 --------------
    h, hd = 32, 128
    for page in (16, 1):
        kp, vp, bt = _paginate(torch, k, v, lengths, page, gen)
        tab_bytes = sum(-(-int(n) // page) for n in lengths.tolist()) * 4
        out = kc.paged_decode_attention(q, kp, vp, bt, lengths)
        if not torch.equal(out, dense):
            fail(f"paged decode (page {page}) is not bitwise the contiguous "
                 "kernel")
        r = record(
            "paged_decode_attention", out,
            ref.paged_decode_attention_ref(q, kp, vp, bt, lengths),
            lambda: kc.paged_decode_attention(q, kp, vp, bt, lengths),
            lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, lengths),
            None, nbytes + tab_bytes, 4 * h * hd * ctx,
            extra=f" (page {page}, bitwise the contiguous kernel)")
        if page == 16:
            rows["paged_decode_attention"] = r
        del kp, vp
    del q, k, v, dense
    # ---- decode at B=1, full depth: one request decoding alone ---------
    decode_case(1, torch.tensor([1024], dtype=torch.int32), extra=" (B=1)")
    # ---- decode at zamba2's shared attention: H = KV = 32, hd 80 -------
    decode_case(8, lengths, heads=(32, 32, 80),
                extra=" (zamba2: B=8, H=KV=32, hd 80)")

    def flash_case(lengths, extra="", heads=(32, 8, 128)):
        """Causal prefill of len(lengths) rows of a 512 bucket."""
        b, s = len(lengths), 512
        h, kv, hd = heads
        q = rnd(b, s, h, hd)
        k, v = rnd(b, s, kv, hd), rnd(b, s, kv, hd)
        lengths = torch.tensor(lengths, dtype=torch.int32).cuda()
        qpos = torch.arange(s, device="cuda")
        valid = ((qpos[None, None, :] <= qpos[None, :, None])
                 & (qpos[None, None, :] < lengths[:, None, None]))
        pairs = int(valid.sum())
        kv_rows = int(lengths.sum())
        nbytes = 2 * (2 * b * s * h * hd) + 2 * 2 * kv_rows * kv * hd + b * 4
        lib = (lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), attn_mask=valid[:, None],
                            enable_gqa=True)) if sdpa else None
        return record(
            "flash_attention",
            kc.flash_attention(q, k, v, causal=True, lengths=lengths),
            ref.attention_ref(q, k, v, causal=True, lengths=lengths),
            lambda: kc.flash_attention(q, k, v, causal=True, lengths=lengths),
            lambda: ref.attention_ref(q, k, v, causal=True, lengths=lengths),
            lib, nbytes, 4 * h * hd * pairs, extra=extra)

    # ---- prefill: B=4, bucket 512, ragged lengths, causal -------------
    rows["flash_attention"] = flash_case([512, 389, 200, 64])
    # ---- prefill: 1 x 512, the engine's usual group --------------------
    flash_case([512], extra=" (1 x 512)")
    # ---- prefill at zamba2's shared attention, the engine's 1 x 512 ----
    flash_case([512], heads=(32, 32, 80),
               extra=" (zamba2: 1 x 512, H=KV=32, hd 80)")
    print(f"  launches by body (phase 3): {dict(kc.variant_launches)}",
          flush=True)
    rows["selective_scan"] = check_scan(torch, flush, gen)
    check_ssd(torch, flush, gen)
    del flush
    torch.cuda.empty_cache()
    return rows


def scan_inputs(torch, gen, lengths, dtype, s=512, d=8192, n=16, r=256):
    """Scan inputs as the falcon-mamba-7b prefill hands them over (rows of
    a bucket of `s`, d_inner `d`, N `n`, dt_rank `r`): B and C are column
    slices of the x_proj output (dt_rank columns first), dt is zero past
    each row's length."""
    b = len(lengths)
    lengths = torch.tensor(lengths)
    x = torch.randn((b, s, d), generator=gen)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, d), generator=gen) - 1)
    pad = torch.arange(s)[None, :, None] >= lengths[:, None, None]
    dt = dt.masked_fill(pad, 0.0)
    A = -torch.exp(torch.randn((d, n), generator=gen) * 0.5)
    dbc = torch.randn((b, s, r + 2 * n), generator=gen)
    x, dt, dbc = (t.to("cuda", dtype) for t in (x, dt, dbc))
    return (x, dt, A.cuda(), dbc[..., r:r + n], dbc[..., r + n:],
            torch.ones(d, device="cuda"))


def rel_err(out, expect) -> float:
    """max |out - expect| relative to max |expect|."""
    return ((out.float() - expect.float()).abs().max()
            / expect.float().abs().max()).item()


def scan_bound(torch, b, s, d, n):
    """The scan's bound -> (ms, by, detail): x, dt and y once, B, C, A, D
    and h_last once, against 6 f32 FLOPs and one exp per (b, t, d, n)."""
    el = b * s * d
    nbytes = 3 * el * 2 + 2 * b * s * n * 2 + d * n * 4 + d * 4 \
        + b * d * n * 4
    flops = 6 * el * n + 3 * el
    rate = exp_rate(torch)
    b_ms, b_by = bound_ms(nbytes, (flops, F32_FLOPS), (el * n, rate))
    return b_ms, b_by, (
        f"bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, f32 FLOPs "
        f"{flops / F32_FLOPS * 1e3:.4f} ms, {el * n / 1e6:.1f} M exp at "
        f"{rate / 1e12:.3f} T/s {el * n / rate * 1e3:.4f} ms")


def check_scan_agrees(torch, gen, lengths, label):
    """The scan kernel against its plain version in f32 (1e-5 relative to
    max |y|) and bf16 (2e-2), the final state within 1e-4 in both.
    Returns (bf16 inputs, bf16 max |y err|)."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels import ref
    for dtype, tol in ((torch.float32, F32_SCAN_TOL),
                       (torch.bfloat16, BF16_TOL)):
        args = scan_inputs(torch, gen, lengths, dtype)
        y, h = kc.selective_scan(*args, return_state=True)
        torch.cuda.synchronize()
        y_ref, h_ref = ref.selective_scan_with_state_ref(*args)
        y_rel, h_rel = rel_err(y, y_ref), rel_err(h, h_ref)
        err = (y.float() - y_ref.float()).abs().max().item()
        print(f"  selective_scan ({str(dtype)[6:]}{label}): max|y err| "
              f"{err:.3e}, relative {y_rel:.3e} (tol {tol}); h_last "
              f"relative {h_rel:.3e} (tol {STATE_TOL})", flush=True)
        if not (y_rel <= tol and h_rel <= STATE_TOL):
            fail(f"selective_scan ({dtype}{label}) disagrees with its plain "
                 "version")
    return args, err


def check_scan(torch, flush, gen):
    """The scan at the full-width prefill's shapes (rows of a 512 bucket,
    d_inner 8192, N 16): B=4 with ragged lengths (512, 389, 200, 64), and
    1 x 512, the engine's usual prefill group. Timed in bf16 as the
    prefill calls it, with the final state. Returns the B=4 row."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels import ref
    rows = []
    for lengths, label in (([512, 389, 200, 64], ""), ([512], ", 1 x 512")):
        args, err = check_scan_agrees(torch, gen, lengths, label)
        b, s, d = args[0].shape
        n = args[2].shape[1]
        ms = time_ms(torch, lambda: kc.selective_scan(*args,
                                                      return_state=True),
                     flush)
        plain_ms = time_ms(torch,
                           lambda: ref.selective_scan_with_state_ref(*args),
                           flush, iters=5, warmup=1)
        b_ms, b_by, detail = scan_bound(torch, b, s, d, n)
        plan = kc.scan_plan(b, s, d, n)
        print(f"  selective_scan (bf16, B={b} S={s} D={d} N={n}, with "
              f"h_last; plan {plan.npl} states per thread, {plan.steps} "
              f"steps per chunk, {plan.threads} threads x {plan.grid} "
              f"blocks): kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"library none  bound {b_ms:.4f} ms ({b_by}: {detail}; "
              f"kernel/bound {ms / b_ms:.2f})", flush=True)
        rows.append(dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                         bound_ms=b_ms, bound_by=b_by, library_ms=None))
    return rows[0]


def ssd_inputs(torch, gen, lengths, dtype, s=512, nh=80, hd=64, n=64):
    """Mamba-2 inputs as the zamba2-2.7b prefill hands them over (rows of
    a bucket of `s`, NH heads of HD channels, N states): x, B and C are
    column slices of the conv output (x as a head view), dt per head is
    zero past each row's length."""
    b, di = len(lengths), nh * hd
    lengths = torch.tensor(lengths)
    xbc = torch.randn((b, s, di + 2 * n), generator=gen)
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, nh), generator=gen) - 1)
    dt = dt.masked_fill(torch.arange(s)[None, :, None]
                        >= lengths[:, None, None], 0.0)
    A = -torch.exp(torch.randn((nh,), generator=gen) * 0.5)
    xbc, dt = xbc.to("cuda", dtype), dt.to("cuda", dtype)
    return (xbc[..., :di].reshape(b, s, nh, hd), dt, A.cuda(),
            xbc[..., di:di + n], xbc[..., di + n:],
            torch.ones(nh, device="cuda"))


def ssd_bound(torch, b, s, nh, hd, n):
    """Two bounds of the Mamba-2 prefill -> (function ms, by, kernel exp
    ms, detail). The function: x, dt (per head), y once, B and C once,
    h_last once, against 6 f32 FLOPs per (b, t, channel, state) and one
    exp per (b, t, head). The kernel, which takes the per-head dt and A
    broadcast over the head's channels: one exp per (b, t, channel,
    state)."""
    d = nh * hd
    el = b * s * d
    nbytes = 2 * el * 2 + b * s * nh * 2 + 2 * b * s * n * 2 + \
        b * d * n * 4 + 2 * nh * 4
    flops = 6 * el * n + 3 * el
    rate = exp_rate(torch)
    f_ms, f_by = bound_ms(nbytes, (flops, F32_FLOPS), (b * s * nh, rate))
    k_ms = el * n / rate * 1e3
    return f_ms, f_by, k_ms, (
        f"bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, f32 FLOPs "
        f"{flops / F32_FLOPS * 1e3:.4f} ms; the kernel's {el * n / 1e6:.1f} "
        f"M exp at {rate / 1e12:.3f} T/s {k_ms:.4f} ms")


def check_ssd(torch, flush, gen):
    """The scan kernel through Mamba-2's mapping (`ops.ssd_with_state`,
    what the zamba2 prefill calls) at the full-width shapes: NH 80, HD 64,
    N 64, rows of a 512 bucket, 1 x 512 (the engine's usual group) and
    B=4 with ragged lengths. Against the plain Mamba-2 recurrence in f32
    (1e-5 relative to max |y|) and bf16 (2e-2), the state within 1e-4;
    timed in bf16, beside the kernel alone on the mapped arguments."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    for lengths in ([512], [512, 389, 200, 64]):
        label = f"B={len(lengths)} S=512 NH=80 HD=64 N=64"
        for dtype, tol in ((torch.float32, F32_SCAN_TOL),
                           (torch.bfloat16, BF16_TOL)):
            args = ssd_inputs(torch, gen, lengths, dtype)
            n0 = kc.launches["selective_scan"]
            y, h = ops.ssd_with_state(*args)
            torch.cuda.synchronize()
            if kc.launches["selective_scan"] != n0 + 1:
                fail("ops.ssd_with_state did not launch the scan kernel")
            y_ref, h_ref = ref.ssd_with_state_ref(*args)
            y_rel, h_rel = rel_err(y, y_ref), rel_err(h, h_ref)
            print(f"  ssd via selective_scan ({str(dtype)[6:]}, {label}): "
                  f"relative y err {y_rel:.3e} (tol {tol}); h_last "
                  f"{h_rel:.3e} (tol {STATE_TOL})", flush=True)
            if not (y_rel <= tol and h_rel <= STATE_TOL):
                fail(f"ssd via selective_scan ({dtype}, {label}) disagrees "
                     "with its plain version")
        b, s, nh, hd = args[0].shape
        n = args[3].shape[-1]
        mapped = ops.ssd_scan_args(*args)
        ms = time_ms(torch, lambda: ops.ssd_with_state(*args), flush)
        k_ms = time_ms(torch, lambda: kc.selective_scan(
            *mapped, return_state=True), flush)
        plain_ms = time_ms(torch, lambda: ref.ssd_with_state_ref(*args),
                           flush, iters=3, warmup=1)
        f_ms, f_by, exp_ms, detail = ssd_bound(torch, b, s, nh, hd, n)
        plan = kc.scan_plan(b, s, nh * hd, n)
        print(f"  ssd via selective_scan (bf16, {label}, with h_last; plan "
              f"{plan.npl} states per thread, {plan.steps} steps per chunk, "
              f"{plan.threads} threads x {plan.grid} blocks): "
              f"ops.ssd_with_state {ms:.4f} ms (kernel alone {k_ms:.4f} ms)"
              f"  plain {plain_ms:.4f} ms  library none  bound {f_ms:.4f} "
              f"ms ({f_by}: {detail}; call/bound {ms / f_ms:.2f}, "
              f"kernel/exp bound {k_ms / exp_ms:.2f})", flush=True)


# ---------------------------------------------------------------------------
# engine runs
# ---------------------------------------------------------------------------

def make_trace(n, vocab, seed, plen, olen, stagger):
    import numpy as np
    from repro_torch.core import QoESpec
    from repro_torch.serving import Request
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        p = int(rng.integers(*plen))
        out.append(Request(
            rid=i, arrival=i * stagger, prompt_len=p,
            output_len=int(rng.integers(*olen)),
            spec=QoESpec(ttft=1.0, tds=4.8),
            prompt_tokens=rng.integers(0, vocab, p)))
    return out


def serve(model, params, trace, *, num_slots, max_seq, cache_dtype,
          capacity, timers=None, **kw):
    """One engine run over fresh clones of `trace` (Andes, virtual clock,
    TPU_V5E latency model, default HotpathConfig)."""
    from repro_torch.core import (TPU_V5E, LatencyModel, SchedulerConfig,
                                  make_scheduler)
    from repro_torch.serving import ServingEngine
    lat = LatencyModel(model.cfg, TPU_V5E)
    sched = make_scheduler("andes", capacity, lat,
                           SchedulerConfig(delta_t=kw.pop("delta_t", 50.0)))
    eng = ServingEngine(model, params, sched, lat, num_slots=num_slots,
                        max_seq=max_seq, capacity_tokens=capacity,
                        cache_dtype=cache_dtype, device=model.device, **kw)
    if timers is not None:
        _instrument(eng, timers)
    out = eng.run([r.clone() for r in trace], max_iterations=100_000)
    return out, eng


def _instrument(eng, timers):
    """Wrap the engine's device entry points with synchronized host
    clocks: per prefill group (rows, bucket) and per decode block."""
    import torch

    def timed(fn, key, steps_of):
        def wrapped(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = fn(*a, **k)
            torch.cuda.synchronize()
            timers.setdefault(key, []).append(
                ((time.perf_counter() - t0) * 1e3, steps_of(a, k)))
            return res
        return wrapped

    eng._prefill._call = timed(eng._prefill._call, "prefill",
                               lambda a, k: tuple(a[1].shape))
    eng._decode_persist = timed(eng._decode_persist, "decode",
                                lambda a, k: a[3])
    eng._decode_multi = timed(eng._decode_multi, "decode", lambda a, k: a[3])
    eng._decode_tok = timed(eng._decode_tok, "decode", lambda a, k: 1)
    eng._decode = timed(eng._decode, "decode", lambda a, k: 1)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


SMALL_RUNS = (("llama3-8b", dict()), ("llama3-8b", dict(page_size=16)),
              ("falcon-mamba-7b", dict(preemption_mode="swap")),
              ("falcon-mamba-7b", dict(preemption_mode="recompute")),
              ("zamba2-2.7b", dict(preemption_mode="swap")),
              ("zamba2-2.7b", dict(preemption_mode="recompute")))


def check_small_engine(torch):
    """Smoke configs, f32: the engine on the card (CUDA kernels) against the
    engine on the CPU (plain versions), with a capacity of 100 tokens so
    that every run preempts."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.serving import (all_flips_documented, audit_flips,
                                     timing_fingerprint)
    for arch, kw in SMALL_RUNS:
        cfg = get_smoke_config(arch)
        cpu = Model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        gpu = Model(cfg, device="cuda")
        gparams = _to(params, "cuda")
        trace = make_trace(12, cfg.vocab_size, 0, (5, 30), (14, 15), 0.01)
        runs = [serve(m, p, trace, num_slots=4, max_seq=64,
                      cache_dtype=torch.float32, capacity=100, delta_t=2.0,
                      **kw)
                for m, p in ((cpu, params), (gpu, gparams))]
        outs = [out for out, _ in runs]
        same_t = timing_fingerprint(outs[0]) == timing_fingerprint(outs[1])
        flips = audit_flips(cpu, params, outs[0], outs[1])
        n_same = sum(a.output_tokens == b.output_tokens
                     for a, b in zip(*outs))
        n_pre = runs[1][1].preemptions
        print(f"  smoke {arch} engine {kw or 'contiguous'}: timing identical "
              f"{same_t}, preemptions {n_pre}, token-identical requests "
              f"{n_same}/{len(trace)}, flips {flips}", flush=True)
        if not same_t:
            fail(f"smoke {arch} engine timing differs between the card and "
                 "the CPU")
        if not n_pre:
            fail(f"smoke {arch} engine {kw}: the trace did not preempt")
        if not all_flips_documented(flips):
            fail(f"smoke {arch} engine token divergence beyond near-ties: "
                 f"{flips}")


def report_run(name, eng, out, timers, wall, launches):
    """Print one full-width engine run: card-measured wall ms per prefill
    group and per decode iteration, the modelled QoE, the launches; fail
    if a request fell short of its output."""
    import numpy as np
    pre = timers.get("prefill", [])
    dec = timers.get("decode", [])
    steps = sum(n for _, n in dec)
    res = eng.result()
    print(f"  engine {name}: physical_pages={eng.physical_pages} "
          f"wall {wall:.2f} s; prefill groups {len(pre)}: "
          + ", ".join(f"{r}x{s}={ms:.1f}ms" for ms, (r, s) in pre)
          + f"; {sum(ms for ms, _ in pre) / max(len(pre), 1):.2f} ms per "
          f"group; decode {len(dec)} blocks / {steps} iterations, "
          f"{sum(ms for ms, _ in dec) / max(steps, 1):.2f} ms per "
          f"iteration (card-measured, synchronized); launches {launches}",
          flush=True)
    print(f"  engine {name} (modelled by the TPU_V5E virtual clock, not "
          f"measured): avg QoE {res.avg_qoe():.4f}, mean TTFT "
          f"{float(np.mean(res.ttfts())):.4f} s, makespan "
          f"{res.makespan:.3f} s, preemptions {res.preemptions}",
          flush=True)
    short = [r.rid for r in out if r.generated != r.output_len]
    if short:
        fail(f"engine {name}: requests {short} did not finish")


def check_logits(torch, model, params, prompt):
    """The logits the engine argmaxes are finite and of the vocab's width."""
    import numpy as np
    toks = torch.as_tensor(np.asarray(prompt, np.int32))[None]
    logits, _ = model.prefill(params, {"tokens": toks.cuda()},
                              model.init_cache(1, toks.shape[1] + 1,
                                               dtype=torch.bfloat16))
    if tuple(logits.shape) != (1, model.cfg.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"bad logits: shape {tuple(logits.shape)}")
    print(f"  logits finite, shape {tuple(logits.shape)}, max |logit| "
          f"{float(logits.float().abs().max()):.3f}", flush=True)


def check_bf16_flips(model, params, a, b, label):
    """Two full-width runs agree on tokens up to bf16 near-ties."""
    from repro_torch.serving import audit_flips, first_divergence
    flips = audit_flips(model, params, a, b, tol=BF16_FLIP_TOL)
    n_div = sum(first_divergence(x.output_tokens, y.output_tokens)
                is not None for x, y in zip(a, b))
    print(f"  {label}: {n_div} requests with token differences, flips "
          f"{flips} (tol {BF16_FLIP_TOL})", flush=True)
    bad = [f for f in flips if f["classification"] != "documented_ulp_flip"]
    if bad:
        fail(f"{label}: tokens diverge beyond near-ties: {bad}")


ATTENTION_KERNELS = ("flash_attention", "decode_attention",
                     "paged_decode_attention")


def full_width_model(torch, config):
    from repro_torch.models import Model
    t0 = time.perf_counter()
    model = Model(config, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"  {config.name}: {config.num_layers} layers, d={config.d_model}, "
          f"{n_params / 1e9:.3f} B params in bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return model, params


def timed_run(torch, model, params, trace, name, **kw):
    """One full-width engine run with the launch counters set to 0 just
    before and read just after. Returns (out, eng, launches, timers)."""
    from repro_torch.kernels import cuda as kc
    timers = {}
    torch.cuda.synchronize()
    kc.reset_launches()
    t = time.perf_counter()
    out, eng = serve(model, params, trace, timers=timers, **kw)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = dict(kc.launches)
    launches.update(kc.variant_launches)
    report_run(name, eng, out, timers, wall, launches)
    return out, eng, launches, timers


def check_full_engine(torch):
    from repro_torch.configs.llama3_8b import CONFIG
    from repro_torch.kernels import cuda as kc
    from repro_torch.serving import timing_fingerprint

    model, params = full_width_model(torch, CONFIG)
    trace = make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65), 0.05)
    common = dict(num_slots=8, max_seq=1024, cache_dtype=torch.bfloat16,
                  capacity=8 * 1024)
    runs = {}
    launches = dict.fromkeys(ATTENTION_KERNELS, 0)
    launches["flash_attention/tensor_core"] = 0
    for name, kw in (("paged16", dict(page_size=16)),
                     ("contiguous", dict())):
        runs[name], _, n, _ = timed_run(torch, model, params, trace, name,
                                        **common, **kw)
        for k in launches:
            launches[k] += n[k]
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was never launched on the llama3 main path")
    tc = launches.pop("flash_attention/tensor_core")
    if tc != launches["flash_attention"]:
        fail(f"{launches['flash_attention'] - tc} flash launches of the "
             "bf16 llama3 runs did not run the tensor-core body")
    chunk, splits = kc.decode_plan(common["max_seq"], common["num_slots"],
                                   CONFIG.num_kv_heads, CONFIG.head_dim, 2)
    if splits < 2:
        fail(f"the decode plan of the llama3 cache does not split it: "
             f"{splits} split of {chunk}")
    print(f"  all {tc} flash launches ran the tensor-core body; decode and "
          f"paged decode split each (row, kv head) into {splits} chunks of "
          f"{chunk} positions", flush=True)
    a, b = runs["paged16"], runs["contiguous"]
    if timing_fingerprint(a) != timing_fingerprint(b):
        fail("paged and contiguous engines differ in timing")
    print("  paged vs contiguous: timing identical", flush=True)
    check_bf16_flips(model, params, a, b, "paged vs contiguous")
    check_logits(torch, model, params, a[0].prompt_tokens)
    profile_engine_steps(torch, model, params)
    return launches, model, params


# a capacity (tokens) under which the 12-request trace preempts: probed on
# the virtual clock, which depends on lengths only (13 swap preemptions)
MAMBA_TIGHT_CAPACITY = 2048


def check_mamba_engine(torch):
    from repro_torch.configs.falcon_mamba_7b import CONFIG

    model, params = full_width_model(torch, CONFIG)
    trace = make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65), 0.05)
    common = dict(num_slots=8, max_seq=1024, cache_dtype=torch.bfloat16)
    runs = {}
    scans = 0
    for name, cap in (("mamba ample", 8 * 1024),
                      ("mamba tight", MAMBA_TIGHT_CAPACITY)):
        runs[name], eng, n, timers = timed_run(
            torch, model, params, trace, name, capacity=cap, **common)
        groups = len(timers.get("prefill", []))
        if n["selective_scan"] != CONFIG.num_layers * groups:
            fail(f"engine {name}: {n['selective_scan']} scan launches for "
                 f"{groups} prefill groups of {CONFIG.num_layers} layers")
        if any(n[k] for k in ATTENTION_KERNELS):
            fail(f"engine {name}: attention kernels ran on an SSM: {n}")
        scans += n["selective_scan"]
        if name == "mamba tight":
            if not eng.preemptions:
                fail("engine mamba tight: no preemption")
            print(f"  mamba tight: {eng.preemptions} swap preemptions, "
                  f"{eng.kv.swap_bytes_total / 1e6:.1f} MB of state "
                  "swapped out to host memory", flush=True)
    if scans <= 0:
        fail("kernel selective_scan was never launched on the mamba path")
    check_bf16_flips(model, params, runs["mamba ample"],
                     runs["mamba tight"], "mamba ample vs tight")
    check_logits(torch, model, params, runs["mamba ample"][0].prompt_tokens)
    profile_engine_steps(torch, model, params)
    return {"selective_scan": scans}


# the same probe for zamba2-2.7b: 12 swap preemptions on the virtual clock
ZAMBA2_TIGHT_CAPACITY = 2048


def check_zamba2_engine(torch):
    """The full-width zamba2-2.7b engine (45 Mamba-2 layers in 9 rounds,
    each round followed by the weight-shared attention+MLP block), with
    ample and with tight capacity. Per prefill group: one scan launch per
    Mamba-2 layer and one flash launch per round; per decode iteration
    one decode launch per round; never the paged kernel."""
    from repro_torch.configs.zamba2_2_7b import CONFIG
    from repro_torch.kernels import cuda as kc

    model, params = full_width_model(torch, CONFIG)
    n_ssm = len(CONFIG.ssm_layer_ids())
    n_attn = CONFIG.num_layers // CONFIG.hybrid_attn_every
    trace = make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65), 0.05)
    common = dict(num_slots=8, max_seq=1024, cache_dtype=torch.bfloat16)
    runs = {}
    total = dict.fromkeys(("selective_scan", "flash_attention",
                           "decode_attention"), 0)
    for name, cap in (("zamba2 ample", 8 * 1024),
                      ("zamba2 tight", ZAMBA2_TIGHT_CAPACITY)):
        runs[name], eng, n, timers = timed_run(
            torch, model, params, trace, name, capacity=cap, **common)
        groups = len(timers.get("prefill", []))
        iters = sum(k for _, k in timers.get("decode", []))
        want = {"selective_scan": n_ssm * groups,
                "flash_attention": n_attn * groups,
                "flash_attention/tensor_core": n_attn * groups,
                "decode_attention": n_attn * iters,
                "paged_decode_attention": 0}
        for k, v in want.items():
            if n[k] != v:
                fail(f"engine {name}: {n[k]} {k} launches, expected {v} "
                     f"({groups} prefill groups, {iters} decode iterations)")
        for k in total:
            total[k] += n[k]
        if name == "zamba2 tight":
            if not eng.preemptions:
                fail("engine zamba2 tight: no preemption")
            print(f"  zamba2 tight: {eng.preemptions} swap preemptions, "
                  f"{eng.kv.swap_bytes_total / 1e6:.1f} MB of k/v and state "
                  "swapped out to host memory", flush=True)
    for k, v in total.items():
        if v <= 0:
            fail(f"kernel {k} was never launched on the zamba2 path")
    chunk, splits = kc.decode_plan(common["max_seq"], common["num_slots"],
                                   CONFIG.num_kv_heads, CONFIG.head_dim, 2)
    print(f"  zamba2 launches as expected: {n_ssm} scans and {n_attn} flash "
          f"per prefill group, {n_attn} decode per iteration, no paged "
          f"decode; hd {CONFIG.head_dim} decode plan {splits} splits of "
          f"{chunk}; scan plan at 1 x 512 "
          f"{tuple(kc.scan_plan(1, 512, CONFIG.d_inner, 64)[:2])}",
          flush=True)
    check_bf16_flips(model, params, runs["zamba2 ample"],
                     runs["zamba2 tight"], "zamba2 ample vs tight")
    check_logits(torch, model, params, runs["zamba2 ample"][0].prompt_tokens)
    profile_engine_steps(torch, model, params)
    return total


# ---------------------------------------------------------------------------
# phase 8: the HTTP/SSE server over the full-width llama3-8b engine
# ---------------------------------------------------------------------------

HOST = "127.0.0.1"
SERVER_STREAMS = 8


def _count_ticks(eng, counts):
    """Wrap the engine's clock: each wall tick either sleeps off what the
    host left of the modelled duration ("slept") or finds the host already
    past the modelled deadline ("drifted"); count both, with the seconds
    slept or drifted and the modelled seconds asked for."""
    tick = eng._tick

    def counted(seconds):
        late = time.monotonic() - eng._wall0 - (eng.now + seconds)
        kind = "drifted" if late >= 0 else "slept"
        counts[kind] += 1
        counts[kind + "_s"] += abs(late)
        counts["modelled_s"] += seconds
        tick(seconds)
    eng._tick = counted


def _mean_p95(xs):
    import numpy as np
    xs = np.asarray([x for x in xs if x is not None and np.isfinite(x)],
                    np.float64)
    if not xs.size:
        return float("nan"), float("nan")
    return float(xs.mean()), float(np.percentile(xs, 95))


def _well_formed(evs, rid, n):
    """accepted -> token* (indices 0..n-1) -> finish with n tokens."""
    kinds = [k for k, _ in evs]
    toks = [d for k, d in evs if k == "token"]
    return (len(kinds) >= 2 and kinds[0] == "accepted"
            and evs[0][1]["rid"] == rid and kinds[-1] == "finish"
            and set(kinds[1:-1]) <= {"token"}
            and [d["index"] for d in toks] == list(range(n))
            and evs[-1][1]["n_tokens"] == n)


def _flush_times(trace_events, payloads, results, step_ends):
    """Per token: the engine-clock time its SSE frame was written to the
    socket (the server's `sse_flush` events, each covering n frames of one
    rid in order) minus the token's emit time, split at the end of the
    pump's step that emitted it (frames leave only after the step); and
    per rid, the times its token frames were written."""
    import bisect
    flushes = {}
    for e in trace_events:
        if e.kind == "sse_flush":
            flushes.setdefault(e.rid, []).extend(
                [e.t] * e.data["n_events"])
    delays, in_step, after_step, first = [], [], [], {}
    for p, evs in zip(payloads, results):
        times = flushes.get(p["rid"], [])
        if len(times) != len(evs):
            fail(f"server: rid {p['rid']} flushed {len(times)} frames but "
                 f"the client read {len(evs)}")
        sent = [(t, d) for (k, d), t in zip(evs, times) if k == "token"]
        for t, d in sent:
            end = step_ends[min(bisect.bisect_left(step_ends, d["t"]),
                                len(step_ends) - 1)]
            delays.append(t - d["t"])
            in_step.append(end - d["t"])
            after_step.append(t - end)
        first[p["rid"]] = [t for t, _ in sent]
    return delays, in_step, after_step, first


def check_server(torch, model, params):
    """The port's HTTP/SSE server over a wall-clock engine on phase 5's
    model and weights: 8 concurrent streams, a client that hangs up, a
    drain under load, and the same requests through a virtual-clock engine
    for comparison. Returns the kernel launches counted from the first
    stream to the end of the drain."""
    import asyncio
    import dataclasses
    import threading

    import numpy as np
    from repro_torch.core import (TPU_V5E, LatencyModel, SchedulerConfig,
                                  make_scheduler)
    from repro_torch.kernels import cuda as kc
    from repro_torch.obs import parse_prometheus
    from repro_torch.server import (ServerConfig, ServingServer, astream,
                                    collect, fetch, stream)
    from repro_torch.serving import Request, ServingEngine, compare_requests

    cfg = model.cfg

    def engine(clock):
        lat = LatencyModel(cfg, TPU_V5E)
        sched = make_scheduler("andes", 8 * 1024, lat,
                               SchedulerConfig(delta_t=50.0))
        return ServingEngine(model, params, sched, lat, num_slots=8,
                             max_seq=1024, capacity_tokens=8 * 1024,
                             cache_dtype=torch.bfloat16, clock=clock,
                             device=model.device)

    eng = engine("wall")
    timers = {}
    _instrument(eng, timers)
    ticks = dict.fromkeys(("slept", "drifted", "slept_s", "drifted_s",
                           "modelled_s"), 0)
    _count_ticks(eng, ticks)
    srv = ServingServer(ServerConfig(host=HOST, clock="wall",
                                     drain_timeout=300.0),
                        backend=eng, model_cfg=cfg)
    step_ends = []                  # engine clock when each pump step ended
    client_step = srv.client.step

    def timed_step(*a, **k):
        res = client_step(*a, **k)
        step_ends.append(eng.wall_now())
        return res
    srv.client.step = timed_step
    t = time.perf_counter()
    port = srv.start()
    print(f"  server on {HOST}:{port} (wall clock, TPU_V5E pacing), "
          f"started with its warmup in {time.perf_counter() - t:.1f} s",
          flush=True)

    status, body = fetch(HOST, port, "/healthz")
    health = json.loads(body) if status == 200 else {}
    if not (health.get("ok") and health.get("clock") == "wall"):
        fail(f"server: /healthz answered {status} {body!r}")

    rng = np.random.default_rng(8)
    payloads = []
    for i in range(SERVER_STREAMS):
        plen = int(rng.integers(64, 513))
        payloads.append({
            "prompt_tokens": rng.integers(0, cfg.vocab_size, plen).tolist(),
            "max_tokens": int(rng.integers(32, 65)), "rid": 100 + i})

    def emitted():
        status, text = fetch(HOST, port, "/metrics")
        if status != 200:
            fail(f"server: /metrics answered {status}")
        return parse_prometheus(text)[("tokens_emitted_total", ())]

    emitted0 = emitted()
    mark = len(srv.trace.events)
    torch.cuda.synchronize()
    kc.reset_launches()
    timers.clear()
    for k in ticks:
        ticks[k] = 0

    async def streams():
        async def one(i, p):
            await asyncio.sleep(0.05 * i)      # arrivals trickle in
            return await astream(HOST, port, p)
        return await asyncio.gather(*(one(i, p)
                                      for i, p in enumerate(payloads)))

    t = time.perf_counter()
    results = asyncio.run(streams())
    window_s = time.perf_counter() - t
    tick_window = dict(ticks)
    timer_window = {k: list(v) for k, v in timers.items()}
    for p, evs in zip(payloads, results):
        if not _well_formed(evs, p["rid"], p["max_tokens"]):
            fail(f"server: stream {p['rid']} is not accepted -> "
                 f"{p['max_tokens']} tokens -> finish: "
                 f"{[k for k, _ in evs]}")
    n_streamed = sum(p["max_tokens"] for p in payloads)
    if emitted() - emitted0 != n_streamed:
        fail(f"server: /metrics counts {emitted() - emitted0} emitted "
             f"tokens, the streams carried {n_streamed}")
    if fetch(HOST, port, "/healthz")[0] != 200:
        fail("server: /healthz stopped answering")
    print(f"  {SERVER_STREAMS} concurrent streams well formed, "
          f"{n_streamed} tokens in {window_s:.2f} s; /healthz answers, "
          "/metrics parses and counts every streamed token", flush=True)
    delays, in_step, after_step, sent_times = _flush_times(
        srv.trace.events[mark:], payloads, results, list(step_ends))
    if min(delays) < 0:
        fail(f"server: a token was flushed before it was emitted "
             f"({min(delays)})")

    # ---- a client that hangs up after 3 tokens -------------------------
    slots0 = eng.kv.slots_in_use
    got = [k for k, _ in stream(
        HOST, port, {"prompt_tokens": payloads[0]["prompt_tokens"][:64],
                     "max_tokens": 512, "rid": 200}, max_events=4)]
    if got != ["accepted", "token", "token", "token"]:
        fail(f"server: the hang-up stream read {got}")
    deadline = time.monotonic() + 60
    req = next(r for r in eng.seen if r.rid == 200)
    while (not req.cancelled or eng.kv.slots_in_use != slots0) \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    if not req.cancelled or eng.kv.slots_in_use != slots0:
        fail(f"server: hang-up not cancelled (cancelled={req.cancelled}, "
             f"slots {eng.kv.slots_in_use} vs {slots0} before)")
    print(f"  hang-up after 3 tokens: request cancelled with "
          f"{req.generated} of 512 tokens, slots in use back to {slots0}",
          flush=True)

    # ---- drain while 2 streams are live --------------------------------
    live = {}
    started = threading.Barrier(3)

    def client(i):
        evs = []
        for ev in stream(HOST, port, {
                "prompt_tokens": payloads[i]["prompt_tokens"],
                "max_tokens": 64, "rid": 300 + i}, timeout=300):
            evs.append(ev)
            if ev[0] == "accepted":
                started.wait(timeout=120)
        live[i] = evs

    threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
    for th in threads:
        th.start()
    started.wait(timeout=120)
    phase = {}
    shut = threading.Thread(
        target=lambda: phase.update(p=srv.shutdown(drain=True)))
    shut.start()
    while not srv._draining:
        time.sleep(0.005)
    refused = collect(HOST, port, {"prompt_len": 8, "max_tokens": 4})
    shut.join(timeout=600)
    for th in threads:
        th.join(timeout=60)
    if shut.is_alive() or any(th.is_alive() for th in threads):
        fail("server: the drain did not end")
    torch.cuda.synchronize()
    launches = dict(kc.launches)
    if not (refused and refused[0][0] == "http_error"
            and refused[0][1]["status"] == 503):
        fail(f"server: a stream opened during the drain got {refused}")
    if phase.get("p") != "done":
        fail(f"server: drain ended {phase.get('p')!r}")
    for i in range(2):
        if not _well_formed(live.get(i, []), 300 + i, 64):
            fail(f"server: live stream {300 + i} did not finish through "
                 "the drain")
    print("  drain with 2 live streams: both finished (64 tokens each), a "
          "new stream got 503, drain phase 'done'", flush=True)

    # ---- the same requests through a virtual-clock engine --------------
    served = sorted((r for r in eng.seen
                     if 100 <= r.rid < 100 + SERVER_STREAMS),
                    key=lambda r: r.rid)
    for r, p, evs in zip(served, payloads, results):
        if [d["token"] for k, d in evs if k == "token"] != \
                [int(x) for x in r.output_tokens]:
            fail(f"server: stream {r.rid} carried other tokens than the "
                 "engine emitted")
    trace = [Request(rid=r.rid, arrival=r.arrival, prompt_len=r.prompt_len,
                     output_len=r.output_len, spec=r.spec,
                     prompt_tokens=np.asarray(r.prompt_tokens, np.int32))
             for r in served]
    del eng.cache
    veng = engine("virtual")
    vtimers = {}
    _instrument(veng, vtimers)
    virtual = sorted(veng.run(trace, max_iterations=100_000),
                     key=lambda r: r.rid)
    check_bf16_flips(model, params, virtual, served,
                     "server (wall) vs virtual engine")

    # ---- report --------------------------------------------------------
    # the same requests as the client's socket saw them: each token at
    # the time its frame was written
    at_socket = [dataclasses.replace(r, emit_times=sent_times[r.rid])
                 for r in served]
    for label, reqs in (
            ("measured on the card (wall clock, emit stamps)", served),
            ("measured at the socket (wall clock, frames written)",
             at_socket),
            ("modelled (virtual clock, TPU_V5E)", virtual)):
        stats = [_mean_p95([getattr(r, f)() for r in reqs])
                 for f in ("final_ttft", "final_tds", "final_qoe")]
        print(f"  {label}: TTFT mean {stats[0][0]:.4f} s p95 "
              f"{stats[0][1]:.4f} s; TDS mean {stats[1][0]:.3f} tok/s p95 "
              f"{stats[1][1]:.3f}; QoE mean {stats[2][0]:.4f} p95 "
              f"{stats[2][1]:.4f}", flush=True)
    rep = compare_requests(virtual, served)
    print("  " + rep.summary().replace("\n", "\n  "), flush=True)
    n_ticks = tick_window["slept"] + tick_window["drifted"]
    print(f"  wall ticks in the {SERVER_STREAMS}-stream window: {n_ticks}; "
          f"slept {tick_window['slept']} "
          f"({tick_window['slept'] / max(n_ticks, 1):.3f}, "
          f"{tick_window['slept_s']:.3f} s in all), drifted "
          f"{tick_window['drifted']} "
          f"({tick_window['drifted'] / max(n_ticks, 1):.3f}, "
          f"{tick_window['drifted_s']:.3f} s late in all); modelled "
          f"{tick_window['modelled_s'] * 1e3 / max(n_ticks, 1):.2f} ms per "
          "tick", flush=True)
    for label, tm in (("under the server", timer_window),
                      ("direct virtual run of the same requests", vtimers)):
        dec, pre = tm.get("decode", []), tm.get("prefill", [])
        steps = sum(n for _, n in dec)
        print(f"  {label}: wall per decode iteration "
              f"{sum(ms for ms, _ in dec) / max(steps, 1):.2f} ms "
              f"({len(dec)} blocks, {steps} iterations); per prefill group "
              f"{sum(ms for ms, _ in pre) / max(len(pre), 1):.2f} ms "
              f"({len(pre)} groups: "
              + ", ".join(f"{r}x{s}" for _, (r, s) in pre)
              + ") (card-measured, synchronized)", flush=True)
    print(f"  SSE flush delay (frame written - token emitted, engine "
          f"clock) over {len(delays)} tokens: "
          + "; ".join(f"{name} mean {m * 1e3:.2f} ms, p95 {q * 1e3:.2f} ms, "
                      f"max {max(xs) * 1e3:.2f} ms"
                      for name, xs in (("total", delays),
                                       ("until the pump's step ended",
                                        in_step),
                                       ("step end to socket write",
                                        after_step))
                      for m, q in [_mean_p95(xs)]), flush=True)
    print(f"  launches in the phase (streams, hang-up, drain): {launches}",
          flush=True)
    for k in ("flash_attention", "decode_attention"):
        if launches[k] <= 0:
            fail(f"kernel {k} was never launched under the server")
    return launches


def check_server_cli():
    """`python -m repro_torch.server` as a subprocess (the smoke config on
    its default device, the card): 2 streams, then SIGTERM must drain it
    and end it with code 0."""
    import asyncio
    import os
    import queue
    import signal
    import threading

    from repro_torch.server import astream

    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + env.get(
        "PYTHONPATH", "")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.server", "--host", HOST],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)
    lines: "queue.Queue" = queue.Queue()
    out = []

    def reader():
        for line in proc.stdout:
            lines.put(line)
        lines.put(None)

    threading.Thread(target=reader, daemon=True).start()

    def next_line(deadline):
        try:
            line = lines.get(timeout=max(deadline - time.monotonic(), 0.1))
        except queue.Empty:
            return None
        if line is not None:
            out.append(line)
        return line

    try:
        t = time.perf_counter()
        deadline = time.monotonic() + 300
        line = ""
        while line is not None and not line.startswith("LISTENING "):
            line = next_line(deadline)
        if line is None:
            fail("python -m repro_torch.server never listened:\n"
                 + "".join(out[-30:]))
        port = int(line.split()[1])
        print(f"  python -m repro_torch.server: LISTENING {port} after "
              f"{time.perf_counter() - t:.1f} s", flush=True)

        async def two():
            return await asyncio.gather(*(
                astream(HOST, port, {"prompt_len": 16 + 8 * i,
                                     "max_tokens": 12, "rid": 10 + i})
                for i in range(2)))

        for i, evs in enumerate(asyncio.run(two())):
            if not _well_formed(evs, 10 + i, 12):
                fail(f"CLI server stream {10 + i}: {[k for k, _ in evs]}")
        proc.send_signal(signal.SIGTERM)
        proc.wait(timeout=120)
        while next_line(time.monotonic() + 10) is not None:
            pass
        if proc.returncode != 0 or not any(
                ln.strip() == "DRAINED done" for ln in out):
            fail(f"CLI server exited {proc.returncode}:\n"
                 + "".join(out[-30:]))
        print(f"  2 streams well formed; SIGTERM -> DRAINED done, exit "
              f"{proc.returncode}", flush=True)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------------------
# phase 9: the cluster layer over engine-backed llama3-8b replicas
# ---------------------------------------------------------------------------

SURGE_REQUESTS = 24
SURGE_RATE = 3.0           # req/s: about twice two replicas' modelled rate


def _count_replica_launches(rep, counts):
    """Wrap the replica's backend step: the launch counters' growth during
    each of its steps is this replica's (the cluster steps one replica at
    a time on the host)."""
    from repro_torch.kernels import cuda as kc
    step = rep.backend.step

    def counted(*a, **k):
        before = dict(kc.launches)
        res = step(*a, **k)
        for name, n in kc.launches.items():
            counts[name] = counts.get(name, 0) + n - before[name]
        return res
    rep.backend.step = counted


def run_fleet(torch, lat, ccfg, trace):
    """One ClusterSimulator run over fresh clones of `trace`, every engine
    replica instrumented (synchronized device timers and its own launch
    counts), with the launch counters set to 0 just before the run and
    read just after. Returns (result, {replica: (timers, launches)},
    launches, wall seconds)."""
    from repro_torch.cluster import ClusterSimulator, SteppableBackend
    from repro_torch.kernels import cuda as kc
    from repro_torch.serving import ServingEngine
    cs = ClusterSimulator(lat, ccfg)
    per = {}
    for rep in cs.replicas:
        if not isinstance(rep.backend, SteppableBackend):
            fail(f"replica {rep.id}: {type(rep.backend).__name__} is not a "
                 "SteppableBackend")
        if isinstance(rep.backend, ServingEngine):
            per[rep.id] = ({}, {})
            _instrument(rep.backend, per[rep.id][0])
            _count_replica_launches(rep, per[rep.id][1])
    torch.cuda.synchronize()
    kc.reset_launches()
    t = time.perf_counter()
    res = cs.run([r.clone() for r in trace])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return res, per, dict(kc.launches), wall


def check_replica_launches(label, per, n_layers):
    """Per engine replica: flash launches = layers x prefill groups and
    decode launches = layers x decode iterations, nothing else; print the
    replica's card-measured wall per decode iteration and prefill group."""
    for rid, (timers, counts) in sorted(per.items()):
        pre, dec = timers.get("prefill", []), timers.get("decode", [])
        iters = sum(n for _, n in dec)
        per_group = sum(ms for ms, _ in pre) / max(len(pre), 1)
        flash = counts.get("flash_attention", 0)
        decode = counts.get("decode_attention", 0)
        other = {k: n for k, n in counts.items()
                 if n and k not in ("flash_attention", "decode_attention")}
        print(f"  {label} replica {rid}: {len(pre)} prefill groups, "
              f"{iters} decode iterations ({len(dec)} blocks); launches "
              f"flash {flash}, decode {decode}; wall per decode iteration "
              f"{sum(ms for ms, _ in dec) / max(iters, 1):.2f} ms, per "
              f"prefill group {per_group:.2f} ms (card-measured, "
              "synchronized)", flush=True)
        if flash != n_layers * len(pre) or decode != n_layers * iters:
            fail(f"{label} replica {rid}: flash {flash} for {len(pre)} "
                 f"groups, decode {decode} for {iters} iterations "
                 f"({n_layers} layers)")
        if other:
            fail(f"{label} replica {rid}: unexpected launches {other}")


def check_cluster(torch, model, params):
    """Phase 9: the port's cluster layer over engine-backed replicas that
    share phase 5's full-width model and bf16 weights (TPU_V5E virtual
    clock, Andes). 9a: 1 replica against the bare engine; 9b: a 2-replica
    engine fleet against a 2-replica simulator fleet, per replica; 9c: a
    ShareGPT surge through the QoE router with shedding. Returns the
    kernel launches of its runs."""
    import numpy as np
    from repro_torch.cluster import (AdmissionConfig, ClusterConfig,
                                     engine_backend)
    from repro_torch.core import TPU_V5E, LatencyModel, SchedulerConfig
    from repro_torch.serving import timing_fingerprint
    from repro_torch.workload import make_workload

    t_phase = time.perf_counter()
    cfg = model.cfg
    layers = cfg.num_layers
    lat = LatencyModel(cfg, TPU_V5E)
    launches = dict.fromkeys(ATTENTION_KERNELS, 0)

    def add(n):
        for k in launches:
            launches[k] += n.get(k, 0)

    # ---- 9a: one engine replica against the bare engine ----------------
    trace = make_trace(12, cfg.vocab_size, 0, (64, 513), (32, 65), 0.05)
    cap = 8 * 1024
    bare, _, n, _ = timed_run(torch, model, params, trace, "9a bare",
                              num_slots=8, max_seq=1024,
                              cache_dtype=torch.bfloat16, capacity=cap)
    add(n)
    fleet = dict(scheduler="andes", kv_capacity_tokens=cap,
                 sched_cfg=SchedulerConfig(delta_t=50.0),
                 backend_factory=engine_backend(
                     model, params, num_slots=8, max_seq=1024,
                     capacity_tokens=cap, cache_dtype=torch.bfloat16,
                     device=model.device))
    res, per, n, wall = run_fleet(torch, lat, ClusterConfig(
        n_replicas=1, router="round_robin", **fleet), trace)
    add(n)
    routed = sorted(res.admitted, key=lambda r: r.rid)
    same_t = timing_fingerprint(routed) == timing_fingerprint(bare)
    same_tok = [r.output_tokens for r in routed] == \
        [r.output_tokens for r in bare]
    print(f"  9a 1-replica cluster vs bare engine: timing identical "
          f"{same_t}, tokens identical {same_tok}, wall {wall:.2f} s",
          flush=True)
    if not same_t or not same_tok or res.shed:
        fail("9a: the 1-replica engine cluster differs from the bare "
             "engine")
    check_replica_launches("9a", per, layers)

    # ---- 9b: engine fleet against simulator fleet, per replica ---------
    two = dict(n_replicas=2, router="round_robin")
    res_e, per, n, wall = run_fleet(torch, lat, ClusterConfig(**two, **fleet),
                                    trace)
    add(n)
    sim_fleet = {k: v for k, v in fleet.items() if k != "backend_factory"}
    res_s, _, _, _ = run_fleet(torch, lat, ClusterConfig(**two, **sim_fleet),
                               trace)
    if res_e.replica_results.keys() != res_s.replica_results.keys():
        fail("9b: the engine and simulator fleets differ in replicas")
    worst = [0.0, 0.0]
    for rid in sorted(res_s.replica_results):
        per_s = res_s.replica_results[rid].requests
        per_e = res_e.replica_results[rid].requests
        if not per_s or [r.rid for r in per_s] != [r.rid for r in per_e]:
            fail(f"9b replica {rid}: placement differs or is empty")
        for re_, rs in zip(per_e, per_s):
            te, ts = re_.final_ttft(), rs.final_ttft()
            qe, qs = re_.final_qoe(), rs.final_qoe()
            worst = [max(worst[0], abs(te - ts)), max(worst[1], abs(qe - qs))]
            if re_.generated != rs.generated \
                    or abs(te - ts) >= max(0.05, 0.2 * ts) \
                    or abs(qe - qs) >= 0.1:
                fail(f"9b replica {rid} rid {re_.rid}: engine "
                     f"({re_.generated}, {te}, {qe}) vs simulator "
                     f"({rs.generated}, {ts}, {qs})")
    sizes = [len(r.requests) for r in res_e.replica_results.values()]
    print(f"  9b 2-replica engine fleet vs simulator fleet (round robin): "
          f"per replica {sizes} requests, same placement and generated "
          f"counts; max |TTFT "
          f"diff| {worst[0]:.4f} s, max |QoE diff| {worst[1]:.4f} (modelled "
          f"by TPU_V5E); engine fleet wall {wall:.2f} s", flush=True)
    check_replica_launches("9b", per, layers)

    # ---- 9c: a ShareGPT surge, QoE router, admission that sheds --------
    surge = make_workload(SURGE_REQUESTS, rate=SURGE_RATE, seed=0,
                          dataset="sharegpt")
    cap = 16384
    res, per, n, wall = run_fleet(torch, lat, ClusterConfig(
        n_replicas=2, router="qoe", scheduler="andes",
        kv_capacity_tokens=cap, admission=AdmissionConfig(policy="shed"),
        backend_factory=engine_backend(
            model, params, num_slots=8, max_seq=2048, capacity_tokens=cap,
            cache_dtype=torch.bfloat16, device=model.device)), surge)
    add(n)
    short = [r.rid for r in res.admitted if r.generated != r.output_len]
    if short or len(res.admitted) + len(res.shed) != SURGE_REQUESTS:
        fail(f"9c: unfinished {short}, admitted {len(res.admitted)} + shed "
             f"{len(res.shed)} != {SURGE_REQUESTS}")
    ttfts = res.ttfts()
    print(f"  9c surge ({SURGE_REQUESTS} ShareGPT requests at "
          f"{SURGE_RATE} req/s, 2 replicas, qoe router, shed): admitted "
          f"{len(res.admitted)}, shed {len(res.shed)}, defer events "
          f"{res.n_defer_events}, preemptions {res.preemptions()}, per "
          f"replica {[len(r.requests) for r in res.replica_results.values()]}"
          f" requests, {sum(r.output_len for r in res.admitted)} tokens",
          flush=True)
    print(f"  9c modelled by TPU_V5E (virtual clock, not measured): fleet "
          f"avg QoE {res.avg_qoe():.4f} (shed as 0; admitted only "
          f"{res.avg_qoe(include_shed=False):.4f}), TTFT mean "
          f"{float(np.mean(ttfts)):.4f} s p95 "
          f"{float(np.percentile(ttfts, 95)):.4f} s, makespan "
          f"{res.makespan:.3f} s", flush=True)
    check_replica_launches("9c", per, layers)
    print(f"  9c wall {wall:.2f} s; phase 9 wall "
          f"{time.perf_counter() - t_phase:.2f} s; launches {launches}",
          flush=True)
    return launches


def profile_window(torch, label, fn, steps):
    """Trace fn() with torch.profiler: card-busy time (sum of kernel
    device time) against the synchronized host wall time of the window,
    per step, and the kernels that take the most of it."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA

    def dev_us(e):
        return (getattr(e, "self_device_time_total", 0)
                or getattr(e, "self_cuda_time_total", 0))

    kern = sorted((e for e in prof.key_averages() if e.device_type == cuda),
                  key=dev_us, reverse=True)
    busy_ms = sum(dev_us(e) for e in kern) / 1e3
    if busy_ms <= 0:
        print(f"  profile {label}: device time not measured by the "
              f"profiler (wall {wall_ms / steps:.2f} ms per step)")
        return
    print(f"  profile {label} (torch.profiler, on): wall "
          f"{wall_ms / steps:.2f} ms per step, card busy "
          f"{busy_ms / steps:.2f} ms per step, idle share "
          f"{1 - busy_ms / wall_ms:.3f}; "
          f"{sum(e.count for e in kern) // steps} kernels per step; top: "
          + "; ".join(f"{e.key[:60]} {dev_us(e) / 1e3 / steps:.3f} ms x"
                      f"{e.count // steps}" for e in kern[:6]), flush=True)


def profile_engine_steps(torch, model, params):
    """One prefill group (1 x 512) and a 4-step decode block at 8 slots
    with 600 tokens of context each, over the contiguous cache."""
    from repro_torch.models import cache as cache_lib
    toks = torch.randint(0, model.cfg.vocab_size, (1, 512), device="cuda",
                         dtype=torch.int32)

    def prefill():
        model.prefill(params, {"tokens": toks},
                      model.init_cache(1, 1024, dtype=torch.bfloat16))

    cache = cache_lib.with_lengths(
        model.init_cache(8, 1024, dtype=torch.bfloat16), [600] * 8)
    tokens = torch.zeros(8, dtype=torch.int32, device="cuda")

    def decode():
        model.decode_multi(params, tokens, dict(cache), 4)

    profile_window(torch, "prefill 1x512", prefill, 1)
    profile_window(torch, "decode block, 8 slots x 600 ctx", decode, 4)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


SOURCES = {
    "decode_attention": ("src/repro_torch/kernels/csrc/decode_attention.cu",
                         "src/repro/kernels/decode_attention.py:99"),
    "paged_decode_attention": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/paged_attention.py:69"),
    "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                        "src/repro/kernels/flash_attention.py:109"),
    "selective_scan": ("src/repro_torch/kernels/csrc/selective_scan.cu",
                       "src/repro/kernels/selective_scan.py:62"),
}


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this script runs the port on an NVIDIA GPU")
    try:
        from repro_torch.kernels import build
    except ImportError as e:
        fail(f"the port is not importable (run from a checkout): {e}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()

    card = nvidia_smi()
    print(f"[1] device: {card} | torch {torch.__version__} CUDA "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    t = time.perf_counter()
    secs = build.build_all()
    print(f"[2] kernels built in {time.perf_counter() - t:.1f} s "
          f"(per library: { {k: round(v, 1) for k, v in secs.items()} })",
          flush=True)
    for name, log in build.build_logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}")

    for name in build.SOURCES:
        text = build.sass(name)
        counts = {op: text.count(op + ".") for op in ("HGMMA", "HMMA")}
        print(f"    {name}: tensor-core instructions in SASS {counts}",
              flush=True)
        if name == "flash_attention" and not sum(counts.values()):
            fail("the flash library has no tensor-core instruction")

    print("[3] kernels vs plain versions (main-path shapes; "
          f"{card}):", flush=True)
    rows = check_kernels(torch)

    print("[4] smoke engines, card vs CPU (f32):", flush=True)
    check_small_engine(torch)

    print("[5] full-width llama3-8b engine (bf16):", flush=True)
    launches, llama, llama_params = check_full_engine(torch)
    torch.cuda.empty_cache()

    print("[6] full-width falcon-mamba-7b engine (bf16):", flush=True)
    launches.update(check_mamba_engine(torch))
    torch.cuda.empty_cache()

    print("[7] full-width zamba2-2.7b engine (bf16):", flush=True)
    for k, n in check_zamba2_engine(torch).items():
        launches[k] += n
    torch.cuda.empty_cache()

    print("[8] the HTTP/SSE server over the full-width llama3-8b engine "
          f"(bf16, wall clock; {card}):", flush=True)
    for k, n in check_server(torch, llama, llama_params).items():
        launches[k] += n
    torch.cuda.empty_cache()

    print("[9] the cluster layer over engine-backed full-width llama3-8b "
          f"replicas (bf16, virtual clock; {card}):", flush=True)
    for k, n in check_cluster(torch, llama, llama_params).items():
        launches[k] += n
    del llama, llama_params
    torch.cuda.empty_cache()
    check_server_cli()

    kernels = []
    for name, (src, rep) in SOURCES.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=launches[name],
                            **rows[name]))
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
