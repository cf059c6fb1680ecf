#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main paths — the Andes serving engine over the
full-width, full-depth Llama-3-8B, Falcon-Mamba-7B, Zamba2-2.7B,
Qwen1.5-MoE-A2.7B, SeamlessM4T-medium and Pixtral-12B configs with random
bf16 weights made from a seed, the
HTTP/SSE server over the Llama-3-8B engine on the wall clock, the cluster
layer over engine-backed Llama-3-8B replicas, and speculative decoding
over the Llama-3-8B target cut to 16 of its 32 layers (full width), and
training of the full-width Granite-3-2B
and Zamba2-2.7B and of Falcon-Mamba-7B cut to 24 of its 64 layers (f32
AdamW of all 64 needs about 116 GB), the serving launcher
(``repro_torch.launch.serve``) over the full-width Llama-3-8B in f32, and
expert-parallel MoE and DTensor sharding on a one-rank mesh — and holds
every hand-written CUDA
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
   function's bound and the kernel's exponential bound. At qwen2-moe's
   shapes (H = KV = 16, hd 128): decode and paged decode (page 16) at B=8
   over depth 1024, and flash over one row at its exact length (389 and
   64); at phase 10's: decode over caches 1028 deep for the llama3-8b
   target and the foreign draft (H 4, KV 2, hd 32), and the draft's
   flash (1 x 512 bucket); at phase 12's seamless-m4t-medium (H = KV =
   16, hd 64): decode (B=8, depth 1024) and bidirectional flash for the
   encoder (4 x 256), cross-attention at prefill (1 x 512 queries over
   256 keys) and at decode (Sq = 1, B=8 over 256 keys), the last timed
   also on the decode kernel, which computes the same function;
4. the smoke-size engines on the card against the same engines on the CPU
   (plain versions), f32, with a capacity that forces preemption: llama3
   over the contiguous cache and the page pool, falcon-mamba and zamba2
   in swap and in recompute mode; the llama3 speculative engine (k = 2)
   with the exact and a perturbed draft; qwen2-moe in swap and recompute
   mode; seamless-m4t-medium (frames from each rid) in swap and
   recompute mode; pixtral-12b over the page pool and the contiguous
   cache. Identical virtual timing and tokens identical up to documented
   near-ties — the repo's differential check on a small input;
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
   In every run a replica's flash launches must be one per layer and
   prefill group and its decode launches one per layer and decode
   iteration. It prints the
   admitted, shed and defer counts, preemptions, the fleet QoE and TTFT
   modelled by TPU_V5E, and the card's wall per decode iteration and per
   prefill group per replica;
10. speculative decoding over phase 5's llama3-8b model and weights cut
   to their first 16 of 32 layers (full width; the depth cut keeps the
   script inside its time) (k = 3, 8 slots, max_seq 1024, phase 5's
   trace, Andes, the
   SpeculativeLatencyModel on TPU_V5E): first the kernels' half of full
   acceptance — from one prefilled cache the target's verify of a window
   is bitwise the draft-side decode steps that proposed it — and a
   baseline engine whose cache is as deep as the spec engine's (max_seq
   1028, so the decode plan splits it alike). Each speculative run must be
   lossless against the baseline up to bf16 near-ties: the two schedules
   differ, so the prompts land in prefill groups of other row counts and
   the bf16 numerics differ slightly; each flip is classified by
   ``audit_flips`` along the baseline engine's own layout
   (``engine_margin``: bucketed prefill, decode from position
   len(prompt) + 1), the exact-length margin printed beside it. 10a
   the exact draft (the target's own params), at least one block of
   rounds; the acceptance is printed (the draft computes one position
   below the target, so it is not 1 by construction), and 10a runs again
   with the plain attention versions in place of the kernels, which must
   launch no kernel and must not accept everything where the kernels do
   not; 10b a perturbed
   draft (params + 1e-3 randn, seed 9) with blocks and with single
   rounds, which must be bit for bit identical; 10c the reference test's
   small foreign draft (1 layer, d 128, hd 32); 10d a 1-replica
   ``speculative_backend`` cluster, fingerprint and tokens equal to 10a.
   In every run flash = layers x prefill groups (target and draft),
   decode = (k+1) x (target + draft layers) per round, no paged decode.
   It prints rounds, tokens per round, acceptance, the card's wall per
   round and per committed token beside the baseline's, and the modelled
   TTFT, TDS and QoE;
11. the full-width qwen2-moe-a2.7b engine (24 layers, 60 routed + 4
   shared experts, top-4; bf16, seed 0) over phase 5's trace, over the
   physical page pool (page 16) and the contiguous cache, then the
   contiguous run again: one timing fingerprint, the rerun bitwise equal,
   flash = 24 per eager exact-length prefill, decode or paged decode = 24
   per decode iteration. Decode routes empty slots too, and their k/v
   reads differ between the layouts, so at capacity 1 per expert the
   pair's token flips are reported and held to the recorded count; the
   pair again with nothing dropped
   (capacity factor E / k) must agree up to bf16 near-ties. Also the
   share of routed assignments dropped at decode, one prompt's logits
   against the plain path on the card, and profiled decode and prefill
   windows;
12. the full-width encoder-decoder and vision-language engines over
   phase 5's trace (8 slots, max_seq 1024): (12a) seamless-m4t-medium
   (12 encoder + 12 decoder layers, d 1024, 16 heads of hd 64, no RoPE),
   each request carrying ``synthetic_frames`` keyed by its rid (enc_seq
   256), with ample capacity, with a capacity that forces swap
   preemption, and with ample capacity on the plain attention versions
   (no kernel launched): every request finishes, the ample and plain runs
   share one timing fingerprint, tokens agree up to near-ties (judged
   along the ample engine's layout, with frames); flash = 36 per prefill
   group (12 encoder, 12 self, 12 cross) + 12 per decode iteration (cross
   at Sq = 1), decode = 12 per iteration, no paged decode, every flash on
   the tensor-core body; the same prompts with zero frames must change
   some tokens. (12b) pixtral-12b (40 layers, d 5120, 32/8 heads of hd
   128) over the page pool (page 16) and the contiguous cache: one
   timing fingerprint, tokens up to near-ties, flash = 40 per prefill
   group, decode or paged decode = 40 per iteration; then one prefill
   with a 64-patch prefix, kernels against the plain path, whose cache
   length counts the patches. Each prints the walls per decode iteration
   and prefill group and profiled windows;
13. training: (13a) the flash kernel's `lse` and the two backward kernels
   (dQ, which writes each row's Delta, then dK/dV, which reads it;
   ``csrc/flash_attention_bwd.cu``: bf16 on the tensor-core body, f32 on
   the CUDA-core one, each launch counted by body) against
   ``attention_lse_ref`` / ``attention_bwd_ref`` in f32 (1e-4) and bf16
   (2e-2, both relative to max |grad|) at granite-3-2b's training shape
   (8 x 512, H 32, KV 8, hd 64, causal), llama3's hd 128, zamba2's hd 80,
   seamless's bidirectional encoder and cross-attention with ragged
   lengths and a window, each timed with L2 flushed beside its bound (5
   products of 2 hd FLOPs per attended pair and head over the f32 or
   bf16 peak, against bytes), the plain version and SDPA's backward
   (``torch.autograd.grad`` of ``scaled_dot_product_attention``, a
   yardstick only), and two launches must give bitwise-equal gradients;
   the granite rows of both dtypes go into the kernels' line; then the
   scan: the forward's chunk states (y bitwise the same without them)
   and the backward kernel (``csrc/selective_scan_bwd.cu``) against
   ``selective_scan_bwd_ref`` in f32 (1e-4) and bf16 (2e-2, relative to
   each gradient's max magnitude) at falcon-mamba's Mamba-1 (8 x 512, D
   8192, N 16) and a ragged-dt Mamba-1 case on the Mamba-1 body, and
   zamba2's Mamba-2 as ``ops.ssd`` trains it (A per channel through
   ``ops.ssd_channel_args``, 8 x 512, NH 80, HD 64, N 64) on the Mamba-2
   body, two launches bitwise equal and counted by body, each timed with
   L2 flushed beside its bound (Mamba-1: 19 f32 FLOPs and one exp per
   (b, t, d, n); Mamba-2, the function's own: 14 f32 FLOPs per (b, t, d,
   n) and one exp per (b, t, head); against bytes), the plain version
   and the dB / dC partial bytes; the 8 x 512 rows of both bodies and
   dtypes go into the kernels' line (``body`` and ``body_launches`` keys);
   (13b) smoke-size training, f32 with TF32 off, on the
   card against the CPU: the loss and every gradient of one remat loss
   and one train step (grad norm, params after AdamW) for llama3-8b,
   granite-3-2b, qwen2-moe, seamless-m4t-medium, pixtral-12b,
   falcon-mamba-7b and zamba2-2.7b, the backward launches one per
   attention call and per Mamba layer (falcon-mamba's on the Mamba-1
   body, zamba2's on the Mamba-2 body), the scan forward two (remat); 50
   llama3 steps must lower the loss by 1.0;
   (13c) full-width, full-depth granite-3-2b, f32 params and AdamW,
   remat, 8 x 512 from ``packed_batches``, 10 steps through
   ``build_train_step``: finite loss and grad norm every step, flash 80
   (40 + 40 recomputed) and dQ = dK/dV = 40 a step on the CUDA-core
   backward body, the wall per step,
   tokens/s, peak memory, a profiled step (busy time, the backward
   kernels' share) and a checkpoint saved and restored bitwise; (13d)
   full-width, full-depth zamba2-2.7b (45 Mamba-2 layers, 9 applications
   of the shared attention, 2.168 B params) and (13e) falcon-mamba-7b cut
   to its first 24 of 64 layers (3.06 B params), each f32 params and
   AdamW, remat, 8 x 512 from ``packed_batches``, 5 and 3 steps: finite
   loss and grad norm every step, per step the scan 2 x the Mamba layers
   (90; 48), its backward once per Mamba layer (45 on the Mamba-2 body;
   24 on the Mamba-1 body), flash 18 and dQ
   = dK/dV = 9 (zamba2), the wall per step, tokens/s, peak memory and a
   profiled step (busy time, idle share, the scan backward's share);
14. the serving launcher and the distributed layer, after every phase
   that holds a full-width model: (14a) ``repro_torch.launch.serve.main``
   in-process with ``--mode engine --arch llama3-8b --requests 20`` and
   no ``--device``, so its default takes the card: full-width,
   full-depth llama3-8b with the reference's f32 params (about 32 GB),
   8 slots, max_seq 128, the TPU_V5E virtual clock; the launch counters
   set to 0 before and read after: flash and decode must have launched,
   and the printed line must show 20/20 finished; (14b) a one-rank NCCL
   group and a (1, 1) ("data", "model") ``DeviceMesh``: phase 11's
   full-width qwen2-moe-a2.7b (bf16, seed 0) through
   ``Model(moe_ep_mesh=mesh)`` against the plain ``Model`` at one
   prefill of the first 4 prompts of phase 11's trace: the same top-1
   tokens up to near-ties, logits within BF16_TOL, the same dropped
   routed assignments; then every leaf of those params through
   ``make_shardings`` + ``distribute_tensor`` onto the mesh, one at a
   time, each local shard bitwise the leaf. One rank shows no
   collective traffic: a multi-rank expert-parallel run needs more
   than one card; (14c) full-width, full-depth llama3-8b (bf16, seed 0)
   served by ``Model(kv_repeat=1)`` and ``Model(kv_repeat=2)`` (KV heads
   repeated to 16, the value the dry run's opt 1 picks on a 16-wide
   model axis) on one set of weights: a 4 x 512 bucketed prefill of 14b's
   prompts, logits within BF16_TOL; then the engine, contiguous and
   page 16, the prefill's token and 16 greedy decode steps per request:
   equal timing and tokens equal up to near-ties judged by
   ``lossless.engine_margin`` (``audit_flips(engine=)``), the cache
   holding 16 KV heads; the kv_repeat=2 runs' flash, decode and paged
   decode launches go into the kernels' line. Phase 3 holds decode and
   paged decode (page 16, bitwise the contiguous kernel) at that shape
   (B=8, depth 1024, H 32, KV 16, hd 128) and decode at kv_repeat 4's
   KV 32. The multi-pod dry run (``repro_torch.launch.dryrun``) runs on
   the CPU and is not part of this script.

It prints each phase's wall (the host clock from the end of the
previous phase), the kernels' JSON line (the backwards' bf16 rows
follow their f32 ones under the same names, with `dtype` keys, and
`body` keys for flash's), the card line,
and last the result
line {"ok": true, "device": {...}}. With no CUDA device, or outside a
checkout of the repo, it exits non-zero and prints no result. Every
process it starts (nvcc, nvidia-smi, the CLI server) ends before it
returns.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import math
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

    def decode_case(b, lengths, extra="", heads=(32, 8, 128), s=1024):
        """Decode over a (b, s, KV, hd) cache with `heads` = (H, KV, hd);
        returns the inputs."""
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
        return row, (q, k, v, lengths, ctx, nbytes, lib)

    def paged_case(inputs, page, extra="", sdpa_rows=False):
        """The paged kernel over a shuffled pool holding decode_case's
        rows: bitwise the contiguous kernel, and against its plain
        version; with `sdpa_rows`, beside SDPA over the contiguous rows
        (no library call reads a page table)."""
        q, k, v, lengths, ctx, nbytes, lib = inputs
        h, hd = q.shape[1:]
        dense = kc.decode_attention(q, k, v, lengths)
        kp, vp, bt = _paginate(torch, k, v, lengths, page, gen)
        tab_bytes = sum(-(-int(n) // page) for n in lengths.tolist()) * 4
        out = kc.paged_decode_attention(q, kp, vp, bt, lengths)
        if not torch.equal(out, dense):
            fail(f"paged decode (page {page}{extra}) is not bitwise the "
                 "contiguous kernel")
        return record(
            "paged_decode_attention", out,
            ref.paged_decode_attention_ref(q, kp, vp, bt, lengths),
            lambda: kc.paged_decode_attention(q, kp, vp, bt, lengths),
            lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, lengths),
            lib if sdpa_rows else None, nbytes + tab_bytes, 4 * h * hd * ctx,
            extra=f" (page {page}{extra}, bitwise the contiguous kernel"
                  + ("; library: SDPA over the contiguous rows)"
                     if sdpa_rows else ")"))

    # ---- decode: B=8, H=32, KV=8, hd=128, cache depth 1024, ragged ----
    lengths = torch.randint(1, 1024 + 1, (8,), generator=gen).to(torch.int32)
    lengths[0] = 1024
    rows["decode_attention"], inputs = decode_case(8, lengths)
    # ---- paged: the same, page 16 (main path) and page 1 --------------
    rows["paged_decode_attention"] = paged_case(inputs, 16)
    paged_case(inputs, 1)
    del inputs
    # ---- decode at B=1, full depth: one request decoding alone ---------
    decode_case(1, torch.tensor([1024], dtype=torch.int32), extra=" (B=1)")
    # ---- decode at zamba2's shared attention: H = KV = 32, hd 80 -------
    decode_case(8, lengths, heads=(32, 32, 80),
                extra=" (zamba2: B=8, H=KV=32, hd 80)")
    # ---- qwen2-moe-a2.7b (phase 11): H = KV = 16 (G = 1), hd 128, both
    # layouts ------------------------------------------------------------
    _, inputs = decode_case(8, lengths, heads=(16, 16, 128),
                            extra=" (qwen2-moe: B=8, H=KV=16, hd 128)")
    paged_case(inputs, 16, extra=", qwen2-moe: H=KV=16")
    del inputs
    # ---- llama3-8b served with Model(kv_repeat=2) (phase 14c): KV 16
    # (G = 2), hd 128, both layouts; and kv_repeat=4's KV 32 (G = 1) ----
    _, inputs = decode_case(8, lengths, heads=(32, 16, 128),
                            extra=" (kv_repeat 2: B=8, H=32, KV=16, hd 128)")
    paged_case(inputs, 16, extra=", kv_repeat 2: KV=16", sdpa_rows=True)
    del inputs
    decode_case(8, lengths, heads=(32, 32, 128),
                extra=" (kv_repeat 4: B=8, H=KV=32, hd 128)")
    # ---- phase 10's caches, max_seq + k + 1 = 1028 deep: the llama3-8b
    # target and the foreign draft (H 4, KV 2, hd 32) --------------------
    spec_lengths = lengths.clone()
    spec_lengths[1] = 1028
    decode_case(8, spec_lengths, s=1028,
                extra=" (speculative target: B=8, depth 1028)")
    decode_case(8, spec_lengths, heads=(4, 2, 32), s=1028,
                extra=" (foreign draft: B=8, H=4, KV=2, hd 32, depth 1028)")
    # ---- seamless-m4t-medium's decoder self-attention (phase 12): H = KV
    # = 16 (G = 1), hd 64, depth 1024 --------------------------------------
    decode_case(8, lengths, heads=(16, 16, 64),
                extra=" (seamless: B=8, H=KV=16, hd 64)")

    def flash_case(lengths, extra="", heads=(32, 8, 128), s=512):
        """Causal prefill of len(lengths) rows of an `s` bucket."""
        b = len(lengths)
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
    # ---- qwen2-moe-a2.7b's eager prefill: one row at its exact length,
    # G = 1 -------------------------------------------------------------
    for n in (389, 64):
        flash_case([n], heads=(16, 16, 128), s=n,
                   extra=f" (qwen2-moe: 1 x {n} exact, H=KV=16, hd 128)")
    # ---- the foreign draft's bucketed prefill: H 4, KV 2, hd 32 -------
    flash_case([389], heads=(4, 2, 32),
               extra=" (foreign draft: 1 x 512 bucket, H=4, KV=2, hd 32)")

    def bidir_case(b, sq, sk, lens, extra, heads=(16, 16, 64)):
        """Bidirectional attention of b x sq queries over sk keys, keys at
        or past `lens` masked (None: no lengths, as the engine's encoder):
        seamless-m4t-medium's encoder and cross-attention. Returns the
        inputs."""
        h, kv, hd = heads
        q = rnd(b, sq, h, hd)
        k, v = rnd(b, sk, kv, hd), rnd(b, sk, kv, hd)
        lengths = (None if lens is None
                   else torch.tensor(lens, dtype=torch.int32).cuda())
        n_keys = [sk] * b if lens is None else [min(n, sk) for n in lens]
        valid = torch.stack([torch.arange(sk, device="cuda") < n
                             for n in n_keys])[:, None, None, :]
        nbytes = (2 * (2 * b * sq * h * hd) + 2 * 2 * sum(n_keys) * kv * hd
                  + (b * 4 if lens is not None else 0))
        lib = (lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), attn_mask=valid,
                            enable_gqa=True)) if sdpa else None

        def kern():
            return kc.flash_attention(q, k, v, causal=False, lengths=lengths)

        def plain():
            return ref.attention_ref(q, k, v, causal=False, lengths=lengths)
        record("flash_attention", kern(), plain(), kern, plain, lib, nbytes,
               4 * h * hd * sq * sum(n_keys), extra=extra)
        return q, k, v, lengths, nbytes, sq * sum(n_keys)

    # ---- seamless-m4t-medium (phase 12): the encoder, 4 x 256 frames;
    # cross-attention at prefill (a 512 bucket of queries over 256 keys)
    # and at decode (Sq = 1) -------------------------------------------
    bidir_case(4, 256, 256, None,
               " (seamless encoder: 4 x 256, bidirectional, H=KV=16, hd 64)")
    bidir_case(1, 512, 256, [256],
               " (seamless cross-attention at prefill: 1 x 512 queries over "
               "256 keys)")
    q, k, v, enc_len, nbytes, pairs = bidir_case(
        8, 1, 256, [256] * 8,
        " (seamless cross-attention at decode: Sq = 1, B=8 over 256 keys)")
    # the decode kernel computes the same function on the same inputs
    # (decode_attention_ref is attention_ref at Sq = 1, bidirectional)
    q1 = q[:, 0]
    mask = (torch.arange(256, device="cuda")[None, :] < enc_len[:, None])
    record("decode_attention", kc.decode_attention(q1, k, v, enc_len),
           ref.decode_attention_ref(q1, k, v, enc_len),
           lambda: kc.decode_attention(q1, k, v, enc_len),
           lambda: ref.decode_attention_ref(q1, k, v, enc_len),
           (lambda: sdpa(q1[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
                         attn_mask=mask[:, None, None, :], enable_gqa=True))
           if sdpa else None, nbytes, 4 * 16 * 64 * pairs,
           extra=" (the same cross-attention at Sq = 1 on the decode kernel)")
    del q, k, v, q1
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
        mapped = ops.ssd_channel_args(*args)
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
    out = eng.run(clones(trace), max_iterations=100_000)
    return out, eng


def clones(trace):
    """Fresh copies of the trace's requests; an encoder-decoder request's
    frames ride along (``Request.clone`` leaves them out, as the
    reference's)."""
    out = [r.clone() for r in trace]
    for c, r in zip(out, trace):
        if getattr(r, "frames", None) is not None:
            c.frames = r.frames
    return out


def with_frames(trace, cfg, enc_seq):
    """Attach ``synthetic_frames`` keyed by each request's rid (f32, host)
    to every request of `trace`; returns the trace."""
    from repro_torch.serving import synthetic_frames
    for r in trace:
        r.frames = synthetic_frames(cfg, [r.rid], enc_seq)[0]
    return trace


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
    if eng.spec_k:
        # rounds: one per fused round, `s` per block (all run on the card)
        eng._spec_fused = timed(eng._spec_fused, "spec", lambda a, k: 1)
        eng._spec_block = timed(eng._spec_block, "spec", lambda a, k: a[6])
        if eng.draft.bucketed is not None:
            eng.draft.bucketed._call = timed(
                eng.draft.bucketed._call, "draft_prefill",
                lambda a, k: tuple(a[1].shape))


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


SMALL_RUNS = (("llama3-8b", dict()), ("llama3-8b", dict(page_size=16)),
              ("falcon-mamba-7b", dict(preemption_mode="swap")),
              ("falcon-mamba-7b", dict(preemption_mode="recompute")),
              ("zamba2-2.7b", dict(preemption_mode="swap")),
              ("zamba2-2.7b", dict(preemption_mode="recompute")),
              ("seamless-m4t-medium", dict(preemption_mode="swap")),
              ("seamless-m4t-medium", dict(preemption_mode="recompute")),
              ("pixtral-12b", dict(page_size=16)),
              ("pixtral-12b", dict()))


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
        if gpu.enc_seq(64):
            with_frames(trace, cfg, gpu.enc_seq(64))
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


def _perturbed(torch, params, seed):
    """params + 1e-3 * randn (a seeded generator on the params' device),
    in the params' dtype; stacked (3-d and up) leaves one layer at a
    time."""
    gen = torch.Generator(device=next(_leaves(params)).device)
    gen.manual_seed(seed)

    def leaf(t):
        out = torch.empty_like(t)
        stacked = t.dim() >= 3
        for i in range(t.shape[0] if stacked else 1):
            src, dst = (t[i], out[i]) if stacked else (t, out)
            noise = torch.randn(src.shape, generator=gen, device=t.device)
            dst.copy_((src.float() + 1e-3 * noise).to(t.dtype))
        return out

    def walk(tree):
        if isinstance(tree, dict):
            return {k: walk(v) for k, v in tree.items()}
        return leaf(tree)
    return walk(params)


def check_small_spec_moe(torch):
    """Phase 4's speculative and MoE cases: the llama3 smoke spec engine
    (k = 2, a capacity that preempts) with the exact and a perturbed draft,
    and the qwen2-moe smoke engine in swap and recompute mode, each on
    the card against the same engine on the CPU (f32)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (TPU_V5E, LatencyModel, SchedulerConfig,
                                  SpeculativeLatencyModel, make_scheduler)
    from repro_torch.models import Model
    from repro_torch.serving import (ServingEngine, all_flips_documented,
                                     audit_flips, timing_fingerprint)
    runs = [("llama3-8b", "exact", dict()), ("llama3-8b", "perturbed", dict()),
            ("qwen2-moe-a2.7b", None, dict(preemption_mode="swap")),
            ("qwen2-moe-a2.7b", None, dict(preemption_mode="recompute"))]
    for arch, draft, kw in runs:
        cfg = get_smoke_config(arch)
        cpu = Model(cfg, device="cpu")
        params = cpu.init(torch.Generator().manual_seed(0))
        gpu = Model(cfg, device="cuda")
        dparams = (params if draft in (None, "exact")
                   else _perturbed(torch, params, 9))
        trace = make_trace(12, cfg.vocab_size, 0, (5, 30), (14, 15), 0.01)
        outs, engs = [], []
        for m, p, dp in ((cpu, params, dparams),
                         (gpu, _to(params, "cuda"), _to(dparams, "cuda"))):
            if draft:
                lat = SpeculativeLatencyModel(cfg, TPU_V5E, cfg, k=2)
                kw = dict(draft_model=m, draft_params=dp, spec_k=2)
            else:
                lat = LatencyModel(cfg, TPU_V5E)
            eng = ServingEngine(m, p, make_scheduler(
                "andes", 100, lat, SchedulerConfig(delta_t=2.0)), lat,
                num_slots=4, max_seq=64, capacity_tokens=100,
                device=m.device, **kw)
            outs.append(eng.run([r.clone() for r in trace],
                                max_iterations=4000))
            engs.append(eng)
        same_t = timing_fingerprint(outs[0]) == timing_fingerprint(outs[1])
        flips = audit_flips(cpu, params, outs[0], outs[1])
        n_same = sum(a.output_tokens == b.output_tokens
                     for a, b in zip(*outs))
        label = f"smoke {arch} " + (f"spec k=2 {draft} draft" if draft
                                    else f"engine {kw}")
        acc = (f", acceptance card {engs[1].spec_stats()['accepted']}/"
               f"{engs[1].spec_stats()['proposed']} CPU "
               f"{engs[0].spec_stats()['accepted']}/"
               f"{engs[0].spec_stats()['proposed']}" if draft else "")
        print(f"  {label}: timing identical {same_t}, preemptions "
              f"{engs[1].preemptions}, token-identical requests "
              f"{n_same}/{len(trace)}, flips {flips}{acc}", flush=True)
        if not engs[1].preemptions:
            fail(f"{label}: the trace did not preempt")
        if not all_flips_documented(flips):
            fail(f"{label}: token divergence beyond near-ties: {flips}")
        if not flips and not same_t:
            fail(f"{label}: timing differs between the card and the CPU")
        if draft == "exact" and not flips and \
                engs[0].spec_stats() != engs[1].spec_stats():
            fail(f"{label}: acceptance differs between the card and the CPU")


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


def check_bf16_flips(model, params, a, b, label, engine=None):
    """Two full-width runs agree on tokens up to bf16 near-ties (with
    `engine`, each flip judged along that engine's own layout)."""
    from repro_torch.serving import audit_flips, first_divergence
    flips = audit_flips(model, params, a, b, tol=BF16_FLIP_TOL,
                        engine=engine)
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


# ---------------------------------------------------------------------------
# phase 10: speculative decoding over the full-width llama3-8b model
# ---------------------------------------------------------------------------

SPEC_K = 3                  # speculative_backend's default
# phase 10 runs over phase 5's llama3-8b cut to its first SPEC_LAYERS of
# 32 layers, at full width: its wall grows with the depth (282 s of the
# whole script's 1024 s with all 32 on an NVIDIA H100 80GB HBM3 at 700 W),
# and the script is to stay well inside 1200 s
SPEC_LAYERS = 16


def depth_cut(model, params, n):
    """`model` cut to its first n layers at full width: a Model of the
    config with num_layers n over views of the stacked block weights."""
    from repro_torch.models import Model

    def first(tree):
        if isinstance(tree, dict):
            return {k: first(v) for k, v in tree.items()}
        return tree[:n]

    cut = Model(dataclasses.replace(model.cfg, num_layers=n),
                device=model.device)
    return cut, {**params, "blocks": first(params["blocks"])}


def serve_spec(torch, model, params, draft, dparams, trace, *, hotpath=None,
               max_seq=1024):
    """One speculative engine run (k = SPEC_K, 8 slots, Andes, the
    SpeculativeLatencyModel on TPU_V5E, virtual clock), instrumented,
    with the launch counters set to 0 just before and read just after.
    Returns (out, eng, launches, timers, wall seconds)."""
    from repro_torch.core import (TPU_V5E, SchedulerConfig,
                                  SpeculativeLatencyModel, make_scheduler)
    from repro_torch.kernels import cuda as kc
    from repro_torch.serving import ServingEngine
    lat = SpeculativeLatencyModel(model.cfg, TPU_V5E, draft.cfg, k=SPEC_K)
    sched = make_scheduler("andes", 8 * 1024, lat,
                           SchedulerConfig(delta_t=50.0))
    eng = ServingEngine(model, params, sched, lat, num_slots=8,
                        max_seq=max_seq, capacity_tokens=8 * 1024,
                        cache_dtype=torch.bfloat16, draft_model=draft,
                        draft_params=dparams, spec_k=SPEC_K, hotpath=hotpath,
                        device=model.device)
    timers = {}
    _instrument(eng, timers)
    torch.cuda.synchronize()
    kc.reset_launches()
    t = time.perf_counter()
    out = eng.run([r.clone() for r in trace], max_iterations=100_000)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    return out, eng, dict(kc.launches), timers, wall


def check_spec_launches(label, launches, timers, n_target, n_draft):
    """flash = target layers x target prefill groups + draft layers x
    draft prefill groups; decode = (k+1) x (target + draft layers) per
    round run on the card; no paged decode. Returns the rounds."""
    groups = len(timers.get("prefill", []))
    dgroups = len(timers.get("draft_prefill", []))
    rounds = sum(n for _, n in timers.get("spec", []))
    want = {"flash_attention": n_target * groups + n_draft * dgroups,
            "decode_attention": (SPEC_K + 1) * (n_target + n_draft) * rounds,
            "paged_decode_attention": 0}
    for k, v in want.items():
        if launches[k] != v:
            fail(f"{label}: {launches[k]} {k} launches, expected {v} "
                 f"({groups} + {dgroups} prefill groups, {rounds} rounds)")
    return rounds


def report_spec(label, eng, out, timers, wall, launches, base_tok_ms, card):
    """Print a spec run: rounds, tokens per round, acceptance, the card's
    wall per round and per committed token beside the baseline's, the
    modelled TTFT / TDS / QoE; fail on an unfinished request."""
    import numpy as np
    st = eng.spec_stats()
    spec = timers.get("spec", [])
    rounds = sum(n for _, n in spec)
    spec_ms = sum(ms for ms, _ in spec)
    decoded = sum(r.generated - 1 for r in out)
    pre = timers.get("prefill", []) + timers.get("draft_prefill", [])
    res = eng.result()
    print(f"  {label} ({card}): wall {wall:.2f} s; {rounds} rounds on the "
          f"card in "
          f"{len(spec)} dispatches ({eng.multi_step_blocks} blocks), "
          f"{eng.iterations} committed; {decoded} decoded tokens, "
          f"{decoded / max(st['spec_steps'], 1):.3f} per slot-round, "
          f"{decoded / max(eng.iterations, 1):.2f} per committed round; "
          f"acceptance {st['accepted']}/{st['proposed']} = "
          f"{st['acceptance_rate']:.4f}; launches {launches}", flush=True)
    print(f"  {label} ({card}; card-measured, synchronized): "
          f"{spec_ms / max(rounds, 1):.2f} ms per round, "
          f"{spec_ms / max(decoded, 1):.3f} ms per committed token vs the "
          f"baseline's {base_tok_ms:.3f} ms per token; prefill "
          f"{sum(ms for ms, _ in pre):.1f} ms in {len(pre)} groups "
          f"(target {[s for _, s in timers.get('prefill', [])]}, draft "
          f"{[s for _, s in timers.get('draft_prefill', [])]})", flush=True)
    print(f"  {label} (modelled by the TPU_V5E virtual clock, not "
          f"measured; beside {card}): TTFT mean "
          f"{float(np.mean(res.ttfts())):.4f} s, TDS "
          f"mean {float(np.mean(res.tds())):.3f} tok/s, avg QoE "
          f"{res.avg_qoe():.4f}, makespan {res.makespan:.3f} s, "
          f"preemptions {res.preemptions}", flush=True)
    short = [r.rid for r in out if r.generated != r.output_len]
    if short:
        fail(f"{label}: requests {short} did not finish")


def check_lossless(base_eng, base, out, label):
    """A speculative run against the same-depth baseline: tokens equal up
    to near-ties. Each flip is classified by `audit_flips` along the
    baseline engine's own layout (`engine_margin`), the exact-length
    margin printed beside it."""
    from repro_torch.serving import all_flips_documented, audit_flips
    flips = audit_flips(base_eng.model, base_eng.params, base, out,
                        tol=BF16_FLIP_TOL, engine=base_eng)
    print(f"  {label} vs baseline: {len(flips)} requests with token "
          f"differences, flips {flips} (tol {BF16_FLIP_TOL}; margin: the "
          "engine's layout, exact_margin: the exact-length path)",
          flush=True)
    if not all_flips_documented(flips):
        fail(f"{label}: tokens diverge beyond near-ties: {flips}")


def check_verify_determinism(torch, model, params):
    """The kernel-determinism half of full acceptance: from one prefilled
    cache (8 rows, depth max_seq + k + 1), the draft-side propose on a
    copy and the target-side verify of its window compute the same
    positions from the same inputs in caches of the same shape, so the
    verify logits must be bitwise the propose steps' and every proposal
    must verify (acceptance k on every row)."""
    import numpy as np
    depth = 1024 + SPEC_K + 1
    rng = np.random.default_rng(10)
    lens = rng.integers(64, 513, 8).astype(np.int32)
    toks = np.zeros((8, 512), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(0, model.cfg.vocab_size, n)
    cache = model.init_cache(8, depth, dtype=torch.bfloat16)
    logits, cache = model.prefill(params, {
        "tokens": torch.as_tensor(toks).cuda(),
        "lengths": torch.as_tensor(lens).cuda()}, cache)
    first = torch.argmax(logits, dim=-1).to(torch.int32)
    copy = {k: v.clone() for k, v in cache.items()}
    steps, tok = [], first
    for _ in range(SPEC_K + 1):                # the propose loop, logged
        lg, copy = model.decode_step(params, tok, copy)
        steps.append(lg)
        tok = torch.argmax(lg, dim=-1).to(torch.int32)
    props = torch.stack([torch.argmax(x, dim=-1).to(torch.int32)
                         for x in steps], dim=1)
    window = torch.cat([first[:, None], props[:, :SPEC_K]], dim=1)
    vlogits, _ = model.verify_step(params, window, cache)
    same = torch.equal(vlogits, torch.stack(steps, dim=1))
    greedy = torch.argmax(vlogits, dim=-1).to(torch.int32)
    accepted = torch.cumprod((window[:, 1:] == greedy[:, :SPEC_K]).int(),
                             dim=1).sum(dim=1)
    print(f"  verify vs propose on one cache (8 rows, depth {depth}): "
          f"logits bitwise equal {same}, accepted per row "
          f"{accepted.tolist()} of {SPEC_K}", flush=True)
    if not same or int(accepted.min()) != SPEC_K:
        fail("verify is not bitwise the draft's decode steps on the card")


def check_speculative(torch, model, params, card):
    """Phase 10: the speculative engine over phase 5's model and bf16
    weights cut in depth (SPEC_LAYERS, full width), phase 5's trace, k = 3,
    8 slots, max_seq 1024.
    10a exact draft, 10b perturbed draft (blocks and single rounds), 10c
    the reference test's small foreign draft, 10d a 1-replica
    speculative_backend cluster. Returns the kernel launches of its
    runs."""
    from repro_torch.cluster import ClusterConfig, speculative_backend
    from repro_torch.core import TPU_V5E, LatencyModel, SchedulerConfig
    from repro_torch.models import Model
    from repro_torch.serving import HotpathConfig, timing_fingerprint

    t_phase = time.perf_counter()
    cfg = model.cfg
    L = cfg.num_layers
    trace = make_trace(12, cfg.vocab_size, 0, (64, 513), (32, 65), 0.05)
    total = dict.fromkeys(ATTENTION_KERNELS, 0)

    def add(n):
        for k in total:
            total[k] += n.get(k, 0)

    check_verify_determinism(torch, model, params)
    # the same-depth baseline: its cache is the spec engine's _cache_seq
    # deep, so the decode plan splits it as the spec engine's
    base, beng, n, timers = timed_run(
        torch, model, params, trace, "10 baseline (max_seq 1028)",
        num_slots=8, max_seq=1024 + SPEC_K + 1, cache_dtype=torch.bfloat16,
        capacity=8 * 1024)
    add(n)
    dec = timers.get("decode", [])
    base_ms = sum(ms for ms, _ in dec)
    base_tok_ms = base_ms / max(sum(r.generated - 1 for r in base), 1)
    print(f"  10 baseline: {base_ms / max(sum(k for _, k in dec), 1):.2f} "
          f"ms per decode iteration, {base_tok_ms:.3f} ms per decoded "
          f"token ({card}; card-measured)", flush=True)

    def lossless(label, out):
        check_lossless(beng, base, out, label)

    # ---- 10a: the exact draft (the target's own params) ----------------
    out_a, eng, n, timers, wall = serve_spec(torch, model, params, model,
                                             params, trace)
    add(n)
    check_spec_launches("10a", n, timers, L, L)
    report_spec("10a exact draft", eng, out_a, timers, wall, n, base_tok_ms,
                card)
    if not eng.multi_step_blocks:
        fail("10a: no speculative block ran")
    lossless("10a", out_a)
    acc_a = eng.spec_stats()["acceptance_rate"]
    # a second witness for where the shortfall comes from: 10a again with
    # the plain attention versions in place of the kernels, on the card
    with plain_attention():
        out_p, eng_p, n_p, _, wall_p = serve_spec(torch, model, params,
                                                  model, params, trace)
    acc_p = eng_p.spec_stats()["acceptance_rate"]
    same_p = [r.output_tokens for r in out_p] == \
        [r.output_tokens for r in out_a]
    print(f"  10a acceptance: kernels {acc_a:.4f}, plain attention "
          f"versions {acc_p:.4f} ({eng_p.spec_stats()['accepted']}/"
          f"{eng_p.spec_stats()['proposed']}; tokens equal to the kernels' "
          f"run {same_p}; wall {wall_p:.2f} s). The draft holds "
          "committed[:-1], so it computes the last committed token one "
          "position below the target, whose decode attends the padding "
          "k/v its prefill left at position len(prompt) — the reference's "
          "design; the verify-vs-propose check above holds the kernels "
          "bitwise", flush=True)
    if any(n_p.values()):
        fail(f"10a plain: kernels launched on the plain path: {n_p}")
    if acc_a < 1.0 and acc_p >= 1.0:
        fail("10a: the plain attention path accepts every proposal, the "
             "kernels do not")
    del out_p, eng_p

    # ---- 10b: the perturbed draft, blocks and single rounds ------------
    pert = _perturbed(torch, params, 9)
    runs_b = {}
    for name, hp in (("blocks", None),
                     ("single rounds", HotpathConfig(persistent=False))):
        out, eng, n, timers, wall = serve_spec(torch, model, params, model,
                                               pert, trace, hotpath=hp)
        add(n)
        check_spec_launches(f"10b {name}", n, timers, L, L)
        report_spec(f"10b perturbed draft, {name}", eng, out, timers, wall,
                    n, base_tok_ms, card)
        runs_b[name] = [(r.output_tokens, r.emit_times, r.preemptions)
                        for r in out]
        lossless(f"10b {name}", out)
    if runs_b["blocks"] != runs_b["single rounds"]:
        fail("10b: blocks and single rounds differ in tokens, emit times "
             "or preemptions")
    print("  10b: blocks and single rounds bit-for-bit identical (tokens, "
          "emit times, preemptions)", flush=True)
    del pert
    torch.cuda.empty_cache()

    # ---- 10c: the reference test's small foreign draft -----------------
    small = Model(dataclasses.replace(
        cfg, name=cfg.name + "-draft", num_layers=1, d_model=128,
        num_heads=4, num_kv_heads=2, d_ff=256), device="cuda")
    sparams = small.init(torch.Generator(device="cuda").manual_seed(7),
                         torch.bfloat16)
    out, eng, n, timers, wall = serve_spec(torch, model, params, small,
                                           sparams, trace)
    add(n)
    check_spec_launches("10c", n, timers, L, 1)
    report_spec("10c foreign draft (1 layer, d 128, hd 32)", eng, out,
                timers, wall, n, base_tok_ms, card)
    lossless("10c", out)
    del small, sparams

    # ---- 10d: a 1-replica speculative_backend cluster over 10a ---------
    lat = LatencyModel(cfg, TPU_V5E)
    res, per, n, wall = run_fleet(torch, lat, ClusterConfig(
        n_replicas=1, router="round_robin", scheduler="andes",
        kv_capacity_tokens=8 * 1024, sched_cfg=SchedulerConfig(delta_t=50.0),
        backend_factory=speculative_backend(
            model, params, model, params, spec_k=SPEC_K, num_slots=8,
            max_seq=1024, capacity_tokens=8 * 1024,
            cache_dtype=torch.bfloat16, device=model.device)), trace)
    add(n)
    routed = sorted(res.admitted, key=lambda r: r.rid)
    same_t = timing_fingerprint(routed) == timing_fingerprint(out_a)
    same_tok = [r.output_tokens for r in routed] == \
        [r.output_tokens for r in out_a]
    (timers, _), = per.values()
    check_spec_launches("10d", n, timers, L, L)
    print(f"  10d 1-replica speculative_backend cluster vs the bare spec "
          f"engine: timing identical {same_t}, tokens identical {same_tok}, "
          f"wall {wall:.2f} s", flush=True)
    if not same_t or not same_tok or res.shed:
        fail("10d: the 1-replica speculative cluster differs from the bare "
             "speculative engine")
    print(f"  phase 10 wall {time.perf_counter() - t_phase:.2f} s; launches "
          f"{total}", flush=True)
    return total


# ---------------------------------------------------------------------------
# phase 11: the full-width qwen2-moe-a2.7b engine
# ---------------------------------------------------------------------------

# Paged against contiguous at capacity 1 per expert: the requests whose
# tokens differ, and those beyond a near-tie, in the recorded run (NVIDIA
# H100 80GB HBM3, 700 W; both layouts are deterministic, so a rerun
# repeats them). More means the layouts drifted further apart.
MOE_CAP1_FLIPS = 9
MOE_CAP1_REAL = 3


def _count_moe_drops(counts):
    """Wrap `moe.route` to add, on the device, the routed assignments and
    the kept ones of every call over `counts["slots"]` tokens (a decode
    step over every slot); returns the restore function."""
    from repro_torch.models import moe as moe_lib
    route = moe_lib.route

    def counted(router, xt, cfg, valid=None):
        plan = route(router, xt, cfg, valid)
        if xt.shape[0] == counts["slots"]:
            counts["routed"] += plan["keep"].numel()
            counts["kept"] = counts["kept"] + plan["keep"].sum()
        return plan
    moe_lib.route = counted

    def restore():
        moe_lib.route = route
    return restore


@contextlib.contextmanager
def plain_attention():
    """Route the model's three attention entry points to their plain
    PyTorch versions, on the card, for the duration."""
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref
    names = ("attention", "decode_attention", "paged_decode_attention")
    saved = {n: getattr(ops, n) for n in names}
    ops.attention = ref.attention_ref
    ops.decode_attention = ref.decode_attention_ref
    ops.paged_decode_attention = ref.paged_decode_attention_ref
    try:
        yield
    finally:
        for n, f in saved.items():
            setattr(ops, n, f)


def check_plain_logits(torch, model, params, prompt, frames=None,
                       patches=0):
    """One prompt's last-token logits on the card (the kernels) against
    the plain path on the card (the kernels' plain versions): finite, of
    the vocab's width, the same top token or a bf16 near-tie. An
    encoder-decoder's prompt takes `frames`; a vlm's takes a prefix of
    `patches` synthetic patches, which the cache's length must count."""
    import numpy as np
    from repro_torch.serving import synthetic_patches
    toks = torch.as_tensor(np.asarray(prompt, np.int32))[None].cuda()
    batch, enc_seq = {"tokens": toks}, 0
    if frames is not None:
        batch["frames"] = frames[None].cuda()
        enc_seq = frames.shape[0]
    if patches:
        batch["patch_embeds"] = synthetic_patches(model.cfg, [0], patches,
                                                  device="cuda")

    def run():
        lg, cache = model.prefill(params, batch, model.init_cache(
            1, toks.shape[1] + patches + 1, enc_seq=enc_seq,
            dtype=torch.bfloat16))
        if int(cache["length"][0]) != toks.shape[1] + patches:
            fail(f"prefill cache length {int(cache['length'][0])} for "
                 f"{toks.shape[1]} tokens and {patches} patches")
        return lg.float()[0]
    kern = run()
    with plain_attention():
        plain = run()
    if kern.shape != (model.cfg.vocab_size,) or \
            not bool(torch.isfinite(kern).all()):
        fail(f"bad logits: shape {tuple(kern.shape)}")
    top_k, top_p = int(kern.argmax()), int(plain.argmax())
    margin = float(plain[top_p] - plain[top_k])
    what = (f" behind {patches} patches (cache length "
            f"{toks.shape[1] + patches})" if patches else
            f" over {enc_seq} frames" if enc_seq else "")
    print(f"  logits (1 x {toks.shape[1]}{what}) finite, shape "
          f"{tuple(kern.shape)}"
          f"; vs the plain path on the card: max |diff| "
          f"{float((kern - plain).abs().max()):.4f} (max |logit| "
          f"{float(plain.abs().max()):.3f}), top token {top_k} vs {top_p}"
          f" (margin {margin:.4f})", flush=True)
    if top_k != top_p and margin > BF16_FLIP_TOL:
        fail("the card's logits disagree with the plain path beyond a "
             "near-tie")


def moe_run(torch, model, params, trace, name, drops=None, **kw):
    """One MoE engine run (8 slots, max_seq 1024, bf16) with its eager
    prefill calls timed, the launch counters set to 0 just before and
    read just after, and (with `drops`) the decode routing counted.
    Checks the launches: flash = layers per prefill call, decode or paged
    decode = layers per decode iteration. Returns (out, eng, launches)."""
    from repro_torch.kernels import cuda as kc
    L = model.cfg.num_layers
    prefill = model.prefill
    timers = {}

    def timed_prefill(*a, **k):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = prefill(*a, **k)
        torch.cuda.synchronize()
        timers.setdefault("prefill", []).append(
            ((time.perf_counter() - t0) * 1e3, tuple(a[1]["tokens"].shape)))
        return res
    model.prefill = timed_prefill
    restore = _count_moe_drops(drops) if drops else (lambda: None)
    try:
        torch.cuda.synchronize()
        kc.reset_launches()
        t = time.perf_counter()
        out, eng = serve(model, params, trace, num_slots=8, max_seq=1024,
                         cache_dtype=torch.bfloat16, capacity=8 * 1024,
                         timers=timers, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = dict(kc.launches)
    finally:
        del model.prefill
        restore()
    report_run(name, eng, out, timers, wall, n)
    calls = len(timers.get("prefill", []))
    iters = sum(k for _, k in timers.get("decode", []))
    paged = "page_size" in kw
    want = {"flash_attention": L * calls,
            "decode_attention": 0 if paged else L * iters,
            "paged_decode_attention": L * iters if paged else 0}
    if eng.physical_pages != paged:
        fail(f"engine {name}: physical_pages={eng.physical_pages}")
    if any(rows != 1 for rows, _ in eng.hotpath_stats()["prefill_shapes"]):
        fail(f"engine {name}: a MoE prefill was batched or bucketed")
    for k, v in want.items():
        if n[k] != v:
            fail(f"engine {name}: {n[k]} {k} launches, expected {v} "
                 f"({calls} prefill calls, {iters} decode iterations)")
    return out, eng, n


def check_moe_engine(torch, card):
    """Phase 11: the full-width qwen2-moe-a2.7b engine (24 layers, 60
    routed experts + 4 shared, top-4; bf16, seed 0) over phase 5's trace
    with ids from its vocab, over the physical page pool (page 16) and the
    contiguous cache, and the contiguous run again. Decode routes every
    slot, empty ones included, and an empty slot reads different k/v in
    the two layouts (its own row's position 0 against the pool's clamped
    sentinel page), so at capacity 1 per expert the layouts may drop
    different assignments of the live rows: the pair must share one
    timing fingerprint, and its token flips are reported. The pair again
    with the capacity factor at E / k (nothing drops, so no slot is
    coupled to another) must agree on tokens up to bf16 near-ties, and
    the contiguous rerun bitwise (the combine sums in a fixed order).
    Returns the kernel launches of its runs."""
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG
    from repro_torch.models import moe as moe_lib
    from repro_torch.serving import audit_flips, timing_fingerprint

    t_phase = time.perf_counter()
    model, params = full_width_model(torch, CONFIG)
    m = CONFIG.moe
    trace = make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65), 0.05)
    total = dict.fromkeys(ATTENTION_KERNELS, 0)

    def run(name, drops=None, **kw):
        out, eng, n = moe_run(torch, model, params, trace, name, drops, **kw)
        for k in total:
            total[k] += n[k]
        return out

    drops = dict(slots=8, routed=0, kept=0)
    a = run("moe paged16", drops, page_size=16)
    b = run("moe contiguous")
    c = run("moe contiguous rerun")
    if timing_fingerprint(a) != timing_fingerprint(b):
        fail("moe: paged and contiguous engines differ in timing")
    if [(r.output_tokens, r.emit_times) for r in b] != \
            [(r.output_tokens, r.emit_times) for r in c]:
        fail("moe: two contiguous runs differ: the card run is not "
             "deterministic")
    flips = audit_flips(model, params, a, b, tol=BF16_FLIP_TOL)
    real = [f for f in flips if f["classification"] != "documented_ulp_flip"]
    print(f"  moe paged vs contiguous: timing identical; contiguous rerun "
          f"bitwise identical; {len(flips)} requests with token "
          f"differences ({len(real)} beyond a near-tie; recorded "
          f"{MOE_CAP1_FLIPS} and {MOE_CAP1_REAL}), flips {flips} (tol "
          f"{BF16_FLIP_TOL}; empty-slot routing at capacity 1 differs "
          "between the layouts)", flush=True)
    if len(flips) > MOE_CAP1_FLIPS or len(real) > MOE_CAP1_REAL:
        fail(f"moe: paged and contiguous differ in {len(flips)} requests, "
             f"{len(real)} beyond a near-tie: more than the recorded "
             f"{MOE_CAP1_FLIPS} and {MOE_CAP1_REAL}")
    kept = int(drops["kept"])
    print(f"  moe decode routing (paged run; {card}): "
          f"{drops['routed'] - kept} of {drops['routed']} routed "
          f"assignments dropped at capacity "
          f"{int(moe_lib.CAPACITY_FACTOR * 8 * m.top_k / m.num_experts) + 1}"
          f" per expert = {1 - kept / max(drops['routed'], 1):.4f}",
          flush=True)
    saved = moe_lib.CAPACITY_FACTOR
    moe_lib.CAPACITY_FACTOR = m.num_experts / m.top_k     # cap = t
    try:
        a = run("moe paged16, no drop", page_size=16)
        b = run("moe contiguous, no drop")
    finally:
        moe_lib.CAPACITY_FACTOR = saved
    if timing_fingerprint(a) != timing_fingerprint(b):
        fail("moe no drop: paged and contiguous engines differ in timing")
    check_bf16_flips(model, params, a, b, "moe paged vs contiguous, no drop")
    check_plain_logits(torch, model, params, a[0].prompt_tokens)
    profile_engine_steps(torch, model, params)
    print(f"  phase 11 wall {time.perf_counter() - t_phase:.2f} s; launches "
          f"{total}", flush=True)
    del model, params
    return total


# ---------------------------------------------------------------------------
# phase 12: the full-width encoder-decoder and vision-language engines
# ---------------------------------------------------------------------------

# the same probe for seamless-m4t-medium: 12 swap preemptions on the
# virtual clock
SEAMLESS_TIGHT_CAPACITY = 2048
VLM_PATCHES = 64


def check_launches(name, n, want):
    for k, v in want.items():
        if n[k] != v:
            fail(f"engine {name}: {n[k]} {k} launches, expected {v}")


def check_encdec_engine(torch):
    """Phase 12a: the full-width seamless-m4t-medium engine (12 encoder +
    12 decoder layers, no RoPE; bf16, seed 0) over phase 5's trace, each
    request carrying `synthetic_frames` keyed by its rid (enc_seq 256):
    ample capacity, a capacity that forces swap preemption, and ample
    again on the plain attention versions. Per prefill group the encoder,
    the decoder's self-attention and its cross-attention launch flash once
    a layer; per decode iteration each decoder layer launches decode
    (self) and flash at Sq = 1 (cross). Then the same prompts with zero
    frames, which must change some tokens. Returns the launches."""
    from repro_torch.configs.seamless_m4t_medium import CONFIG
    from repro_torch.serving import first_divergence, timing_fingerprint

    t_phase = time.perf_counter()
    model, params = full_width_model(torch, CONFIG)
    enc_seq = model.enc_seq(1024)
    L, Le = CONFIG.num_layers, CONFIG.num_encoder_layers
    trace = with_frames(
        make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65), 0.05),
        CONFIG, enc_seq)
    common = dict(num_slots=8, max_seq=1024, cache_dtype=torch.bfloat16)
    total = dict.fromkeys(ATTENTION_KERNELS, 0)
    runs, engs = {}, {}
    for name, cap, plain in (("seamless ample", 8 * 1024, False),
                             ("seamless tight", SEAMLESS_TIGHT_CAPACITY,
                              False),
                             ("seamless plain", 8 * 1024, True)):
        with plain_attention() if plain else contextlib.nullcontext():
            runs[name], engs[name], n, timers = timed_run(
                torch, model, params, trace, name, capacity=cap, **common)
        groups = len(timers.get("prefill", []))
        iters = sum(k for _, k in timers.get("decode", []))
        flash = 0 if plain else (Le + 2 * L) * groups + L * iters
        check_launches(name, n, {
            "flash_attention": flash, "flash_attention/tensor_core": flash,
            "decode_attention": 0 if plain else L * iters,
            "paged_decode_attention": 0})
        for k in total:
            total[k] += n[k]
        print(f"  {name}: {groups} prefill groups x {Le + 2 * L} flash, "
              f"{iters} decode iterations x ({L} decode + {L} flash at "
              f"Sq = 1); preemptions {engs[name].preemptions}", flush=True)
    if not engs["seamless tight"].preemptions:
        fail("engine seamless tight: no preemption")
    if engs["seamless ample"].preemptions:
        fail("engine seamless ample preempted")
    ample = runs["seamless ample"]
    if timing_fingerprint(ample) != timing_fingerprint(runs["seamless plain"]):
        fail("seamless: the kernels' and the plain run differ in timing")
    swapped = engs["seamless tight"].kv.swap_bytes_total / 1e6
    print(f"  seamless tight: {swapped:.1f} MB of k/v and cross k/v swapped "
          "out to host memory; ample vs plain: timing identical", flush=True)
    for other in ("seamless tight", "seamless plain"):
        check_bf16_flips(model, params, ample, runs[other],
                         f"seamless ample vs {other.split()[1]}",
                         engine=engs["seamless ample"])
    zero, _ = serve(model, params, [r.clone() for r in trace],
                    capacity=8 * 1024, **common)
    n_div = sum(first_divergence(a.output_tokens, b.output_tokens)
                is not None for a, b in zip(ample, zero))
    print(f"  seamless with zero frames: {n_div} of {len(zero)} requests' "
          "tokens differ from the run with each request's frames",
          flush=True)
    if not n_div:
        fail("seamless: the encoder memory does not condition the output")
    check_plain_logits(torch, model, params, ample[0].prompt_tokens,
                       frames=trace[0].frames)
    profile_engine_steps(torch, model, params)
    print(f"  phase 12a wall {time.perf_counter() - t_phase:.2f} s; launches "
          f"{total}", flush=True)
    del model, params
    return total


def check_vlm_engine(torch):
    """Phase 12b: the full-width pixtral-12b engine (40 layers, 32/8 heads
    of hd 128; bf16, seed 0) over phase 5's trace, over the page pool
    (page 16) and the contiguous cache (the engine passes no patches, as
    the reference's): one timing fingerprint, tokens up to bf16 near-ties,
    flash = 40 per prefill group, decode or paged decode = 40 per decode
    iteration. Then one prefill with a 64-patch prefix, kernels against
    the plain path. Returns the launches."""
    from repro_torch.configs.pixtral_12b import CONFIG
    from repro_torch.serving import timing_fingerprint

    t_phase = time.perf_counter()
    model, params = full_width_model(torch, CONFIG)
    L = CONFIG.num_layers
    trace = make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65), 0.05)
    common = dict(num_slots=8, max_seq=1024, cache_dtype=torch.bfloat16,
                  capacity=8 * 1024)
    total = dict.fromkeys(ATTENTION_KERNELS, 0)
    runs = {}
    for name, kw in (("pixtral paged16", dict(page_size=16)),
                     ("pixtral contiguous", dict())):
        runs[name], eng, n, timers = timed_run(torch, model, params, trace,
                                               name, **common, **kw)
        groups = len(timers.get("prefill", []))
        iters = sum(k for _, k in timers.get("decode", []))
        paged = "page_size" in kw
        if eng.physical_pages != paged:
            fail(f"engine {name}: physical_pages={eng.physical_pages}")
        check_launches(name, n, {
            "flash_attention": L * groups,
            "flash_attention/tensor_core": L * groups,
            "decode_attention": 0 if paged else L * iters,
            "paged_decode_attention": L * iters if paged else 0})
        for k in total:
            total[k] += n[k]
    a, b = runs["pixtral paged16"], runs["pixtral contiguous"]
    if timing_fingerprint(a) != timing_fingerprint(b):
        fail("pixtral: paged and contiguous engines differ in timing")
    print("  pixtral paged vs contiguous: timing identical", flush=True)
    check_bf16_flips(model, params, a, b, "pixtral paged vs contiguous")
    check_plain_logits(torch, model, params, a[0].prompt_tokens,
                       patches=VLM_PATCHES)
    profile_engine_steps(torch, model, params)
    print(f"  phase 12b wall {time.perf_counter() - t_phase:.2f} s; launches "
          f"{total}", flush=True)
    del model, params
    return total


# ---------------------------------------------------------------------------
# phase 13: training
# ---------------------------------------------------------------------------

BWD_TOL = {"float32": 1e-4, "bfloat16": 2e-2}   # relative to max |grad|
BWD_KERNELS = ("flash_attention_bwd_dkdv", "flash_attention_bwd_dq")
# products of 2 hd FLOPs per attended (query, key, head) pair: the whole
# backward needs S, dP, dV, dK and dQ; dK/dV needs the first four, dQ S,
# dP and dQ (each kernel recomputes S and dP)
BWD_PRODUCTS = {"backward": 5, "flash_attention_bwd_dkdv": 4,
                "flash_attention_bwd_dq": 3}
BWD_CASES = (
    # (label, b, sq, sk, h, kv, hd, causal, lengths, window)
    ("granite-3-2b training: 8 x 512, H 32, KV 8, hd 64, causal",
     8, 512, 512, 32, 8, 64, True, None, None),
    ("llama3-8b heads: 4 x 512, H 32, KV 8, hd 128, causal",
     4, 512, 512, 32, 8, 128, True, None, None),
    ("zamba2 heads: 4 x 512, H = KV = 32, hd 80, causal",
     4, 512, 512, 32, 32, 80, True, None, None),
    ("seamless encoder: 4 x 256, H = KV = 16, hd 64, bidirectional, ragged",
     4, 256, 256, 16, 16, 64, False, [256, 200, 131, 64], None),
    ("seamless cross: 2 x 512 over 256, H = KV = 16, hd 64, ragged",
     2, 512, 256, 16, 16, 64, False, [256, 190], None),
    ("window 128: 4 x 512, H 32, KV 8, hd 64, causal",
     4, 512, 512, 32, 8, 64, True, None, 128),
)
TRAIN_ARCHS = ("llama3-8b", "granite-3-2b", "qwen2-moe-a2.7b",
               "seamless-m4t-medium", "pixtral-12b", "falcon-mamba-7b",
               "zamba2-2.7b")
TRAIN_OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10)
GRANITE_STEPS = 10
GRANITE_BATCH = (8, 512)
# 13d / 13e: the scan families, f32 AdamW at 8 x 512. falcon-mamba-7b is
# cut in depth: all 64 layers need 7.26 B params x 16 bytes = 116 GB; 24
# of them (3.06 B params, 48.9 GB) fit the card with their activations
ZAMBA2_STEPS = 5
FALCON_STEPS = 3
FALCON_LAYERS = 24
SCAN_TRAIN_BATCH = (8, 512)


def _bwd_launches(kc, q, k, v, out, lse, dout, *, causal, window,
                  lengths):
    """{kernel name: one launch of that backward kernel alone}, in the
    wrapper's order (dQ, which writes Delta, then dK/dV, which reads it),
    each through `kc._bwd_launch` as `kc.flash_attention_bwd` makes it, on
    gradient and Delta buffers allocated once, so each kernel can be timed
    on its own."""
    dq, dk, dv = (x.new_empty(x.shape) for x in (q, k, v))
    delta = lse.new_empty(lse.shape)        # f32 (B, H, Sq), as lse
    args = (q, k, v, out, lse, dout, lengths, delta)
    opts = (causal, window, None)
    return {
        "flash_attention_bwd_dq": lambda: kc._bwd_launch(
            "flash_attention_bwd_dq", *args, (dq,), *opts),
        "flash_attention_bwd_dkdv": lambda: kc._bwd_launch(
            "flash_attention_bwd_dkdv", *args, (dk, dv), *opts)}


def check_backward_kernels(torch):
    """13a: the flash kernel's lse and the two backward kernels against
    attention_lse_ref / attention_bwd_ref at training shapes, f32 and
    bf16, each timed (L2 flushed) beside its bound, the plain version
    and SDPA's backward (torch.autograd.grad of
    F.scaled_dot_product_attention; a yardstick only); each dtype must
    run its body (bf16 tensor cores, f32 CUDA cores) and two launches
    must agree bitwise. Returns the JSON rows of the two kernels at
    granite's training shape: f32 under the kernels' names, bf16 under
    "<name>/bfloat16"."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels import ref

    flush = _L2Flush(torch)
    sdpa = _sdpa(torch)
    gen = torch.Generator().manual_seed(1)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        tol = BWD_TOL[name]
        peak = F32_FLOPS if dt == torch.float32 else BF16_FLOPS
        for label, b, sq, sk, h, kv, hd, causal, lens, window in BWD_CASES:
            def rnd(*shape):
                return torch.randn(shape, generator=gen).to("cuda", dt)
            q, k, v, dout = (rnd(b, sq, h, hd), rnd(b, sk, kv, hd),
                             rnd(b, sk, kv, hd), rnd(b, sq, h, hd))
            lengths = (None if lens is None else
                       torch.tensor(lens, dtype=torch.int32).cuda())
            kw = dict(causal=causal, window=window, lengths=lengths)
            out, lse = kc.flash_attention(q, k, v, return_lse=True, **kw)
            lse_ref = ref.attention_lse_ref(q, k, v, **kw)
            empty = torch.isinf(lse_ref)
            if not torch.equal(torch.isinf(lse), empty):
                fail(f"13a {label} {name}: lse's empty rows differ")
            lse_err = (lse - lse_ref)[~empty].abs().max().item()
            body = ("flash_attention_bwd/tensor_core" if dt == torch.bfloat16
                    else "flash_attention_bwd/cuda_core")
            n_body = kc.variant_launches[body]
            grads = kc.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            if kc.variant_launches[body] != n_body + 2:
                fail(f"13a {label} {name}: the backward did not run the "
                     f"{body} body twice: {dict(kc.variant_launches)}")
            again = kc.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
            if not all(torch.equal(a, g) for a, g in zip(again, grads)):
                fail(f"13a {label} {name}: two launches of the backward "
                     "differ (it must be deterministic)")
            del again
            expect = ref.attention_bwd_ref(q, k, v, out, lse, dout, **kw)
            # (dq, dk, dv): |difference| and its ratio to max |grad|
            diffs = [(g.float() - e.float()).abs().max().item()
                     for g, e in zip(grads, expect)]
            rels = [d / e.float().abs().max().item()
                    for d, e in zip(diffs, expect)]
            abs_err, err = max(diffs), max(rels)
            if not (err <= tol and lse_err <= tol):
                fail(f"13a {label} {name}: backward disagrees with its plain "
                     f"version: {err:.3e} (lse {lse_err:.3e}, tol {tol})")
            kp = torch.arange(sk, device="cuda")[None, None, :]
            qp = torch.arange(sq, device="cuda")[None, :, None]
            vis = torch.ones((b, sq, sk), dtype=torch.bool, device="cuda")
            if causal:
                vis &= kp <= qp
            if lengths is not None:
                vis &= kp < lengths[:, None, None]
            if window is not None:
                vis &= kp > qp - window
            pairs = int(vis.sum()) * h
            isz = q.element_size()
            # bytes each function reads once and writes once: each reads
            # q, dO, k, v and lse; the whole backward and dQ read O, dQ
            # writes Delta (f32, lse's shape) and dK/dV reads it
            qbytes, stats = b * sq * h * hd * isz, b * h * sq * 4
            shared = 2 * qbytes + 2 * b * sk * kv * hd * isz + stats
            n_bytes = {
                "backward":
                    shared + 2 * qbytes + 2 * b * sk * kv * hd * isz,
                "flash_attention_bwd_dq": shared + 2 * qbytes + stats,
                "flash_attention_bwd_dkdv":
                    shared + stats + 2 * b * sk * kv * hd * isz}
            t = {"backward": time_ms(torch, lambda: kc.flash_attention_bwd(
                q, k, v, out, lse, dout, **kw), flush)}
            for kname, launch in _bwd_launches(
                    kc, q, k, v, out, lse, dout, **kw).items():
                t[kname] = time_ms(torch, launch, flush)
            plain_ms = time_ms(torch, lambda: ref.attention_bwd_ref(
                q, k, v, out, lse, dout, **kw), flush, iters=5, warmup=1)
            lib_ms = None
            if sdpa is not None:
                qs, ks, vs = (x.transpose(1, 2).detach().requires_grad_()
                              for x in (q, k, v))
                # a mask only where lengths or a window need one: with
                # it SDPA cannot skip the tiles above the diagonal
                mask = ({"is_causal": True} if causal and lengths is None
                        and window is None else {"attn_mask": vis[:, None]})
                with torch.enable_grad():
                    o = sdpa(qs, ks, vs, enable_gqa=True, **mask)
                go = dout.transpose(1, 2)
                lib_ms = time_ms(torch, lambda: torch.autograd.grad(
                    o, (qs, ks, vs), go, retain_graph=True), flush)
                del o, qs, ks, vs
            bound = {key: bound_ms(n_bytes[key],
                                   (BWD_PRODUCTS[key] * 2 * hd * pairs,
                                    peak))
                     for key in t}
            print(f"  13a {label}, {name}: max|err| {abs_err:.3e}, "
                  f"max|err|/max|grad| {err:.3e}, "
                  f"lse {lse_err:.3e} (tol {tol}); backward "
                  f"{t['backward']:.4f} ms (dK/dV "
                  f"{t['flash_attention_bwd_dkdv']:.4f} + dQ "
                  f"{t['flash_attention_bwd_dq']:.4f}), bound "
                  f"{bound['backward'][0]:.4f} ms ({bound['backward'][1]}), "
                  f"plain {plain_ms:.4f} ms, SDPA backward "
                  f"{('%.4f ms' % lib_ms) if lib_ms is not None else 'n/a'}"
                  f"; two launches bitwise equal",
                  flush=True)
            if label.startswith("granite"):
                # dK/dV's gradients are the last two, dQ's the first; the
                # f32 rows under the kernels' names, the bf16 ones beside
                for kname, sl in zip(BWD_KERNELS, (slice(1, 3),
                                                   slice(0, 1))):
                    rows[kname if dt == torch.float32 else
                         f"{kname}/{name}"] = dict(
                        dtype=name, body=body.split("/")[1],
                        max_abs_err=max(diffs[sl]), max_rel_err=max(rels[sl]),
                        ms=t[kname], plain_ms=plain_ms,
                        bound_ms=bound[kname][0], bound_by=bound[kname][1],
                        library_ms=lib_ms)
            del q, k, v, dout, out, lse, grads, expect, vis
    print(f"  13a backward launches by body: "
          f"{ {k: n for k, n in kc.variant_launches.items() if 'bwd' in k} }",
          flush=True)
    del flush
    torch.cuda.empty_cache()
    return rows


# the scan backward's rows in 13a: (label, kind, lengths); Mamba-1 at
# falcon-mamba-7b's d_inner 8192, N 16 (dt_rank 256) on the Mamba-1 body;
# Mamba-2 at zamba2-2.7b's NH 80, HD 64, N 64 as ops.ssd trains it: A per
# channel (ops.ssd_channel_args), on the Mamba-2 body
SCAN_BWD_CASES = (
    ("falcon-mamba Mamba-1: 8 x 512, D 8192, N 16", "mamba1", [512] * 8),
    ("zamba2 Mamba-2 via ssd_channel_args: 8 x 512, NH 80, HD 64, N 64",
     "mamba2", [512] * 8),
    ("falcon-mamba Mamba-1, ragged dt: 4 x 512, lengths 512/389/200/64",
     "mamba1", [512, 389, 200, 64]),
)
# f32 operations per (b, t, d, n) the Mamba-1 backward needs: recompute
# h_t (the decay's product, the input's product, the FMA: 4), the adjoint
# (a product and an FMA: 3), sum_n g B (2), g a h_{t-1} (2) and its sums
# into ddt and dA (4), g u and dy h into dB and dC (4); and per (b, t, d):
# u, dx, ddt's x term and dD (7)
SCAN_BWD_FLOPS = (19, 7)
# and the Mamba-2 function's, with one decay per (b, t, head) and A folded
# out of the sums over n: per (b, t, d, n) recompute h_t (the input's
# product and the FMA: 3), the adjoint (an FMA and the carry's product: 3),
# sum_n g B (2), sum_n g h_{t-1} (2), g u and dy h into dB and dC (4); per
# (b, t, d) u, dx, ddt's x term, A a_t r (2), dA's sum and dD (11)
SCAN_BWD_FLOPS_M2 = (14, 11)


def scan_bwd_bound(torch, b, s, d, n, isz, heads=None):
    """The scan backward's bound -> (ms, by, detail). Mamba-1 (`heads`
    None): x, dt, dy, B, C, A and D read once, dx, ddt, dB, dC, dA and dD
    written once, against SCAN_BWD_FLOPS over the f32 peak and one exp per
    (b, t, d, n). Mamba-2 with `heads` heads over the d channels, the
    function's own work: x, dy, dx per channel, dt and ddt per head, B,
    C, dB, dC, and A, D, dA, dD per head, against SCAN_BWD_FLOPS_M2 and
    one exp per (b, t, head)."""
    el = b * s * d
    if heads is None:
        nbytes = 5 * el * isz + 4 * b * s * n * isz + 2 * (d * n + d) * 4
        per, n_exp = SCAN_BWD_FLOPS, el * n
    else:
        nbytes = (3 * el * isz + 2 * b * s * heads * isz
                  + 4 * b * s * n * isz + 4 * heads * 4)
        per, n_exp = SCAN_BWD_FLOPS_M2, b * s * heads
    flops = per[0] * el * n + per[1] * el
    rate = exp_rate(torch)
    b_ms, b_by = bound_ms(nbytes, (flops, F32_FLOPS), (n_exp, rate))
    return b_ms, b_by, (
        f"bytes {nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, f32 FLOPs "
        f"{flops / F32_FLOPS * 1e3:.4f} ms ({per[0]} per (b, t, d, n)), "
        f"{n_exp / 1e6:.1f} M exp {n_exp / rate * 1e3:.4f} ms")


def scan_bwd_bodies(cfg) -> dict:
    """Scan-backward launches of one train step by body: one per Mamba
    layer, on the Mamba-1 body (ssm version 1, ops.selective_scan) or the
    Mamba-2 body (version 2, ops.ssd)."""
    n = len(cfg.ssm_layer_ids())
    v = cfg.ssm.version if n else 1
    return {"selective_scan_bwd/mamba1": n if v == 1 else 0,
            "selective_scan_bwd/mamba2": n if v == 2 else 0}


def check_scan_backward(torch):
    """13a, the scan: the forward's chunk states and the backward kernel
    (csrc/selective_scan_bwd.cu) against selective_scan_bwd_ref at
    falcon-mamba's and zamba2's training shapes (SCAN_BWD_CASES), f32
    (1e-4) and bf16 (2e-2), each gradient relative to its max magnitude,
    each on its body (Mamba-1; zamba2 on the Mamba-2 body, A per channel,
    as ops.ssd trains); y must be bitwise the same with and without the
    chunk states, two backward launches bitwise equal. Timed with L2
    flushed beside its bound (the Mamba-2 function's own for zamba2) and
    the plain version (no one PyTorch call computes it); the dB / dC
    partial bytes printed beside each row. Returns the 8 x 512 rows:
    falcon-mamba's f32 under the kernel's name, bf16 under
    "selective_scan_bwd/bfloat16", zamba2's under
    "selective_scan_bwd/mamba2[/bfloat16]"."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref

    flush = _L2Flush(torch)
    gen = torch.Generator().manual_seed(2)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt).split(".")[1]
        tol = BWD_TOL[name]
        for label, kind, lengths in SCAN_BWD_CASES:
            heads = None
            if kind == "mamba1":
                args = scan_inputs(torch, gen, lengths, dt)
            else:
                raw = ssd_inputs(torch, gen, lengths, dt)
                heads = raw[2].shape[0]
                args = ops.ssd_channel_args(*raw)
            b, s, d = args[0].shape
            n = args[3].shape[-1]
            y0 = kc.selective_scan(*args)
            y, states, plan = kc.selective_scan(*args, save_states=True)
            if not torch.equal(y, y0):
                fail(f"13a {label} {name}: y differs with the chunk states")
            dy = torch.randn((b, s, d), generator=gen).to("cuda", dt)
            v0 = kc.variant_launches[f"selective_scan_bwd/{kind}"]
            grads = kc.selective_scan_bwd(*args, states, dy, plan)
            again = kc.selective_scan_bwd(*args, states, dy, plan)
            if kc.variant_launches[f"selective_scan_bwd/{kind}"] != v0 + 2:
                fail(f"13a {label} {name}: the backward did not run its "
                     f"{kind} body")
            if not all(torch.equal(a, g) for a, g in zip(again, grads)):
                fail(f"13a {label} {name}: two launches of the scan "
                     "backward differ (it must be deterministic)")
            del again, y0, y
            expect = ref.selective_scan_bwd_ref(*args, dy)
            # (dx, ddt, dA, dB, dC, dD): |difference| and its ratio to
            # max |grad|
            diffs = [(g.float() - e.float()).abs().max().item()
                     for g, e in zip(grads, expect)]
            rels = [df / max(e.float().abs().max().item(), 1e-30)
                    for df, e in zip(diffs, expect)]
            if not max(rels) <= tol:
                fail(f"13a {label} {name}: scan backward disagrees with its "
                     f"plain version: relative errors {rels} (tol {tol})")
            del expect
            ms = time_ms(torch, lambda: kc.selective_scan_bwd(
                *args, states, dy, plan), flush)
            plain_ms = time_ms(torch, lambda: ref.selective_scan_bwd_ref(
                *args, dy), flush, iters=3, warmup=1)
            b_ms, b_by, detail = scan_bwd_bound(torch, b, s, d, n,
                                                args[0].element_size(), heads)
            ncl = -(-d // kc.SCAN_CHANNELS) // kc.scan_bwd_cluster(d)
            part_mb = 2 * b * s * ncl * n * 4 / 1e6
            print(f"  13a scan {label}, {name}, {kind} body: max|err| "
                  f"{max(diffs):.3e}, max|err|/max|grad| {max(rels):.3e} "
                  f"(tol {tol}; dx, ddt, dA, dB, dC, dD: "
                  f"{', '.join('%.1e' % r for r in rels)}); forward plan "
                  f"{plan.npl} states per thread, {plan.steps} steps per "
                  f"chunk; backward {ms:.4f} ms, bound {b_ms:.4f} ms "
                  f"({b_by}: {detail}; kernel/bound {ms / b_ms:.2f}), plain "
                  f"{plain_ms:.4f} ms, library none; dB/dC partials "
                  f"{part_mb:.1f} MB f32 ({kc.scan_bwd_cluster(d)} channel "
                  f"blocks a cluster), written once and read once; y "
                  f"bitwise unchanged by the chunk states "
                  f"({tuple(states.shape)} f32, "
                  f"{states.numel() * 4 / 1e6:.1f} MB); two launches bitwise "
                  f"equal", flush=True)
            if lengths == [512] * 8:
                key = "selective_scan_bwd" + (
                    "/mamba2" if kind == "mamba2" else "") + (
                    "" if dt == torch.float32 else f"/{name}")
                rows[key] = dict(
                    dtype=name, body=kind, max_abs_err=max(diffs),
                    max_rel_err=max(rels), ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    partial_mb=part_mb)
            del args, dy, grads, states
            torch.cuda.empty_cache()
    del flush
    torch.cuda.empty_cache()
    return rows


def _train_batch(torch, cfg, b, s, seed, device):
    """tokens, next-token labels (a few set to -1), and frames or patch
    embeddings where the kind takes them, made with numpy."""
    import numpy as np
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)
    labels = np.roll(tokens, -1, axis=1)
    labels[0, :3] = -1
    batch = {"tokens": tokens, "labels": labels}
    if cfg.kind in ("encdec", "audio"):
        batch["frames"] = (rng.normal(size=(b, s, cfg.d_model))
                           * 0.1).astype(np.float32)
    if cfg.kind == "vlm":
        batch["patch_embeds"] = (rng.normal(size=(b, 4, cfg.d_model))
                                 * 0.1).astype(np.float32)
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def _excess(got, want, rtol):
    """max over elements of |got - want| - rtol |want|: allclose passes
    when it is at most atol"""
    return ((got.float().cpu() - want.float()).abs()
            - rtol * want.float().abs()).max().item()


def check_small_training(torch):
    """13b: smoke-size training, f32, on the card (kernels) against the
    same on the CPU (plain versions): the loss and every gradient of one
    remat loss, the backward launches equal to the attention calls and
    to the Mamba layers (the forwards twice, under remat), then one train
    step (loss, grad norm, params after AdamW); 50 llama3 steps must lower
    the loss by more than 1.0."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import cuda as kc
    from repro_torch.models import Model
    from repro_torch.training import (OptimizerConfig, build_train_step,
                                      init_opt_state, packed_batches,
                                      value_and_grad)
    from repro_torch.training.optimizer import leaves

    print(f"  torch.backends.cuda.matmul.allow_tf32 = "
          f"{torch.backends.cuda.matmul.allow_tf32} (f32 products in f32)",
          flush=True)
    for arch in TRAIN_ARCHS:
        cfg = get_smoke_config(arch)
        n_attn = (cfg.num_encoder_layers + 2 * cfg.num_layers
                  if cfg.kind in ("encdec", "audio")
                  else len(cfg.attn_layer_ids()))
        n_scan = len(cfg.ssm_layer_ids())
        models = {d: Model(cfg, remat=True, device=d) for d in ("cpu", "cuda")}
        params = {"cpu": models["cpu"].init(torch.Generator().manual_seed(0))}
        params["cuda"] = _to(params["cpu"], "cuda")
        batch = {d: _train_batch(torch, cfg, 2, 32, 1, d)
                 for d in ("cpu", "cuda")}
        loss_c, grads_c = value_and_grad(models["cpu"], params["cpu"],
                                         batch["cpu"])
        kc.reset_launches()
        loss_g, grads_g = value_and_grad(models["cuda"], params["cuda"],
                                         batch["cuda"])
        n = dict(kc.launches, **kc.variant_launches)
        want = {"flash_attention": 2 * n_attn,
                "flash_attention_bwd_dq": n_attn,
                "flash_attention_bwd_dkdv": n_attn,
                "selective_scan": 2 * n_scan, "selective_scan_bwd": n_scan,
                **scan_bwd_bodies(cfg)}
        if any(n[k] != v for k, v in want.items()) or n["decode_attention"]:
            fail(f"13b {arch}: launches {n}, expected {want}")
        loss_err = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
        grad_err = max(_excess(g, c, 2e-4)
                       for g, c in zip(leaves(grads_g), leaves(grads_c)))
        steps = {d: build_train_step(models[d], OptimizerConfig(**TRAIN_OPT))
                 for d in ("cpu", "cuda")}
        met = {}
        for d in ("cpu", "cuda"):
            opt = init_opt_state(params[d])
            params[d], _, met[d] = steps[d](params[d], opt, batch[d])
        gn_err = abs(met["cuda"]["grad_norm"].item()
                     - met["cpu"]["grad_norm"].item()) \
            / met["cpu"]["grad_norm"].item()
        p_err = max(_excess(g, c, 2e-4) for g, c in zip(
            leaves(params["cuda"]), leaves(params["cpu"])))
        print(f"  13b {arch} smoke: loss {loss_g.item():.6f} vs CPU "
              f"{loss_c.item():.6f} (rel {loss_err:.2e}), gradients "
              f"max(|diff| - 2e-4|cpu|) {grad_err:.2e}, grad norm rel "
              f"{gn_err:.2e}, params after AdamW {p_err:.2e} (atol 2e-5); "
              f"launches flash {n['flash_attention']} = 2 x {n_attn} "
              f"attention calls (remat), dQ {n['flash_attention_bwd_dq']}, "
              f"dK/dV {n['flash_attention_bwd_dkdv']}; scan "
              f"{n['selective_scan']} = 2 x {n_scan} Mamba layers, scan "
              f"backward {n['selective_scan_bwd']} (Mamba-1 body "
              f"{n['selective_scan_bwd/mamba1']}, Mamba-2 body "
              f"{n['selective_scan_bwd/mamba2']})", flush=True)
        if not (loss_err <= 1e-5 and grad_err <= 2e-5 and gn_err <= 1e-5
                and p_err <= 2e-5):
            fail(f"13b {arch}: the card's train step disagrees with the CPU's")
    cfg = get_smoke_config("llama3-8b")
    m = Model(cfg, device="cuda")
    p = m.init(torch.Generator("cuda").manual_seed(0))
    opt = init_opt_state(p)
    step = build_train_step(m, OptimizerConfig(lr=1e-3, warmup_steps=5,
                                               total_steps=50))
    it = packed_batches(cfg.vocab_size, 8, 64, seed=0)
    losses = []
    for _ in range(50):
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(it).items()}
        p, opt, met = step(p, opt, batch)
        losses.append(met["loss"].item())
    print(f"  13b llama3 smoke, 50 steps on the card: loss {losses[0]:.4f} "
          f"-> {losses[-1]:.4f}", flush=True)
    if not losses[-1] < losses[0] - 1.0:
        fail("13b llama3 smoke: 50 steps did not lower the loss by 1.0")


def check_granite_training(torch, card):
    """13c: full-width, full-depth granite-3-2b (40 layers, d 2048, 32/8
    heads of hd 64, vocab 49155, tied), f32 params and AdamW, remat on,
    batch 8 x 512 from packed_batches, GRANITE_STEPS steps through
    build_train_step, the launch counters set to 0 before each step and
    read after: flash 80 (40 + 40 recomputed), dQ = dK/dV = 40 (f32: the
    CUDA-core backward body, 80 launches). Then a
    checkpoint saved and restored bitwise. Returns the launches."""
    import tempfile

    from repro_torch.configs.granite_3_2b import CONFIG
    from repro_torch.kernels import cuda as kc
    from repro_torch.models import Model
    from repro_torch.training import (OptimizerConfig, build_train_step,
                                      init_train_state, packed_batches,
                                      restore_checkpoint, save_checkpoint)
    from repro_torch.training.optimizer import leaves

    t_phase = time.perf_counter()
    model = Model(CONFIG, device="cuda")
    params, opt = init_train_state(
        model, torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in leaves(params))
    L = CONFIG.num_layers
    b, s = GRANITE_BATCH
    step = build_train_step(model, OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=GRANITE_STEPS))
    data = packed_batches(CONFIG.vocab_size, b, s, seed=0)
    total = dict.fromkeys(("flash_attention",) + BWD_KERNELS, 0)
    want = {"flash_attention": 2 * L, "flash_attention_bwd_dq": L,
            "flash_attention_bwd_dkdv": L}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    print(f"  granite-3-2b: {n_params / 1e9:.3f} B params, f32 params + "
          f"grads + AdamW moments; batch {b} x {s}; init "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    walls, losses = [], []
    for i in range(GRANITE_STEPS):
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
        kc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        loss, gnorm = met["loss"].item(), met["grad_norm"].item()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        n = {k: kc.launches[k] for k in total}
        if (n != want or kc.launches["decode_attention"]
                or kc.variant_launches["flash_attention_bwd/cuda_core"]
                != 2 * L):
            fail(f"13c granite step {i + 1}: launches {dict(kc.launches)}, "
                 f"by body {dict(kc.variant_launches)}, expected {want} "
                 f"and {2 * L} backward launches on the CUDA-core body")
        for k in total:
            total[k] += n[k]
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"13c granite step {i + 1}: loss {loss}, grad norm {gnorm}")
        print(f"  13c step {i + 1}: loss {loss:.4f}, grad norm {gnorm:.4f}, "
              f"wall {walls[-1]:.3f} s", flush=True)
    peak = torch.cuda.max_memory_allocated()
    steady = walls[1:]
    wall = sum(steady) / len(steady)
    print(f"  13c granite-3-2b ({card}): {wall:.3f} s per step (steps "
          f"2-{GRANITE_STEPS}; step 1 {walls[0]:.3f} s), "
          f"{b * s / wall:.0f} tokens/s, peak memory allocated "
          f"{peak / 1e9:.2f} GB; loss {losses[0]:.4f} -> {losses[-1]:.4f}",
          flush=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
    profile_train_step(torch, lambda: step(params, opt, batch))
    with tempfile.TemporaryDirectory() as d:
        path = str(Path(d) / "granite.npz")
        t0 = time.perf_counter()
        save_checkpoint(path, params, opt, step=GRANITE_STEPS + 1)
        t_save = time.perf_counter() - t0
        size = Path(path).stat().st_size
        t0 = time.perf_counter()
        p2, o2, got = restore_checkpoint(path, params, opt)
        t_load = time.perf_counter() - t0
        same = got == GRANITE_STEPS + 1 and all(
            torch.equal(x, y) for x, y in zip(
                leaves({"p": params, "mu": opt.mu, "nu": opt.nu,
                        "s": opt.step}),
                leaves({"p": p2, "mu": o2.mu, "nu": o2.nu, "s": o2.step})))
        del p2, o2
    print(f"  13c checkpoint: {size / 1e9:.2f} GB saved in {t_save:.1f} s, "
          f"restored in {t_load:.1f} s, bitwise {same}", flush=True)
    if not same:
        fail("13c granite checkpoint did not restore bitwise")
    print(f"  phase 13c wall {time.perf_counter() - t_phase:.2f} s; "
          f"launches {total}", flush=True)
    del params, opt, model
    torch.cuda.empty_cache()
    return total


def check_scan_training(torch, card, cfg, steps, label, cut=""):
    """13d / 13e: a scan family at full width (`cut` states what was cut
    in depth), f32 params and AdamW, remat on, SCAN_TRAIN_BATCH from
    packed_batches, `steps` steps through build_train_step, the launch
    counters set to 0 before each step and read after: the scan 2 x its
    Mamba layers (forward and remat's recompute), its backward once per
    Mamba layer on the family's body (zamba2's Mamba-2 on the Mamba-2
    body, falcon-mamba's Mamba-1 on the Mamba-1 body), flash 2 x the
    attention applications and dQ = dK/dV once each. Finite loss and grad
    norm every step; the wall per step,
    tokens/s, peak memory and one profiled step. Returns the launches."""
    from repro_torch.kernels import cuda as kc
    from repro_torch.models import Model
    from repro_torch.training import (OptimizerConfig, build_train_step,
                                      init_train_state, packed_batches)
    from repro_torch.training.optimizer import leaves

    t_phase = time.perf_counter()
    model = Model(cfg, device="cuda")
    params, opt = init_train_state(
        model, torch.Generator("cuda").manual_seed(0))
    n_params = sum(p.numel() for p in leaves(params))
    n_scan, n_attn = len(cfg.ssm_layer_ids()), len(cfg.attn_layer_ids())
    want = {"selective_scan": 2 * n_scan, "selective_scan_bwd": n_scan,
            "flash_attention": 2 * n_attn, "flash_attention_bwd_dq": n_attn,
            "flash_attention_bwd_dkdv": n_attn, **scan_bwd_bodies(cfg)}
    b, s = SCAN_TRAIN_BATCH
    step = build_train_step(model, OptimizerConfig(
        lr=3e-4, warmup_steps=2, total_steps=steps))
    data = packed_batches(cfg.vocab_size, b, s, seed=0)
    total = dict.fromkeys(want, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    print(f"  {cfg.name}{cut}: {n_params / 1e9:.3f} B params ({n_scan} "
          f"Mamba layers, {n_attn} attention applications), f32 params + "
          f"grads + AdamW moments; batch {b} x {s}; init "
          f"{time.perf_counter() - t_phase:.1f} s", flush=True)
    walls, losses = [], []
    for i in range(steps):
        batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
        kc.reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt, met = step(params, opt, batch)
        loss, gnorm = met["loss"].item(), met["grad_norm"].item()
        walls.append(time.perf_counter() - t0)
        losses.append(loss)
        counts = dict(kc.launches, **kc.variant_launches)
        n = {k: counts[k] for k in total}
        if n != want or kc.launches["decode_attention"]:
            fail(f"{label} {cfg.name} step {i + 1}: launches "
                 f"{dict(kc.launches)}, expected {want}")
        for k in total:
            total[k] += n[k]
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            fail(f"{label} {cfg.name} step {i + 1}: loss {loss}, grad norm "
                 f"{gnorm}")
        print(f"  {label} step {i + 1}: loss {loss:.4f}, grad norm "
              f"{gnorm:.4f}, wall {walls[-1]:.3f} s", flush=True)
    peak = torch.cuda.max_memory_allocated()
    steady = walls[1:]
    wall = sum(steady) / len(steady)
    print(f"  {label} {cfg.name}{cut} ({card}): {wall:.3f} s per step "
          f"(steps 2-{steps}; step 1 {walls[0]:.3f} s), {b * s / wall:.0f} "
          f"tokens/s, peak memory allocated {peak / 1e9:.2f} GB; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; launches per step {want}",
          flush=True)
    batch = {k: torch.from_numpy(v).cuda() for k, v in next(data).items()}
    profile_train_step(torch, lambda: step(params, opt, batch), label, (
        ("scan backward", "scan_bwd_"), ("scan forward", "scan_kernel<"),
        ("flash backward", "::bwd_d"), ("flash forward", "flash_kernel")))
    print(f"  phase {label} wall {time.perf_counter() - t_phase:.2f} s; "
          f"launches {total}", flush=True)
    del params, opt, model, step
    torch.cuda.empty_cache()
    return total


def profile_train_step(torch, fn, label="13c", shares=(
        ("backward kernels", "::bwd_d"), ("flash forward", "flash_kernel"))):
    """One train step under torch.profiler: wall, card-busy time, idle
    share, and the share of the busy time of each (label, kernel-name
    substring) in `shares`."""
    from torch.profiler import ProfilerActivity, profile
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
        print(f"  {label} profile: device time not measured by the profiler "
              f"(wall {wall_ms:.1f} ms)", flush=True)
        return
    share = {lab: sum(dev_us(e) for e in kern if key in e.key) / 1e3
             for lab, key in shares}
    print(f"  {label} profiled step (torch.profiler, on): wall {wall_ms:.1f} ms, "
          f"card busy {busy_ms:.1f} ms, idle share "
          f"{1 - busy_ms / wall_ms:.3f}, {sum(e.count for e in kern)} "
          f"kernels; " + ", ".join(
              f"{lab} {ms:.1f} ms ({ms / busy_ms:.3f} of busy)"
              for lab, ms in share.items()) + "; top: " + "; ".join(
              f"{e.key[:50]} {dev_us(e) / 1e3:.1f} ms x{e.count}"
              for e in kern[:5]), flush=True)


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
    with 600 tokens of context each, over the contiguous cache (an
    encoder-decoder's with enc_seq(1024) frames of encoder memory)."""
    from repro_torch.models import cache as cache_lib
    from repro_torch.serving import synthetic_frames
    toks = torch.randint(0, model.cfg.vocab_size, (1, 512), device="cuda",
                         dtype=torch.int32)
    enc_seq = model.enc_seq(1024)
    batch = {"tokens": toks}
    if enc_seq:
        batch["frames"] = synthetic_frames(model.cfg, [0], enc_seq,
                                           device="cuda")

    def prefill():
        model.prefill(params, batch, model.init_cache(
            1, 1024, enc_seq=enc_seq, dtype=torch.bfloat16))

    cache = cache_lib.with_lengths(
        model.init_cache(8, 1024, enc_seq=enc_seq, dtype=torch.bfloat16),
        [600] * 8)
    if enc_seq:
        cache["enc_length"].fill_(enc_seq)
    tokens = torch.zeros(8, dtype=torch.int32, device="cuda")

    def decode():
        model.decode_multi(params, tokens, dict(cache), 4)

    profile_window(torch, "prefill 1x512", prefill, 1)
    profile_window(torch, "decode block, 8 slots x 600 ctx", decode, 4)


# ---------------------------------------------------------------------------
# phase 14: the serving launcher and the distributed layer
# ---------------------------------------------------------------------------

SERVE_ARGV = ["--mode", "engine", "--arch", "llama3-8b", "--requests", "20"]
EP_PROMPTS = 4             # rows of phase 11's trace in 14b's prefill


def check_serve_launcher(torch, card):
    """14a: ``repro_torch.launch.serve.main`` in-process with no
    ``--device``, so its default takes the card: full-width, full-depth
    llama3-8b in f32 (the reference's default params), 20 requests on the
    TPU_V5E virtual clock, with the launch counters set to 0 just before
    and read just after. Returns the launches."""
    import io
    from repro_torch.kernels import cuda as kc
    from repro_torch.launch import serve

    buf = io.StringIO()
    torch.cuda.synchronize()
    kc.reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        serve.main(SERVE_ARGV)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    n = dict(kc.launches)
    out = buf.getvalue().splitlines()
    for line in out:
        print(f"  14a | {line}", flush=True)
    line = [ln for ln in out if ln.startswith("engine:")]
    if len(line) != 1 or not line[0].startswith("engine: 20/20 finished"):
        fail(f"14a: the launcher's engine line is {line}")
    print(f"  14a python -m repro_torch.launch.serve {' '.join(SERVE_ARGV)}"
          f": wall {wall:.2f} s (f32 init included), peak "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB, launches "
          f"{ {k: v for k, v in n.items() if v} } ({card})", flush=True)
    for k in ("flash_attention", "decode_attention"):
        if n[k] <= 0:
            fail(f"14a: the launcher's engine never launched {k}")
    return n


def check_moe_ep(torch, card):
    """14b: a one-rank NCCL group and a (1, 1) ("data", "model") mesh on
    the card. Phase 11's full-width qwen2-moe-a2.7b (bf16, seed 0)
    through ``Model(moe_ep_mesh=mesh)`` and the plain ``Model``, one
    prefill of the first EP_PROMPTS prompts of phase 11's trace (padded,
    with lengths): the same top-1 tokens up to near-ties, logits within
    BF16_TOL, the same dropped-assignment count. Then every leaf of the
    params through ``make_shardings`` + ``distribute_tensor`` onto the
    mesh, one at a time: each local shard bitwise the leaf. The group is
    destroyed before it returns; a failure fails the run."""
    import numpy as np
    import torch.distributed as dist
    from torch.distributed.tensor import distribute_tensor
    from repro_torch.configs.qwen2_moe_a2_7b import CONFIG
    from repro_torch.distributed import make_shardings, param_specs
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models import Model

    dist.init_process_group("nccl", rank=0, world_size=1,
                            store=dist.HashStore())
    try:
        mesh = make_debug_mesh(1, 1, device_type="cuda")
        model, params = full_width_model(torch, CONFIG)
        ep = Model(CONFIG, device="cuda", moe_ep_mesh=mesh)
        trace = make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65),
                           0.05)[:EP_PROMPTS]
        lengths = [r.prompt_len for r in trace]
        s = max(lengths)
        toks = np.zeros((len(trace), s), np.int32)
        for i, r in enumerate(trace):
            toks[i, :r.prompt_len] = r.prompt_tokens
        batch = {"tokens": torch.as_tensor(toks).cuda(),
                 "lengths": torch.tensor(lengths, dtype=torch.int32).cuda()}
        res = {}
        for name, m in (("plain", model), ("moe_ep", ep)):
            ms = []
            for _ in range(2):      # the first call also sets up NCCL
                drops = dict(slots=len(trace) * s, routed=0, kept=0)
                restore = _count_moe_drops(drops)
                try:
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    lg, _ = m.prefill(params, batch, m.init_cache(
                        len(trace), s + 1, dtype=torch.bfloat16))
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t) * 1e3)
                finally:
                    restore()
            res[name] = (lg.float(), drops["routed"] - int(drops["kept"]),
                         drops["routed"], ms)
        (a, da, ra, ma), (b, db, rb, mb) = res["plain"], res["moe_ep"]
        if not bool(torch.isfinite(b).all()) or \
                b.shape != (len(trace), CONFIG.vocab_size):
            fail(f"14b: bad moe_ep logits, shape {tuple(b.shape)}")
        diff = float((a - b).abs().max())
        ta, tb = a.argmax(-1), b.argmax(-1)
        margins = [float(a[i, ta[i]] - a[i, tb[i]]) for i in range(len(trace))]
        print(f"  14b prefill {len(trace)} x {s} (lengths {lengths}), "
              f"first and second call: plain {ma[0]:.1f}, {ma[1]:.1f} ms, "
              f"moe_ep {mb[0]:.1f}, {mb[1]:.1f} ms; max |logit diff| "
              f"{diff:.4g} "
              f"(tol {BF16_TOL}, max |logit| {float(a.abs().max()):.3f}); "
              f"top-1 {ta.tolist()} vs {tb.tolist()} (margins {margins}); "
              f"dropped {da} vs {db} of {ra} vs {rb} routed assignments "
              f"({card})", flush=True)
        if diff > BF16_TOL:
            fail(f"14b: moe_ep logits differ by {diff} > {BF16_TOL}")
        if any(m > BF16_FLIP_TOL for m in margins):
            fail(f"14b: top-1 tokens differ beyond a near-tie: {margins}")
        if (da, ra) != (db, rb) or ra == 0:
            fail(f"14b: dropped assignments {da}/{ra} (plain) vs {db}/{rb} "
                 "(moe_ep)")
        del model, ep

        specs = param_specs(mesh, params)
        plc = make_shardings(mesh, specs)
        t = time.perf_counter()
        n = 0
        for key, leaf in _leaf_items(params):
            local = distribute_tensor(leaf, mesh, _at(plc, key)).to_local()
            if local.shape != leaf.shape or not torch.equal(local, leaf):
                fail(f"14b: {'|'.join(key)}'s local shard is not the leaf")
            del local
            n += 1
        torch.cuda.synchronize()
        sharded = sum(any(e is not None for e in _at(specs, k))
                      for k, _ in _leaf_items(params))
        print(f"  14b make_shardings + distribute_tensor: {n} leaves "
              f"({sharded} with a sharded spec, every mesh axis of size 1) "
              f"each bitwise its leaf, {time.perf_counter() - t:.1f} s",
              flush=True)
        del params
    finally:
        dist.destroy_process_group()


KV_REPEAT_PROMPTS = 4      # rows of phase 11's trace, as 14b's
KV_REPEAT_DECODE = 16      # greedy decode steps after the prefill's token


def check_kv_repeat(torch, card):
    """14c: full-width, full-depth llama3-8b (bf16, seed 0) served by
    ``Model(kv_repeat=1)`` and ``Model(kv_repeat=2)`` on one set of
    weights: a 4 x 512 bucketed prefill of the first KV_REPEAT_PROMPTS
    prompts of phase 11's trace (logits within BF16_TOL), then both
    through the engine, contiguous and page 16, the prefill's token and
    KV_REPEAT_DECODE greedy decode steps per request: equal timing and
    tokens equal up to near-ties judged along the kv_repeat=1 engine's
    layout (``audit_flips(engine=)``: ``lossless.engine_margin``). The
    kv_repeat=2 runs' cache holds 16 KV heads; their launches (flash,
    decode, paged decode at KV 16), counted from 0 before each run, are
    returned."""
    import numpy as np
    from repro_torch.configs.llama3_8b import CONFIG
    from repro_torch.models import Model
    from repro_torch.serving import timing_fingerprint

    t0 = time.perf_counter()
    base, params = full_width_model(torch, CONFIG)
    rep = Model(CONFIG, device="cuda", kv_repeat=2)
    trace = make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65),
                       0.05)[:KV_REPEAT_PROMPTS]
    for r in trace:
        r.output_len = KV_REPEAT_DECODE + 1
    lengths = [r.prompt_len for r in trace]
    toks = np.zeros((len(trace), 512), np.int32)
    for i, r in enumerate(trace):
        toks[i, :r.prompt_len] = r.prompt_tokens
    batch = {"tokens": torch.as_tensor(toks).cuda(),
             "lengths": torch.tensor(lengths, dtype=torch.int32).cuda()}
    logits = []
    for m in (base, rep):
        lg, cache = m.prefill(params, batch, m.init_cache(
            len(trace), 513, dtype=torch.bfloat16))
        logits.append(lg.float())
        if cache["k"].shape[3] != CONFIG.num_kv_heads * m.kv_repeat:
            fail(f"14c: kv_repeat={m.kv_repeat}'s cache holds "
                 f"{cache['k'].shape[3]} KV heads")
        del cache
    a, b = logits
    diff = float((a - b).abs().max())
    if not bool(torch.isfinite(b).all()) or diff > BF16_TOL:
        fail(f"14c: kv_repeat=2 prefill logits differ by {diff} > "
             f"{BF16_TOL}")
    print(f"  14c prefill {len(trace)} x 512 bucket (lengths {lengths}): "
          f"max |logit diff| kv_repeat 2 vs 1 {diff:.4g} (tol {BF16_TOL}, "
          f"max |logit| {float(a.abs().max()):.3f})", flush=True)
    common = dict(num_slots=KV_REPEAT_PROMPTS, max_seq=1024,
                  cache_dtype=torch.bfloat16,
                  capacity=KV_REPEAT_PROMPTS * 1024)
    launches = dict.fromkeys(ATTENTION_KERNELS, 0)
    for layout, kw in (("contiguous", {}), ("paged16", dict(page_size=16))):
        outs, engs = {}, {}
        for m in (base, rep):
            name = f"14c {layout} kv_repeat={m.kv_repeat}"
            outs[m.kv_repeat], engs[m.kv_repeat], n, _ = timed_run(
                torch, m, params, trace, name, **common, **kw)
            heads = engs[m.kv_repeat].cache["k"].shape[-2]
            if heads != CONFIG.num_kv_heads * m.kv_repeat:
                fail(f"{name}: the engine's cache holds {heads} KV heads")
            if m is rep:
                for k in launches:
                    launches[k] += n[k]
        if timing_fingerprint(outs[1]) != timing_fingerprint(outs[2]):
            fail(f"14c {layout}: kv_repeat 2 and 1 differ in timing")
        check_bf16_flips(base, params, outs[1], outs[2],
                         f"14c {layout} kv_repeat 2 vs 1", engine=engs[1])
        del engs
    for k in ATTENTION_KERNELS:
        if launches[k] <= 0:
            fail(f"14c: kv_repeat=2 never launched {k}")
    print(f"  14c kv_repeat=2 launches at KV {CONFIG.num_kv_heads * 2}: "
          f"{launches}; wall {time.perf_counter() - t0:.1f} s ({card})",
          flush=True)
    del base, rep, params
    return launches


def _leaf_items(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaf_items(v, path + (k,))
    else:
        yield path, tree


def _at(tree, key):
    for k in key:
        tree = tree[k]
    return tree


def _leaves(tree):
    for _, leaf in _leaf_items(tree):
        yield leaf


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
    # no Pallas counterpart: the reference differentiates
    # selective_scan_ref (and ssd_ref, mapped onto this scan) through XLA
    "selective_scan_bwd": (
        "src/repro_torch/kernels/csrc/selective_scan_bwd.cu",
        "src/repro/kernels/ref.py:123"),
    # no Pallas counterpart: the reference differentiates attention_ref
    # through XLA
    "flash_attention_bwd_dkdv": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/ref.py:27"),
    "flash_attention_bwd_dq": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/ref.py:27"),
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
    walls, t_mark = {}, [t_start]

    def lap(phase):
        """Record the wall since the previous phase ended."""
        now = time.perf_counter()
        walls[phase] = round(now - t_mark[0], 1)
        t_mark[0] = now

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
    lap("1-2")

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
    lap("3")

    print("[4] smoke engines, card vs CPU (f32):", flush=True)
    check_small_engine(torch)
    check_small_spec_moe(torch)
    lap("4")

    launches = {}

    def add(counts):
        """Add one phase's launches (each phase counts from 0)."""
        for k, n in counts.items():
            launches[k] = launches.get(k, 0) + n

    print("[5] full-width llama3-8b engine (bf16):", flush=True)
    counts, llama, llama_params = check_full_engine(torch)
    add(counts)
    torch.cuda.empty_cache()
    lap("5")

    print("[6] full-width falcon-mamba-7b engine (bf16):", flush=True)
    add(check_mamba_engine(torch))
    torch.cuda.empty_cache()
    lap("6")

    print("[7] full-width zamba2-2.7b engine (bf16):", flush=True)
    add(check_zamba2_engine(torch))
    torch.cuda.empty_cache()
    lap("7")

    print("[8] the HTTP/SSE server over the full-width llama3-8b engine "
          f"(bf16, wall clock; {card}):", flush=True)
    add(check_server(torch, llama, llama_params))
    torch.cuda.empty_cache()
    lap("8")

    print("[9] the cluster layer over engine-backed full-width llama3-8b "
          f"replicas (bf16, virtual clock; {card}):", flush=True)
    add(check_cluster(torch, llama, llama_params))
    torch.cuda.empty_cache()
    lap("9")

    print("[10] speculative decoding over the llama3-8b model cut to its "
          f"first {SPEC_LAYERS} of {llama.cfg.num_layers} layers (full width, "
          f"bf16, k={SPEC_K}, virtual clock; {card}):", flush=True)
    add(check_speculative(torch, *depth_cut(llama, llama_params, SPEC_LAYERS),
                          card))
    del llama, llama_params
    torch.cuda.empty_cache()
    lap("10")

    print(f"[11] full-width qwen2-moe-a2.7b engine (bf16; {card}):",
          flush=True)
    add(check_moe_engine(torch, card))
    torch.cuda.empty_cache()
    lap("11")

    print("[12] full-width seamless-m4t-medium and pixtral-12b engines "
          f"(bf16; {card}):", flush=True)
    for check in (check_encdec_engine, check_vlm_engine):
        add(check(torch))
        torch.cuda.empty_cache()
    check_server_cli()
    lap("12")

    print(f"[13] training ({card}):", flush=True)
    rows.update(check_backward_kernels(torch))
    rows.update(check_scan_backward(torch))
    check_small_training(torch)
    add(check_granite_training(torch, card))
    from repro_torch.configs.falcon_mamba_7b import CONFIG as FALCON
    from repro_torch.configs.zamba2_2_7b import CONFIG as ZAMBA2
    add(check_scan_training(torch, card, ZAMBA2, ZAMBA2_STEPS, "13d"))
    add(check_scan_training(
        torch, card, dataclasses.replace(FALCON, num_layers=FALCON_LAYERS),
        FALCON_STEPS, "13e",
        cut=f" (cut to {FALCON_LAYERS} of its {FALCON.num_layers} layers)"))
    torch.cuda.empty_cache()
    lap("13")

    print(f"[14] the serving launcher and the distributed layer ({card}):",
          flush=True)
    add(check_serve_launcher(torch, card))
    torch.cuda.empty_cache()
    check_moe_ep(torch, card)
    torch.cuda.empty_cache()
    add(check_kv_repeat(torch, card))
    torch.cuda.empty_cache()
    lap("14")

    kernels = []
    for name, (src, rep) in SOURCES.items():
        # the backwards' further rows (bf16, the scan backward's Mamba-2
        # body) follow their first under the same name; `launches` counts
        # the entry point on the main path, `body_launches` a scan
        # backward row's body
        for key in [name] + sorted(k for k in rows if k.startswith(name + "/")):
            if key in rows:
                row = dict(rows[key])
                if "body" in row and name == "selective_scan_bwd":
                    row["body_launches"] = launches.get(
                        f"{name}/{row['body']}", 0)
                kernels.append(dict(name=name, route="cuda", source=src,
                                    replaces=rep, launches=launches[name],
                                    **row))
    print(f"phase walls (s; {card}): {walls}", flush=True)
    print(f"total {time.perf_counter() - t_start:.1f} s", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
