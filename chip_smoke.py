#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path — the Andes serving engine over the
full-width, full-depth Llama-3-8B config with random bf16 weights made
from a seed — and holds every hand-written CUDA kernel on that path
against its plain PyTorch version. Phases, in order:

1. the device: name and power limit from nvidia-smi;
2. build the CUDA kernels (one nvcc per source, in parallel);
3. each kernel against its plain version at the main path's shapes, in
   bf16 (tolerance 2e-2), with its time, the plain version's time, the
   time of one PyTorch library call computing the same function where
   there is one (SDPA; a yardstick only, the port never calls it) and the
   least time the card could take (bytes or FLOPs over the H100's peaks);
4. the smoke-size engine on the card against the same engine on the CPU
   (plain versions), f32: identical virtual timing and tokens identical
   up to documented near-ties — the repo's differential check on a small
   input;
5. the full-width engine, twice: over the physical page pool (page 16,
   paged decode kernel) and over the contiguous cache (decode kernel),
   with every kernel's launch counter set to 0 before and read after.
   Both runs must finish every request with its full output, share one
   timing fingerprint, and agree on tokens up to bf16 near-ties.

It prints the kernels' JSON line, the card line, and last the result
line {"ok": true, "device": {...}}. With no CUDA device, or outside a
checkout of the repo, it exits non-zero and prints no result. Every
process it starts (nvcc, nvidia-smi) ends before it returns.
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
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12        # dense bf16 tensor-core peak, same source
SPIN_CYCLES = 200_000_000  # ~0.1 s of SM clock: covers the host's enqueueing
# A token flip between the two full-width runs is a near-tie when the
# exact-length path's top-2 margin is within a few bf16 rounding steps of
# the logits: bf16 keeps 8 significant bits, so at the |logit| ~ 4..8 this
# random-weight model reaches, one step is 2^-5..2^-4 (0.03..0.06).
BF16_FLIP_TOL = 0.125


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.stdout else "unknown"


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


def bound_ms(bytes_moved: float, flops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
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
        b_ms, b_by = bound_ms(nbytes, flops)
        print(f"  {name}{extra}: max|err| {err:.3e} (tol {BF16_TOL})  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
              f"library {('%.4f ms' % lib_ms) if lib_ms is not None else 'n/a'}"
              f"  bound {b_ms:.4f} ms ({b_by})", flush=True)
        if not err <= BF16_TOL:
            fail(f"{name}{extra} disagrees with its plain version: {err}")
        return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                    bound_ms=b_ms, bound_by=b_by, library_ms=lib_ms)

    # ---- decode: B=8, H=32, KV=8, hd=128, cache depth 1024, ragged ----
    b, s, h, kv, hd = 8, 1024, 32, 8, 128
    q = rnd(b, h, hd)
    k, v = rnd(b, s, kv, hd), rnd(b, s, kv, hd)
    lengths = torch.randint(1, s + 1, (b,), generator=gen).to(torch.int32)
    lengths[0] = s
    lengths = lengths.cuda()
    ctx = int(lengths.sum())
    kv_bytes = 2 * ctx * kv * hd * 2
    io_bytes = 2 * b * h * hd * 2 + b * 4
    dec_flops = 4 * h * hd * ctx
    mask = (torch.arange(s, device="cuda")[None, :] < lengths[:, None])
    qs, ks, vs = q[:, :, None], k.transpose(1, 2), v.transpose(1, 2)
    lib = (lambda: sdpa(qs, ks, vs, attn_mask=mask[:, None, None, :],
                        enable_gqa=True)) if sdpa else None
    rows["decode_attention"] = record(
        "decode_attention", kc.decode_attention(q, k, v, lengths),
        ref.decode_attention_ref(q, k, v, lengths),
        lambda: kc.decode_attention(q, k, v, lengths),
        lambda: ref.decode_attention_ref(q, k, v, lengths), lib,
        kv_bytes + io_bytes, dec_flops)

    # ---- paged: the same, page 16 (main path) and page 1 --------------
    for page in (16, 1):
        kp, vp, bt = _paginate(torch, k, v, lengths, page, gen)
        tab_bytes = sum(-(-int(n) // page) for n in lengths.tolist()) * 4
        r = record(
            "paged_decode_attention",
            kc.paged_decode_attention(q, kp, vp, bt, lengths),
            ref.paged_decode_attention_ref(q, kp, vp, bt, lengths),
            lambda: kc.paged_decode_attention(q, kp, vp, bt, lengths),
            lambda: ref.paged_decode_attention_ref(q, kp, vp, bt, lengths),
            None, kv_bytes + io_bytes + tab_bytes, dec_flops,
            extra=f" (page {page})")
        if page == 16:
            rows["paged_decode_attention"] = r
        del kp, vp

    # ---- prefill: B=4, bucket 512, ragged lengths, causal -------------
    b, s = 4, 512
    q = rnd(b, s, h, hd)
    k, v = rnd(b, s, kv, hd), rnd(b, s, kv, hd)
    lengths = torch.tensor([512, 389, 200, 64], dtype=torch.int32).cuda()
    qpos = torch.arange(s, device="cuda")
    valid = ((qpos[None, None, :] <= qpos[None, :, None])
             & (qpos[None, None, :] < lengths[:, None, None]))
    pairs = int(valid.sum())
    kv_rows = int(lengths.sum())
    pre_bytes = 2 * (2 * b * s * h * hd) + 2 * 2 * kv_rows * kv * hd + b * 4
    lib = (lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2),
                        v.transpose(1, 2), attn_mask=valid[:, None],
                        enable_gqa=True)) if sdpa else None
    rows["flash_attention"] = record(
        "flash_attention",
        kc.flash_attention(q, k, v, causal=True, lengths=lengths),
        ref.attention_ref(q, k, v, causal=True, lengths=lengths),
        lambda: kc.flash_attention(q, k, v, causal=True, lengths=lengths),
        lambda: ref.attention_ref(q, k, v, causal=True, lengths=lengths),
        lib, pre_bytes, 4 * h * hd * pairs)
    del flush
    torch.cuda.empty_cache()
    return rows


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


def check_small_engine(torch):
    """Smoke config, f32: the engine on the card (CUDA kernels) against the
    engine on the CPU (plain versions), contiguous and paged."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import Model
    from repro_torch.serving import (all_flips_documented, audit_flips,
                                     timing_fingerprint)
    cfg = get_smoke_config("llama3-8b")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device="cuda")
    gparams = _to(params, "cuda")
    trace = make_trace(12, cfg.vocab_size, 0, (5, 30), (14, 15), 0.01)
    for kw in (dict(), dict(page_size=16)):
        runs = [serve(m, p, trace, num_slots=4, max_seq=64,
                      cache_dtype=torch.float32, capacity=100, delta_t=2.0,
                      **kw)[0]
                for m, p in ((cpu, params), (gpu, gparams))]
        same_t = timing_fingerprint(runs[0]) == timing_fingerprint(runs[1])
        flips = audit_flips(cpu, params, runs[0], runs[1])
        n_same = sum(a.output_tokens == b.output_tokens
                     for a, b in zip(*runs))
        print(f"  smoke engine {kw or 'contiguous'}: timing identical "
              f"{same_t}, token-identical requests {n_same}/{len(trace)}, "
              f"flips {flips}", flush=True)
        if not same_t:
            fail("smoke engine timing differs between the card and the CPU")
        if not all_flips_documented(flips):
            fail(f"smoke engine token divergence beyond near-ties: {flips}")


def check_full_engine(torch):
    import numpy as np
    from repro_torch.configs.llama3_8b import CONFIG
    from repro_torch.kernels import cuda as kc
    from repro_torch.models import Model
    from repro_torch.serving import (audit_flips, first_divergence,
                                     timing_fingerprint)

    t0 = time.perf_counter()
    model = Model(CONFIG, device="cuda")
    params = model.init(torch.Generator(device="cuda").manual_seed(0),
                        torch.bfloat16)
    torch.cuda.synchronize()
    n_params = sum(x.numel() for x in _leaves(params))
    print(f"  llama3-8b: {CONFIG.num_layers} layers, d={CONFIG.d_model}, "
          f"{n_params / 1e9:.3f} B params in bf16, init "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    trace = make_trace(12, CONFIG.vocab_size, 0, (64, 513), (32, 65), 0.05)
    common = dict(num_slots=8, max_seq=1024, cache_dtype=torch.bfloat16,
                  capacity=8 * 1024)
    kc.reset_launches()
    runs, per_run = {}, {}
    for name, kw in (("paged16", dict(page_size=16)),
                     ("contiguous", dict())):
        before = dict(kc.launches)
        timers = {}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out, eng = serve(model, params, trace, timers=timers, **common, **kw)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        per_run[name] = {k: kc.launches[k] - before[k] for k in before}
        runs[name] = out
        pre = timers.get("prefill", [])
        dec = timers.get("decode", [])
        steps = sum(s for _, s in dec)
        res = eng.result()
        print(f"  engine {name}: physical_pages={eng.physical_pages} "
              f"wall {wall:.2f} s; prefill groups {len(pre)}: "
              + ", ".join(f"{r}x{s}={ms:.1f}ms" for ms, (r, s) in pre)
              + f"; decode {len(dec)} blocks / {steps} iterations, "
              f"{sum(ms for ms, _ in dec) / max(steps, 1):.2f} ms per "
              f"iteration (card-measured, synchronized); launches "
              f"{per_run[name]}", flush=True)
        print(f"  engine {name} (modelled by the TPU_V5E virtual clock, not "
              f"measured): avg QoE {res.avg_qoe():.4f}, mean TTFT "
              f"{float(np.mean(res.ttfts())):.4f} s, makespan "
              f"{res.makespan:.3f} s, preemptions {res.preemptions}",
              flush=True)
        short = [r.rid for r in out if r.generated != r.output_len]
        if short:
            fail(f"engine {name}: requests {short} did not finish")
    launches = dict(kc.launches)
    for k, n in launches.items():
        if n <= 0:
            fail(f"kernel {k} was never launched on the main path")
    a, b = runs["paged16"], runs["contiguous"]
    if timing_fingerprint(a) != timing_fingerprint(b):
        fail("paged and contiguous engines differ in timing")
    flips = audit_flips(model, params, a, b, tol=BF16_FLIP_TOL)
    n_div = sum(first_divergence(x.output_tokens, y.output_tokens)
                is not None for x, y in zip(a, b))
    print(f"  paged vs contiguous: timing identical, {n_div} requests with "
          f"token differences, flips {flips} (tol {BF16_FLIP_TOL})",
          flush=True)
    bad = [f for f in flips if f["classification"] != "documented_ulp_flip"]
    if bad:
        fail(f"paged and contiguous tokens diverge beyond near-ties: {bad}")
    # the logits the engine argmaxes are finite and of the vocab's width
    toks = torch.as_tensor(np.asarray(a[0].prompt_tokens, np.int32))[None]
    logits, _ = model.prefill(params, {"tokens": toks.cuda()},
                              model.init_cache(1, toks.shape[1] + 1,
                                               dtype=torch.bfloat16))
    if tuple(logits.shape) != (1, CONFIG.vocab_size) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"bad logits: shape {tuple(logits.shape)}")
    print(f"  logits finite, shape {tuple(logits.shape)}, max |logit| "
          f"{float(logits.float().abs().max()):.3f}", flush=True)
    profile_engine_steps(torch, model, params)
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

    print("[3] kernels vs plain versions (bf16, main-path shapes; "
          f"{card}):", flush=True)
    rows = check_kernels(torch)

    print("[4] smoke engine, card vs CPU (f32):", flush=True)
    check_small_engine(torch)

    print("[5] full-width llama3-8b engine (bf16):", flush=True)
    launches = check_full_engine(torch)

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
