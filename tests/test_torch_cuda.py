"""The hand-written CUDA kernels against their plain PyTorch versions.

Needs an NVIDIA GPU (marker ``cuda``): a CUDA kernel has no interpret
mode, so without a card every test here skips. On the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX, so it runs on a machine that has none. The
kernels build from ``src/repro_torch/kernels/csrc`` on first use.
Tolerances are the reference's kernel tolerances (f32 2e-5, bf16 2e-2,
``tests/test_kernels.py``). Where nothing is attended (length 0, or a
window that excludes every key) the kernels write zeros — the Pallas
convention — while the plain versions average uniformly; those rows are
checked for zeros and left out of the comparison.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels import ref as tref

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rand(seed, shape, dtype, dev):
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=dev, dtype=dtype)


def _close(out, expect, dtype):
    torch.testing.assert_close(out.float(), expect.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def _paginate(k, v, lengths, page, seed=0):
    """Shuffled page pool holding the contiguous rows; noise elsewhere."""
    b, s, kvh, hd = k.shape
    max_pages = -(-s // page)
    pad = max_pages * page - s
    kp = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))
    needed = [-(-int(n) // page) for n in lengths.tolist()]
    p_total = sum(needed) + 3
    rng = np.random.default_rng(seed)
    ids = list(rng.permutation(p_total))
    k_pool = torch.randn((p_total, page, kvh, hd), device=k.device).to(k.dtype)
    v_pool = torch.randn((p_total, page, kvh, hd), device=k.device).to(k.dtype)
    tables = torch.full((b, max_pages), p_total, dtype=torch.int32)
    for bi in range(b):
        for pi in range(needed[bi]):
            pid = int(ids.pop())
            tables[bi, pi] = pid
            k_pool[pid] = kp[bi, pi * page:(pi + 1) * page]
            v_pool[pid] = vp[bi, pi * page:(pi + 1) * page]
    return k_pool, v_pool, tables.to(k.device)


DECODE_SHAPES = [(3, 300, 8, 2, 64), (2, 64, 4, 4, 32),
                 (8, 1024, 32, 8, 128), (2, 512, 16, 1, 32)]


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [None, 32])
def test_decode_kernel(dev, shape, dtype, window):
    b, s, h, kv, hd = shape
    q = _rand(0, (b, h, hd), dtype, dev)
    k = _rand(1, (b, s, kv, hd), dtype, dev)
    v = _rand(2, (b, s, kv, hd), dtype, dev)
    g = torch.Generator().manual_seed(3)
    lengths = torch.randint(1, s + 1, (b,), generator=g).to(torch.int32)
    lengths[0] = s
    lengths = lengths.to(dev)
    n0 = tcuda.launches["decode_attention"]
    out = tcuda.decode_attention(q, k, v, lengths, window=window)
    assert tcuda.launches["decode_attention"] == n0 + 1
    _close(out, tref.decode_attention_ref(q, k, v, lengths, window=window),
           dtype)


def test_decode_kernel_length_conventions(dev):
    b, s, h, kv, hd = 3, 64, 8, 2, 32
    q = _rand(4, (b, h, hd), torch.float32, dev)
    k = _rand(5, (b, s, kv, hd), torch.float32, dev)
    v = _rand(6, (b, s, kv, hd), torch.float32, dev)
    lengths = torch.tensor([0, s + 5, 9], dtype=torch.int32, device=dev)
    out = tcuda.decode_attention(q, k, v, lengths)
    assert torch.equal(out[0], torch.zeros_like(out[0]))   # Pallas: zeros
    # past the cache depth: every position attended, as the plain version
    _close(out[1:], tref.decode_attention_ref(q, k, v, lengths)[1:],
           torch.float32)


@pytest.mark.parametrize("page", [1, 16, 64, 100])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_paged_kernel(dev, page, dtype):
    b, s, h, kv, hd = 4, 64, 8, 2, 64
    q = _rand(7, (b, h, hd), dtype, dev)
    k = _rand(8, (b, s, kv, hd), dtype, dev)
    v = _rand(9, (b, s, kv, hd), dtype, dev)
    lengths = torch.tensor([64, 1, 30, 17], dtype=torch.int32, device=dev)
    kp, vp, bt = _paginate(k, v, lengths, page, seed=page)
    n0 = tcuda.launches["paged_decode_attention"]
    out = tcuda.paged_decode_attention(q, kp, vp, bt, lengths)
    assert tcuda.launches["paged_decode_attention"] == n0 + 1
    _close(out, tref.paged_decode_attention_ref(q, kp, vp, bt, lengths),
           dtype)
    _close(out, tref.decode_attention_ref(q, k, v, lengths), dtype)
    if s % page == 0:
        # same walk, same sums: bitwise the contiguous kernel
        assert torch.equal(out, tcuda.decode_attention(q, k, v, lengths))


def test_paged_kernel_window_and_main_shape(dev):
    b, s, h, kv, hd, page = 8, 1024, 32, 8, 128, 16
    q = _rand(10, (b, h, hd), torch.bfloat16, dev)
    k = _rand(11, (b, s, kv, hd), torch.bfloat16, dev)
    v = _rand(12, (b, s, kv, hd), torch.bfloat16, dev)
    g = torch.Generator().manual_seed(13)
    lengths = torch.randint(1, s + 1, (b,), generator=g).to(torch.int32).to(dev)
    kp, vp, bt = _paginate(k, v, lengths, page)
    for window in (None, 100):
        out = tcuda.paged_decode_attention(q, kp, vp, bt, lengths,
                                           window=window)
        _close(out, tref.decode_attention_ref(q, k, v, lengths,
                                              window=window), torch.bfloat16)


def _attended_rows(b, sq, sk, causal, lengths, q_offset, window, dev):
    """(B, Sq) mask of query rows with at least one unmasked key."""
    kp = torch.arange(sk, device=dev)[None, None, :]
    qp = torch.arange(sq, device=dev)[None, :, None]
    if q_offset is not None:
        qp = qp + q_offset[:, None, None]
    m = torch.ones((b, sq, sk), dtype=torch.bool, device=dev)
    if causal:
        m &= kp <= qp
    if lengths is not None:
        m &= kp < lengths[:, None, None]
    if window is not None:
        m &= kp > qp - window
    return m.any(-1)


FLASH_CASES = [
    # (b, sq, sk, h, kv, hd, causal, lengths, q_offset, window)
    (2, 128, 128, 4, 4, 64, True, None, None, None),
    (2, 200, 200, 8, 2, 32, False, None, None, None),
    (4, 512, 512, 32, 8, 128, True, [512, 300, 77, 0], None, None),
    (3, 96, 96, 8, 2, 64, True, [96, 50, 1], None, 24),
    (2, 40, 100, 4, 1, 32, True, [100, 64], [60, 24], None),
    (2, 70, 70, 4, 2, 128, False, [70, 33], None, None),
]


@pytest.mark.parametrize("case", FLASH_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel(dev, case, dtype):
    b, sq, sk, h, kv, hd, causal, lens, offs, window = case
    q = _rand(14, (b, sq, h, hd), dtype, dev)
    k = _rand(15, (b, sk, kv, hd), dtype, dev)
    v = _rand(16, (b, sk, kv, hd), dtype, dev)
    lengths = (torch.tensor(lens, dtype=torch.int32, device=dev)
               if lens is not None else None)
    q_offset = (torch.tensor(offs, dtype=torch.int32, device=dev)
                if offs is not None else None)
    n0 = tcuda.launches["flash_attention"]
    out = tcuda.flash_attention(q, k, v, causal=causal, window=window,
                                lengths=lengths, q_offset=q_offset)
    assert tcuda.launches["flash_attention"] == n0 + 1
    expect = tref.attention_ref(q, k, v, causal=causal, window=window,
                                lengths=lengths, q_offset=q_offset)
    rows = _attended_rows(b, sq, sk, causal, lengths, q_offset, window, dev)
    _close(out[rows], expect[rows], dtype)
    assert not out[~rows].any()                     # Pallas: zeros


def test_engine_on_card_matches_plain_path(dev):
    """The smoke engine on the card (CUDA kernels) against the same engine
    on the CPU (plain versions), f32: identical virtual timing, tokens
    identical up to near-ties the port's exact-length path documents."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import (TPU_V5E, LatencyModel, QoESpec,
                                  SchedulerConfig, make_scheduler)
    from repro_torch.models import Model
    from repro_torch.serving import (Request, ServingEngine,
                                     all_flips_documented, audit_flips,
                                     timing_fingerprint)
    cfg = get_smoke_config("llama3-8b")
    cpu = Model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    gpu = Model(cfg, device=dev)
    gparams = _to(params, dev)

    def trace():    # the trace of tests/test_torch_engine.py
        rng = np.random.default_rng(0)
        out = []
        for i in range(12):
            n = int(rng.integers(5, 30))
            out.append(Request(
                rid=i, arrival=i * 0.01, prompt_len=n, output_len=14,
                spec=QoESpec(ttft=1.0, tds=4.8),
                prompt_tokens=rng.integers(0, cfg.vocab_size, n)))
        return out

    for kw in (dict(), dict(page_size=16)):
        outs = []
        for m, p in ((cpu, params), (gpu, gparams)):
            lat = LatencyModel(cfg, TPU_V5E)
            sched = make_scheduler("andes", 100, lat,
                                   SchedulerConfig(delta_t=2.0))
            eng = ServingEngine(m, p, sched, lat, num_slots=4, max_seq=64,
                                capacity_tokens=100, device=m.device, **kw)
            outs.append(eng.run(trace(), max_iterations=4000))
        assert timing_fingerprint(outs[0]) == timing_fingerprint(outs[1])
        flips = audit_flips(cpu, params, outs[0], outs[1])
        assert all_flips_documented(flips), flips


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)
