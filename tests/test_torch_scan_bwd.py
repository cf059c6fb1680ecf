"""The selective scan's plain backward and its autograd plumbing against
the JAX reference (CPU).

``selective_scan_bwd_ref`` (``repro_torch/kernels/ref.py``) is the plain
version the backward kernel (``csrc/selective_scan_bwd.cu``) is held
against on the card. Here it is held against torch autograd of the port's
``selective_scan_ref`` and against ``jax.vjp`` of the reference's
``selective_scan_ref``, which is what the reference trains through; and,
through Mamba-2's mapping (``ops.ssd_channel_args``, whose repeat and cast
autograd carries the mapped gradients back through), against ``jax.vjp``
of the reference's ``ssd_ref``, per head: in its Mamba-1 form on A
expanded over the states, and in its Mamba-2 form (A one scalar per
channel: the plain version of the kernel's Mamba-2 body), which is also
held against the Mamba-1 form. Then ``ops.SelectiveScan`` and the scans'
CUDA dispatch (``ops._scan``, which ``ops.selective_scan`` and
``ops.ssd`` call on CUDA tensors, the latter on ``ssd_channel_args``)
with the two CUDA wrappers swapped for plain versions, on CPU tensors:
strided B and C, A per channel for Mamba-2, dt cast, which entry point
runs in and out of grad mode, and which backward body each scan takes.
Inputs from a numpy seed, a ragged tail of zeroed dt (the engine's
padding) and S not a multiple of 32; f32, every gradient within 1e-5 of
its largest magnitude (the gradients sum over whole sequences, so their
scale is not the inputs').
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import cuda as tcuda
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

torch.set_num_threads(1)
TOL = 1e-5
GRADS = ("dx", "ddt", "dA", "dB", "dC", "dD")


def _rel_close(got, want, name):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-12)
    err = np.abs(got - want).max()
    assert err <= TOL * scale, (name, err, scale)


def _ragged_dt(rng, shape):
    """softplus(N(0,1) - 1), zero past each row's length (row 0 full)."""
    dt = np.log1p(np.exp(rng.normal(size=shape) - 1.0))
    s = shape[1]
    for i, n in enumerate([s] + list(rng.integers(1, s, shape[0] - 1))):
        dt[i, n:] = 0.0
    return dt.astype(np.float32)


def _mamba1_inputs(n, seed=0, b=2, s=40, d=64, r=5):
    """x, dt, A, dbc (dt_rank columns, then B, then C: B and C are strided
    column slices of it), D, dy."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, d)).astype(np.float32)
    dt = _ragged_dt(rng, (b, s, d))
    A = (-np.exp(rng.normal(size=(d, n)) * 0.5)).astype(np.float32)
    dbc = rng.normal(size=(b, s, r + 2 * n)).astype(np.float32)
    D = rng.normal(size=(d,)).astype(np.float32)
    dy = rng.normal(size=(b, s, d)).astype(np.float32)
    return x, dt, A, dbc[..., r:r + n], dbc[..., r + n:], D, dy


def _mamba2_inputs(nh, hd, n, seed=1, b=2, s=40):
    """x (B,S,NH,HD), dt (B,S,NH), A (NH,), xbc's B and C column slices,
    D (NH,), dy (B,S,NH,HD)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    dt = _ragged_dt(rng, (b, s, nh))
    A = (-np.exp(rng.normal(size=(nh,)) * 0.5)).astype(np.float32)
    bc = rng.normal(size=(b, s, 2 * n)).astype(np.float32)
    D = rng.normal(size=(nh,)).astype(np.float32)
    dy = rng.normal(size=(b, s, nh, hd)).astype(np.float32)
    return x, dt, A, bc[..., :n], bc[..., n:], D, dy


def _leaves(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_()
            for a in arrays]


@pytest.mark.parametrize("oracle", ["torch-autograd", "jax-vjp"])
@pytest.mark.parametrize("n", [4, 16])
def test_plain_backward_matches_autodiff(n, oracle):
    """The written-out reverse recurrence against automatic
    differentiation of the forward: the port's plain scan under torch
    autograd, or the reference's under jax.vjp."""
    x, dt, A, B, C, D, dy = _mamba1_inputs(n)
    bc = torch.from_numpy(np.concatenate([B, C], -1))
    args = [torch.from_numpy(a) for a in (x, dt, A)] + [
        bc[..., :n], bc[..., n:], torch.from_numpy(D)]
    assert not args[3].is_contiguous()
    got = tref.selective_scan_bwd_ref(*args, torch.from_numpy(dy))
    assert all(g.dtype == torch.float32 for g in got)
    if oracle == "jax-vjp":
        _, vjp = jax.vjp(jref.selective_scan_ref,
                         *(jnp.asarray(a) for a in (x, dt, A, B, C, D)))
        want = [np.asarray(g) for g in vjp(jnp.asarray(dy))]
    else:
        leaves = _leaves((x, dt, A, B, C, D))
        y = tref.selective_scan_ref(*leaves)
        want = [g.numpy() for g in torch.autograd.grad(
            y, leaves, torch.from_numpy(dy))]
    for name, g, w in zip(GRADS, got, want):
        _rel_close(g.numpy(), w, name)


def _ssd_through_mapping(x, dt, A, B, C, D, dy, bwd):
    """Mamba-2's gradients by the selective-scan backward `bwd` on the
    mapped arguments (``ops.ssd_channel_args``, A then expanded over the
    states: the Mamba-1 form), carried back to the heads' dt, A and D by
    autograd of the mapping -> (dx, ddt, dA, dB, dC, dD)."""
    leaves = _leaves((x, dt, A, B, C, D))
    xs, dts, ac, bm, cm, ds = tops.ssd_channel_args(*leaves)
    mapped = (xs, dts, ac[:, None].expand(-1, B.shape[-1]), bm, cm, ds)
    grads = bwd(*(m.detach() for m in mapped),
                torch.from_numpy(dy).reshape(mapped[0].shape))
    return [g.numpy() for g in torch.autograd.grad(mapped, leaves, grads)]


@pytest.mark.parametrize("nh,hd,n", [(3, 8, 16), (2, 16, 4)])
def test_mamba2_mapping_matches_jax_vjp(nh, hd, n):
    """ssd_channel_args with A expanded over the states, then the plain
    scan backward's Mamba-1 form, then autograd of the mapping: each
    head's dt, A and D gradients (summed over its channels)
    and those of x, B and C, against jax.vjp of the reference's ssd_ref."""
    x, dt, A, B, C, D, dy = _mamba2_inputs(nh, hd, n)
    got = _ssd_through_mapping(x, dt, A, B, C, D, dy,
                               tref.selective_scan_bwd_ref)
    _, vjp = jax.vjp(jref.ssd_ref,
                     *(jnp.asarray(a) for a in (x, dt, A, B, C, D)))
    for name, g, w in zip(GRADS, got, vjp(jnp.asarray(dy))):
        _rel_close(g, np.asarray(w), name)


@pytest.mark.parametrize("nh,hd,n", [(3, 8, 16), (2, 16, 4)])
def test_mamba2_channel_backward_matches_jax_vjp(nh, hd, n):
    """The route ops.ssd trains through: ssd_channel_args (A one scalar
    per channel), then the plain backward's Mamba-2 form, then autograd
    of that mapping: each head's dx, ddt, dA, dB, dC and dD against
    jax.vjp of the reference's ssd_ref."""
    x, dt, A, B, C, D, dy = _mamba2_inputs(nh, hd, n)
    leaves = _leaves((x, dt, A, B, C, D))
    mapped = tops.ssd_channel_args(*leaves)
    assert mapped[2].shape == (nh * hd,)
    grads = tref.selective_scan_bwd_ref(
        *(m.detach() for m in mapped),
        torch.from_numpy(dy).reshape(mapped[0].shape))
    assert grads[2].shape == (nh * hd,)
    got = [g.numpy() for g in torch.autograd.grad(mapped, leaves, grads)]
    _, vjp = jax.vjp(jref.ssd_ref,
                     *(jnp.asarray(a) for a in (x, dt, A, B, C, D)))
    for name, g, w in zip(GRADS, got, vjp(jnp.asarray(dy))):
        _rel_close(g, np.asarray(w), name)


@pytest.mark.parametrize("n", [4, 16, 64])
def test_channel_backward_equals_expanded_backward(n):
    """The plain backward with A per channel (the Mamba-2 body's form)
    against its Mamba-1 form on the same A expanded over the states: the
    same dx, ddt, dB, dC and dD, and dA summed over the states."""
    x, dt, A, B, C, D, dy = (torch.from_numpy(a) for a in
                             _mamba1_inputs(n, seed=6, d=40))
    a_ch = A[:, 0].contiguous()
    got = tref.selective_scan_bwd_ref(x, dt, a_ch, B, C, D, dy)
    want = list(tref.selective_scan_bwd_ref(
        x, dt, a_ch[:, None].expand(-1, n), B, C, D, dy))
    want[2] = want[2].sum(1)
    for name, g, w in zip(GRADS, got, want):
        assert g.shape == w.shape, name
        _rel_close(g.numpy(), w.numpy(), name)


@pytest.fixture
def plain_wrappers(monkeypatch):
    """The two CUDA scan wrappers as plain versions on CPU tensors; the
    forward hands the backward a sentinel for its states and plan, which
    the backward checks it gets back. Both take A in either form, as the
    wrappers do; the backward records its body by A's form, as its
    wrapper counts it: "mamba1" for (D, N), "mamba2" for (D,). Returns the
    calls made."""
    calls = []
    states = torch.zeros(1)
    plan = tcuda.ScanPlan(4, 32, (1, 1), 128)

    def scan(x, dt, A, B, C, D, *, save_states=False):
        assert A.shape in ((x.shape[-1], B.shape[-1]), (x.shape[-1],))
        calls.append(("forward", save_states))
        y = tref.selective_scan_ref(x, dt, A, B, C, D)
        return (y, states, plan) if save_states else y

    def scan_bwd(x, dt, A, B, C, D, st, dy, pl):
        assert st is states and pl is plan and dy.is_contiguous()
        calls.append(("backward", "mamba2" if A.dim() == 1 else "mamba1"))
        return tref.selective_scan_bwd_ref(x, dt, A, B, C, D, dy)

    monkeypatch.setattr(tcuda, "selective_scan", scan)
    monkeypatch.setattr(tcuda, "selective_scan_bwd", scan_bwd)
    return calls


def _cuda_ssd(x, dt, A, B, C, D):
    """ops.ssd's CUDA branch, which CPU tensors do not reach: ops._scan on
    ssd_channel_args, y back in the heads' layout."""
    return tops._scan(*tops.ssd_channel_args(x, dt, A, B, C, D)).view(x.shape)


@pytest.mark.parametrize("kind", ["mamba1", "mamba2"])
def test_selective_scan_function_plumbing(plain_wrappers, kind):
    """ops.SelectiveScan's gradients, with the plain versions behind it,
    against torch autograd of the plain forward: B and C as strided column
    slices of one tensor. Mamba-1 through ops._scan (ops.selective_scan's
    CUDA dispatch) takes the Mamba-1 backward; Mamba-2 through ops.ssd's
    CUDA branch takes the Mamba-2 one, on ssd_channel_args: A one scalar
    per channel (expanded only by the forward's wrapper) and dt cast to
    x's dtype (dt in float64 here, so the cast is real)."""
    if kind == "mamba1":
        x, dt, A, B, C, D, dy = _mamba1_inputs(16, seed=3)
        n = A.shape[1]
    else:
        x, dt, A, B, C, D, dy = _mamba2_inputs(4, 8, 16, seed=4)
        dt = dt.astype(np.float64)
        n = B.shape[-1]
    bc = np.concatenate([B, C], -1)

    def grads(fn):
        x_, dt_, A_, bc_, D_ = _leaves((x, dt, A, bc, D))
        y = fn(x_, dt_, A_, bc_[..., :n], bc_[..., n:], D_)
        return torch.autograd.grad(y, (x_, dt_, A_, bc_, D_),
                                   torch.from_numpy(dy))

    if kind == "mamba1":
        got = grads(tops._scan)
        want = grads(tref.selective_scan_ref)
    else:
        got = grads(_cuda_ssd)
        want = grads(tref.ssd_ref)
    assert plain_wrappers == [("forward", True), ("backward", kind)]
    for name, g, w in zip(("dx", "ddt", "dA", "dBC", "dD"), got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, name
        _rel_close(g.numpy(), w.numpy(), name)


@pytest.mark.parametrize("grad_mode", [True, False])
def test_scan_dispatch_trains_only_in_grad_mode(plain_wrappers, grad_mode):
    """The scans' CUDA dispatch (ops._scan, behind ops.selective_scan and
    ops.ssd) records the backward only when grad mode is on and an input
    requires grad; otherwise it launches the forward alone, as serving
    does, and saves nothing."""
    x, dt, A, B, C, D, _ = _mamba1_inputs(4, seed=5)
    args = _leaves((x, dt, A, B, C, D))
    with torch.set_grad_enabled(grad_mode):
        y = tops._scan(*args)
    assert y.requires_grad == grad_mode
    assert plain_wrappers == [("forward", grad_mode)]
    if grad_mode:
        y.sum().backward()
        assert plain_wrappers[-1] == ("backward", "mamba1")
        assert all(a.grad is not None for a in args)


@pytest.mark.parametrize("grad_mode", [True, False])
def test_ssd_dispatch_trains_only_in_grad_mode(plain_wrappers, grad_mode):
    """Mamba-2's CUDA dispatch (ops.ssd's branch): in grad mode with an
    input that requires grad, SelectiveScan on A per channel and the
    Mamba-2 backward; otherwise the forward alone, as the serving prefill
    runs it, and nothing saved. The heads' gradients against torch
    autograd of the plain Mamba-2 recurrence."""
    x, dt, A, B, C, D, dy = _mamba2_inputs(2, 8, 16, seed=7)
    args = _leaves((x, dt, A, B, C, D))
    with torch.set_grad_enabled(grad_mode):
        y = _cuda_ssd(*args)
    assert y.shape == x.shape and y.requires_grad == grad_mode
    assert plain_wrappers == [("forward", grad_mode)]
    if grad_mode:
        got = torch.autograd.grad(y, args, torch.from_numpy(dy))
        assert plain_wrappers[-1] == ("backward", "mamba2")
        leaves = _leaves((x, dt, A, B, C, D))
        want = torch.autograd.grad(tref.ssd_ref(*leaves), leaves,
                                   torch.from_numpy(dy))
        for name, g, w in zip(GRADS, got, want):
            assert g.shape == w.shape, name
            _rel_close(g.numpy(), w.numpy(), name)
