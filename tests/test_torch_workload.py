"""The port's workload generators against the reference (numpy only).

For the same seed, every generator in ``repro.workload.__all__`` must give
the same output in ``repro_torch.workload``, compared bitwise: arrival
times, prompt and output lengths, tenants, rids, ``QoESpec`` and
``SLOContract`` of every request. Covered: ShareGPT and multi-round
lengths, Poisson and gamma arrivals, the reading and voice QoE traces,
the multi-tenant mix (default tenants and a contracted mix) and the
three adversarial traces. Then the checks of the reference's
``tests/test_workload.py`` that hold within the port.
"""
import dataclasses

import numpy as np
import pytest
from _hypothesis_compat import given, settings, st  # hypothesis or fallback

import repro.workload as jw
import repro_torch.workload as tw


def _spec(s):
    return None if s is None else (type(s).__name__, s.ttft, s.tds)


def _contract(c):
    return None if c is None else (type(c).__name__,
                                   dataclasses.astuple(c))


def _key(r):
    """Every field a generator sets, as plain values."""
    return (r.rid, r.arrival, r.prompt_len, r.output_len, r.tenant,
            r.priority, _spec(r.spec), _contract(r.contract),
            None if r.prompt_tokens is None else list(r.prompt_tokens))


def _keys(reqs):
    return [_key(r) for r in reqs]


def test_exports_match_reference():
    assert tw.__all__ == jw.__all__
    assert [dataclasses.astuple(t) for t in tw.DEFAULT_TENANTS] == \
        [dataclasses.astuple(t) for t in jw.DEFAULT_TENANTS]
    assert sorted(tw.ADVERSARIAL_TRACES) == sorted(jw.ADVERSARIAL_TRACES)


@pytest.mark.parametrize("fn,kw", [
    ("poisson_arrivals", {}), ("gamma_arrivals", {}),
    ("gamma_arrivals", {"cv": 1.5}),
])
def test_arrivals_bitwise(fn, kw):
    a = getattr(jw, fn)(3.3, 500, np.random.default_rng(4), **kw)
    b = getattr(tw, fn)(3.3, 500, np.random.default_rng(4), **kw)
    assert a.dtype == b.dtype
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["reading_qoe_trace", "voice_qoe_trace"])
@pytest.mark.parametrize("ttft", [1.0, 2.5])
def test_qoe_traces_bitwise(fn, ttft):
    a = getattr(jw, fn)(400, np.random.default_rng(5), ttft=ttft)
    b = getattr(tw, fn)(400, np.random.default_rng(5), ttft=ttft)
    assert [_spec(s) for s in a] == [_spec(s) for s in b]


@pytest.mark.parametrize("dataset", ["sharegpt", "multiround"])
def test_sample_lengths_bitwise(dataset):
    pa, oa = jw.sample_lengths(600, np.random.default_rng(6), dataset)
    pb, ob = tw.sample_lengths(600, np.random.default_rng(6), dataset)
    assert (pa.dtype, oa.dtype) == (pb.dtype, ob.dtype)
    np.testing.assert_array_equal(pa, pb)
    np.testing.assert_array_equal(oa, ob)


@pytest.mark.parametrize("kw", [
    dict(dataset="sharegpt", arrival="poisson", qoe_trace="reading"),
    dict(dataset="multiround", arrival="poisson", qoe_trace="reading"),
    dict(dataset="sharegpt", arrival="gamma", qoe_trace="reading"),
    dict(dataset="sharegpt", arrival="gamma", cv=2.0, qoe_trace="voice"),
    dict(dataset="multiround", arrival="gamma", qoe_trace="voice"),
], ids=["sharegpt-poisson", "multiround-poisson", "sharegpt-gamma",
        "voice-gamma-cv2", "multiround-voice"])
@pytest.mark.parametrize("seed", [0, 7])
def test_make_workload_bitwise(kw, seed):
    a = jw.make_workload(150, 3.0, seed=seed, **kw)
    b = tw.make_workload(150, 3.0, seed=seed, **kw)
    assert _keys(a) == _keys(b)
    assert all(type(r).__module__ == "repro_torch.core.request" for r in b)


def _contracted_mix(mod):
    return (mod.TenantSpec("gold", share=0.3, qoe="reading", ttft=0.8,
                           weight=3.0, qoe_floor=0.95),
            mod.TenantSpec("voice", share=0.3, qoe="voice", ttft=1.5),
            mod.TenantSpec("bulk", share=0.4, qoe="fixed", ttft=8.0,
                           tds=2.0, dataset="multiround", weight=0.5))


@pytest.mark.parametrize("arrival", ["poisson", "gamma"])
@pytest.mark.parametrize("mix", ["default", "contracted"])
def test_multitenant_bitwise(arrival, mix):
    a, b = (mod.make_multitenant_workload(
        300, 5.0, seed=3, arrival=arrival,
        tenants=None if mix == "default" else _contracted_mix(mod))
        for mod in (jw, tw))
    assert _keys(a) == _keys(b)
    if mix == "contracted":
        assert any(r.contract is not None for r in b)


@pytest.mark.parametrize("name", ["burst", "heavy_tail", "greedy_tenant"])
@pytest.mark.parametrize("seed", [0, 9])
def test_adversarial_bitwise(name, seed):
    a = jw.make_adversarial_workload(name, 200, 5.0, seed=seed)
    b = tw.make_adversarial_workload(name, 200, 5.0, seed=seed)
    assert _keys(a) == _keys(b)
    direct = getattr(tw, {"burst": "synchronized_burst_workload",
                          "heavy_tail": "heavy_tail_workload",
                          "greedy_tenant": "greedy_tenant_workload"}[name])
    assert _keys(direct(200, 5.0, seed=seed)) == _keys(b)


# ---------------------------------------------------------------------------
# the reference's checks, within the port
# ---------------------------------------------------------------------------

def test_poisson_rate():
    a = tw.poisson_arrivals(3.3, 20_000, np.random.default_rng(0))
    assert abs(len(a) / a[-1] - 3.3) / 3.3 < 0.05


def test_gamma_same_mean_higher_cv():
    g = tw.gamma_arrivals(3.3, 50_000, np.random.default_rng(0), cv=3.0)
    gaps = np.diff(np.concatenate([[0], g]))
    assert abs(gaps.mean() - 1 / 3.3) / (1 / 3.3) < 0.05
    assert gaps.std() / gaps.mean() > 2.0


def test_lengths_reasonable():
    rng = np.random.default_rng(0)
    p, o = tw.sample_lengths(20_000, rng, "sharegpt")
    assert 100 < np.median(p) < 250
    assert 150 < np.median(o) < 300
    assert p.max() <= 1024 and o.max() <= 1024
    p2, _ = tw.sample_lengths(20_000, rng, "multiround")
    assert np.median(p2) > 2.0 * np.median(p)


def test_reading_and_voice_trace_means():
    rng = np.random.default_rng(0)
    read = np.array([s.tds for s in tw.reading_qoe_trace(10_000, rng)])
    voice = np.array([s.tds for s in tw.voice_qoe_trace(5_000, rng)])
    assert 4.2 < read.mean() < 5.2
    assert 3.0 < voice.mean() < 4.0 and voice.mean() < read.mean()


@given(st.integers(1, 200), st.floats(0.5, 10.0), st.integers(0, 100))
@settings(max_examples=30, deadline=None)
def test_workload_wellformed(n, rate, seed):
    wl = tw.make_workload(n, rate, seed=seed)
    assert len(wl) == n
    arr = [r.arrival for r in wl]
    assert arr == sorted(arr)
    for r in wl:
        assert r.prompt_len >= 4 and r.output_len >= 4
        assert r.spec.tds > 0 and r.spec.ttft > 0


@pytest.mark.parametrize("name", ["burst", "heavy_tail", "greedy_tenant"])
def test_adversarial_trace_seed_stability(name):
    a = tw.make_adversarial_workload(name, 120, 5.0, seed=9)
    b = tw.make_adversarial_workload(name, 120, 5.0, seed=9)
    c = tw.make_adversarial_workload(name, 120, 5.0, seed=10)
    assert _keys(a) == _keys(b) and _keys(a) != _keys(c)
    assert [r.rid for r in a] == list(range(len(a)))
    arr = [r.arrival for r in a]
    assert arr == sorted(arr)
    assert len({r.tenant for r in a}) >= 2


def test_adversarial_traces_are_adversarial():
    burst = tw.synchronized_burst_workload(400, 5.0, seed=0, burst_every=30.0)
    assert np.mean(np.diff([r.arrival for r in burst]) < 0.05) > 0.25
    tail = np.array([r.prompt_len
                     for r in tw.heavy_tail_workload(400, 5.0, seed=0)])
    assert tail.max() / np.median(tail) > 5.0
    greedy = tw.greedy_tenant_workload(400, 5.0, seed=0, greedy_share=0.7)
    counts = np.bincount([r.tenant for r in greedy])
    assert counts.max() / len(greedy) > 0.5


def test_multitenant_workload_shapes():
    wl = tw.make_multitenant_workload(300, 5.0, seed=0)
    assert {r.tenant for r in wl} == set(range(len(tw.DEFAULT_TENANTS)))
    assert int(np.argmax(np.bincount([r.tenant for r in wl]))) == 0
    assert all(r.spec.ttft == tw.DEFAULT_TENANTS[2].ttft
               for r in wl if r.tenant == 2)
    arr = [r.arrival for r in wl]
    assert arr == sorted(arr)
