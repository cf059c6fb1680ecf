"""The port's copies of the reference's host modules that the server
slice needs — ``core/token_buffer.py``, ``core/network.py``,
``core/scoring.py`` and ``serving/tolerance.py`` — against the
reference's, on the same inputs (CPU, no model). These modules are
framework-free, so the gate is equality, not a tolerance.
"""
import numpy as np
import pytest

from repro.core import NETWORK_SCENARIOS as J_SCENARIOS
from repro.core import TokenBuffer as JTokenBuffer
from repro.core import fairness_report as j_fairness_report
from repro.core import make_network as j_make_network
from repro.core import qoe_under_network as j_qoe_under_network
from repro.core.request import ReqState as JReqState
from repro.core.request import Request as JRequest
from repro.core.qoe import QoESpec as JSpec
from repro.serving import Tolerance as JTolerance
from repro.serving import ToleranceSpec as JToleranceSpec
from repro.serving import compare_requests as j_compare
from repro_torch.core import (NETWORK_SCENARIOS, QoESpec, TokenBuffer,
                              fairness_report, jains_index, make_network,
                              qoe_under_network)
from repro_torch.core.request import ReqState, Request
from repro_torch.serving import Tolerance, ToleranceSpec, compare_requests


def _emits(seed, n=30):
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(0.08, n)) + 0.3


@pytest.mark.parametrize("name", sorted(NETWORK_SCENARIOS))
def test_network_and_token_buffer_match_reference(name):
    assert NETWORK_SCENARIOS == J_SCENARIOS
    e = _emits(1)
    for seed in (0, 7):
        net, jnet = make_network(name, seed), j_make_network(name, seed)
        np.testing.assert_array_equal(net.arrivals(e), jnet.arrivals(e))
        spec, jspec = QoESpec(ttft=1.0, tds=4.8), JSpec(ttft=1.0, tds=4.8)
        assert qoe_under_network(e, 0.0, spec, make_network(name, seed)) \
            == j_qoe_under_network(e, 0.0, jspec, j_make_network(name, seed))
        buf = TokenBuffer(4.8, network=make_network(name, seed))
        jbuf = JTokenBuffer(4.8, network=j_make_network(name, seed))
        vis = [buf.push(float(t)) for t in e]
        assert vis == [jbuf.push(float(t)) for t in e]
        assert buf.arrivals == jbuf.arrivals and len(buf) == len(e)
        assert all(b - a >= 1 / 4.8 - 1e-12 for a, b in zip(vis, vis[1:]))
        assert buf.buffered_at(vis[5]) == jbuf.buffered_at(vis[5])
    with pytest.raises(ValueError):
        make_network("carrier-pigeon")


def _served(make, spec, state, rid, tenant, arrival, emits, tokens,
            cancelled=False):
    r = make(rid=rid, arrival=arrival, prompt_len=8,
             output_len=len(emits), spec=spec(ttft=1.0, tds=4.8),
             tenant=tenant)
    r.emit_times = [float(t) for t in emits]
    r.output_tokens = list(tokens)
    r.generated = len(emits)
    r.state = state.FINISHED
    r.finish_time = r.emit_times[-1]
    r.cancelled = cancelled
    return r


def _population(make, spec, state, skew=0.0, jitter=0.0, flip=None,
                cancel=None):
    rng = np.random.default_rng(0)
    out = []
    for i in range(12):
        arr = i * 0.2
        e = arr + 0.4 + np.arange(10) * (0.12 + 0.03 * (i % 3))
        e = e + skew + (rng.uniform(0, jitter, 10) if jitter else 0.0)
        toks = list(100 * i + np.arange(10))
        if i == flip:
            toks[4] += 1
        out.append(_served(make, spec, state, i, i % 3, arr, e, toks,
                           cancelled=(i == cancel)))
    return out


def test_scoring_matches_reference():
    pop = _population(Request, QoESpec, ReqState, jitter=0.3)
    jpop = _population(JRequest, JSpec, JReqState, jitter=0.3)
    rep = fairness_report(pop, duration=5.0)
    assert rep == j_fairness_report(jpop, duration=5.0)
    assert rep["n_tenants"] == 3 and 0 < rep["jains_index"] <= 1
    assert jains_index([1.0, 1.0, 1.0]) == 1.0


@pytest.mark.parametrize("case", [
    dict(), dict(jitter=0.05), dict(skew=0.8), dict(flip=3),
    dict(cancel=5, jitter=0.02),
], ids=["identical", "jitter", "skew", "token-flip", "cancelled"])
def test_tolerance_report_matches_reference(case):
    spec = ToleranceSpec(ttft_mean_diff=Tolerance(abs_tol=0.1),
                         qoe_mean_diff=Tolerance(abs_tol=0.05, rel_tol=0.1))
    jspec = JToleranceSpec(ttft_mean_diff=JTolerance(abs_tol=0.1),
                           qoe_mean_diff=JTolerance(abs_tol=0.05,
                                                    rel_tol=0.1))
    cand = {k: v for k, v in case.items() if k != "flip"}
    ref = _population(Request, QoESpec, ReqState)
    got = compare_requests(ref, _population(
        Request, QoESpec, ReqState, flip=case.get("flip"), **cand), spec)
    jref = _population(JRequest, JSpec, JReqState)
    want = j_compare(jref, _population(
        JRequest, JSpec, JReqState, flip=case.get("flip"), **cand), jspec)
    assert got.summary() == want.summary()
    assert (got.ok, got.n_pairs, got.missing_rids, got.token_mismatches,
            got.skipped_rids) == (want.ok, want.n_pairs, want.missing_rids,
                                  want.token_mismatches, want.skipped_rids)
    assert [(g.name, g.ref, g.cand, g.passed) for g in got.gates] == \
        [(g.name, g.ref, g.cand, g.passed) for g in want.gates]
    assert got.ok == (not case or case == dict(jitter=0.05)
                      or "cancel" in case)
