"""The metric arithmetic on a synthetic record of stamps."""
import pytest

from qoebench import registry
from qoebench.frozen import counts, endtoend


def _record():
    # window [10, 20); four requests due in it, one before
    reqs = [
        dict(rid=0, due=5.0, output_len=3, ttft=1.0, tds=2.0,
             emits=[[5.5, 1], [10.5, 1], [11.0, 1]], admit=5.1, finish=11.0,
             preemptions=0),
        # on time, finished: QoE 1, TTFT 0.5
        dict(rid=1, due=10.0, output_len=3, ttft=1.0, tds=2.0,
             emits=[[10.5, 1], [11.0, 2]], admit=10.2, finish=11.0,
             preemptions=0),
        # TTFT 2.0, two tokens in the window, one after its end
        dict(rid=2, due=12.0, output_len=10, ttft=1.0, tds=2.0,
             emits=[[14.0, 1], [19.0, 1], [20.5, 1]], admit=13.0,
             finish=None, preemptions=1),
        # stalled: no token by the end at 20 -> TTFT 20 - 15 = 5
        dict(rid=3, due=15.0, output_len=5, ttft=1.0, tds=2.0, emits=[],
             admit=None, finish=None, preemptions=0),
        # TTFT 0.25
        dict(rid=4, due=16.0, output_len=2, ttft=1.0, tds=2.0,
             emits=[[16.25, 2]], admit=16.1, finish=16.25, preemptions=0),
    ]
    return dict(window=[10.0, 20.0], seconds=10.0, requests=reqs,
                steps=40, sched_s=0.08, sched_steps=40, admitted=3,
                preemptions=1, kv_util=[0.5, 0.7, 0.9], iterations=200)


def test_end_to_end_metrics_by_hand():
    r = _record()
    assert sorted(endtoend.ttfts(r)) == [0.25, 0.5, 2.0, 5.0]
    assert endtoend.ttft_p95_s(r) == pytest.approx(
        2.0 + 0.85 * (5.0 - 2.0))
    # tokens stamped in [10, 20): 1 + 1 (rid 0) + 3 (rid 1) + 2 (rid 2)
    # + 2 (rid 4)
    assert endtoend.tokens_per_s(r) == pytest.approx(9 / 10.0)
    q = endtoend.qoe_mean(r)
    assert 0.0 < q < 1.0
    assert len(endtoend.due_in_window(r)) == 4


def test_per_layer_readers_by_hand():
    r = _record()
    read = {m: registry.metric(m).read for m in (
        "sched_ms_per_step", "preempt_per_req", "kv_used_share",
        "decode_iter_ms", "admit_lag_p95_s")}
    assert read["sched_ms_per_step"](r) == pytest.approx(2.0)
    assert read["preempt_per_req"](r) == pytest.approx(1 / 3)
    assert read["kv_used_share"](r) == pytest.approx(0.7)
    assert read["decode_iter_ms"](r) == pytest.approx(50.0)
    # lags: 0.2, 1.0, 5.0 (not admitted by 20), 0.1
    assert read["admit_lag_p95_s"](r) == pytest.approx(
        1.0 + 0.85 * (5.0 - 1.0))


def test_device_readers_by_hand_and_silent_without_a_trace():
    model = registry.config("granite-3-2b")["model"]
    prof = dict(busy_s=0.75, window_s=3.0, kernels=10, flash_dev_s=0.02,
                flash_bound_s=0.01, decode_dev_s=0.5, decode_bound_s=0.1,
                moe_decode_dev_s=0.3, decode_range_dev_s=0.6)
    rec = dict(profile=prof, model=model,
               prefill_calls=[dict(wall=0.1, lengths=[100, 50])],
               decode_calls=[dict(wall=0.2, j=2, lengths=[10, 20])])
    m = {n: registry.metric(n).read for n in (
        "device_idle", "flash_roofline", "decode_attn_roofline",
        "moe_dev_share", "mfu.prefill", "mfu.decode")}
    assert m["device_idle"](rec) == pytest.approx(0.75)
    assert m["flash_roofline"](rec) == pytest.approx(50.0)
    assert m["decode_attn_roofline"](rec) == pytest.approx(20.0)
    assert m["moe_dev_share"](rec) == pytest.approx(0.5)
    pf = counts.prefill_flops(model, [100, 50])
    assert m["mfu.prefill"](rec) == pytest.approx(100 * pf / 0.1 / 989e12)
    df = counts.decode_flops(model, [11, 21]) + counts.decode_flops(
        model, [12, 22])
    assert m["mfu.decode"](rec) == pytest.approx(100 * df / 0.2 / 989e12)
    for f in m.values():
        assert f({"model": model}) is None


def test_attention_counts_by_hand():
    model = registry.config("granite-3-2b")["model"]
    # one row of 4 tokens: 10 causal pairs; q,o 32 heads, k,v 8 heads, hd 64
    f = 4 * 32 * 64 * 10
    b = 4 * (2 * 32 + 2 * 8) * 64 * 2
    assert counts.flash_bound_s(model, [4]) == pytest.approx(
        max(f / 989e12, b / 3.35e12))
    # decode: one row attending 100 positions, pages of 16
    f = 4 * 32 * 64 * 100
    b = 100 * 2 * 8 * 64 * 2 + 7 * 4 + 2 * 32 * 64 * 2
    assert counts.decode_bound_s(model, [100]) == pytest.approx(
        max(f / 989e12, b / 3.35e12))
