"""The frozen yardstick: QoE arithmetic on hand-worked cases and against
the port's copy, the generators' determinism, and the pacing spec
against the frozen roofline."""
import numpy as np
import pytest

from qoebench import registry
from qoebench.frozen import counts, qoe, workload
from qoebench.frozen.hardware import H100_ROOFLINE


def test_pace_delivery_holds_fast_tokens_to_the_reading_speed():
    d = qoe.pace_delivery([0.0, 0.0, 0.0, 1.0], tds=2.0)
    assert d.tolist() == [0.0, 0.5, 1.0, 1.5]


def test_qoe_of_a_stream_on_its_expected_timeline_is_one():
    # first token at the expected TTFT, then exactly at the TDS
    e = 1.0 + np.arange(10) / 4.0
    assert qoe.qoe_exact(e, 0.0, 1.0, 4.0) == pytest.approx(1.0)


def test_qoe_by_hand_for_a_late_start():
    # 4 tokens at 2 tok/s starting 1 s late (ttft 1, expected at 1.0)
    e = np.array([2.0, 2.5, 3.0, 3.5])
    # ttlt 3.5: expected ramp from 1.0 capped at 4 tokens at 3.0, then flat
    s_exp = 0.5 * 2.0 * 2.0 ** 2 + 4 * 0.5
    s_act = 1.5 + 1.0 + 0.5 + 0.0
    assert qoe.qoe_exact(e, 0.0, 1.0, 2.0) == pytest.approx(s_act / s_exp)


def test_a_stalled_request_scores_zero_and_counts_to_the_end():
    # due at 10, nothing by the window's end at 14
    assert qoe.request_qoe([], 10.0, 1.0, 5.0, 100, 14.0) == 0.0
    # still inside its expected TTFT: nothing was owed yet
    assert qoe.request_qoe([], 10.0, 1.0, 5.0, 100, 10.5) == 1.0


def test_a_request_streaming_at_the_end_is_scored_on_what_was_shown():
    # due 0, 100 tokens owed at 2 tok/s after 1 s; 2 shown at 2 and 2.5
    # by the end at 3 s (a third, stamped after the end, is not counted)
    got = qoe.request_qoe([2.0, 2.5, 3.5], 0.0, 1.0, 2.0, 100, 3.0)
    s_exp = 0.5 * 2.0 * 2.0 ** 2            # ramp over [1, 3], uncapped
    s_act = 1.0 + 0.5
    assert got == pytest.approx(s_act / s_exp)
    # finished inside the window: Eq. 1 over its own TTLT
    e = [1.0, 1.5, 2.0]
    assert qoe.request_qoe(e, 0.0, 1.0, 2.0, 3, 3.0) == pytest.approx(
        qoe.qoe_exact(e, 0.0, 1.0, 2.0, response_len=3))


def test_frozen_qoe_matches_the_ports():
    from repro_torch.core import qoe as port
    rng = np.random.default_rng(0)
    for _ in range(20):
        e = np.sort(rng.uniform(0, 20, rng.integers(1, 40)))
        arr, ttft, tds = rng.uniform(0, 1), 1.0, rng.uniform(3, 6)
        spec = port.QoESpec(ttft=ttft, tds=tds)
        assert qoe.qoe_exact(e, arr, ttft, tds) == port.qoe_exact(e, arr,
                                                                  spec)
        assert np.array_equal(qoe.pace_delivery(e, tds),
                              port.pace_delivery(e, tds))


def test_frozen_lengths_match_the_ports():
    from repro_torch.workload.sharegpt import sample_lengths
    for ds in ("sharegpt", "multiround"):
        a = workload.sample_lengths(50, np.random.default_rng(3), ds)
        b = sample_lengths(50, np.random.default_rng(3), ds)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("mix", ["chat", "burst"])
def test_same_seed_same_trace_and_every_seed_the_same_work(mix):
    m = registry.traffic(mix)
    a = workload.make_trace(m, 2**31 + 99, 20.0, 1000)
    b = workload.make_trace(m, 2**31 + 99, 20.0, 1000)
    c = workload.make_trace(m, 5, 20.0, 1000)
    key = [(r.due, r.prompt_len, r.output_len, r.tds) for r in a]
    assert key == [(r.due, r.prompt_len, r.output_len, r.tds) for r in b]
    assert all(np.array_equal(x.prompt, y.prompt) for x, y in zip(a, b))
    assert key != [(r.due, r.prompt_len, r.output_len, r.tds) for r in c]
    for span in (False, True):
        xa = [r for r in a if r.in_window is span]
        xc = [r for r in c if r.in_window is span]
        assert sorted(r.output_len for r in xa) == \
            sorted(r.output_len for r in xc)
        assert sorted(r.prompt_len for r in xa) == \
            sorted(r.prompt_len for r in xc)
    lead = m["lead_in_s"]
    assert all((r.due >= lead) == r.in_window for r in a)
    assert max(r.due for r in a) < lead + 20.0
    assert sum(r.in_window for r in a) == round(m["rate"] * 20.0)


def _lat(name):
    from repro_torch.core.latency_model import LatencyModel
    from qoebench.frozen.hardware import hardware_spec
    from qoebench.harness import model_config
    cfgd = registry.config(name)
    return cfgd["model"], LatencyModel(model_config(cfgd), hardware_spec())


def test_the_pacing_spec_is_a_roofline_with_no_discount():
    assert H100_ROOFLINE["efficiency"] == 1.0
    assert H100_ROOFLINE["overhead"] == 0.0
    assert H100_ROOFLINE["peak_flops"] == 989e12
    assert H100_ROOFLINE["hbm_bw"] == 3.35e12


@pytest.mark.parametrize("name", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_decode_price_never_above_the_frozen_roofline(name):
    model, lat = _lat(name)
    for b in (1, 8, 64, 256, 512):
        for ctx in (16, 300, 2047):
            att = [ctx + 1] * b
            assert lat.iter_latency(b, b * ctx) <= \
                counts.decode_step_s(model, att)


@pytest.mark.parametrize("name", ["granite-3-2b", "qwen2-moe-a2.7b"])
def test_prefill_price_above_the_roofline_only_by_the_vocabulary_rows(name):
    """The port's latency model counts 2 FLOPs per embedding and
    unembedding weight for every prompt token; a prefill computes the
    logits of the last position only. That is the whole of its excess
    over the frozen roofline, and it shows only where a prompt is long
    enough for the prefill to be compute-bound."""
    from qoebench.frozen.hardware import PEAK_BF16_FLOPS
    model, lat = _lat(name)
    vocab = counts.unembed_params(model) * (
        1 if model.get("tie_embeddings") else 2)
    for p in (4, 16, 64, 148, 256, 512, 1024, 2048):
        price = lat.prefill_latency(p)
        least = counts.prefill_step_s(model, [p])
        assert price <= least + 2.0 * vocab * p / PEAK_BF16_FLOPS
        if p <= 256:
            assert price <= least


def test_pool_rule_by_hand():
    from qoebench.frozen.pool import pool_tokens
    # 0.9 * 100 GB - 20 - 10 = 60 GB over 1 MB a token, pages of 16
    assert pool_tokens(100 * 10**9, 20 * 10**9, 10 * 10**9, 10**6, 16) \
        == 60_000
    assert counts.kv_token_bytes(registry.config("granite-3-2b")["model"]) \
        == 81_920
    with pytest.raises(ValueError):
        pool_tokens(10, 9, 1, 1, 16)


def test_a_one_token_closed_mix_keeps_its_prompts_and_asks_one_token():
    m = registry.traffic("score")
    a = workload.make_trace(m, 2**31 + 99, 20.0, 1000)
    c = workload.make_trace(m, 5, 20.0, 1000)
    assert len(a) == len(c) == m["clients"]
    assert all(len(q) == m["per_client"] for q in a)
    flat_a = [r for q in a for r in q]
    flat_c = [r for q in c for r in q]
    assert {r.output_len for r in flat_a + flat_c} == {1}
    assert sorted(r.prompt_len for r in flat_a) == \
        sorted(r.prompt_len for r in flat_c)
    assert [r.prompt_len for r in flat_a] != [r.prompt_len for r in flat_c]
    prompt, _ = workload.sample_lengths(len(flat_a), np.random.default_rng(
        m["sizes_seed"]), m["lengths"])
    assert sorted(r.prompt_len for r in flat_a) == sorted(prompt.tolist())
