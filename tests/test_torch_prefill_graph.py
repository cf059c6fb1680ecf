"""The bucketed prefill's held caches and the model's graph switch on the
CPU: a prefill into a held or a fresh cache runs the eager body here and
never captures; a wrapper on the instance's ``prefill`` (the benchmark's
way in) sees one call per bucket group; the held cache's zeroing hands
the page-pool writer the bytes a fresh cache would, position ``length``
included, after a longer call; the launch counters leave a capture's
recorded launches out and add them per replay; and the kinds graphed
leave out MoE. The capture and the replays themselves run on the card
(``tests/test_torch_cuda.py``)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core import (TPU_V5E, LatencyModel, SchedulerConfig,
                              make_scheduler)
from repro_torch.kernels import cuda as tcuda
from repro_torch.models import Model
from repro_torch.models import model as model_mod
from repro_torch.models.transformer import PORTED_KINDS
from repro_torch.obs.spans import SpanLog
from repro_torch.serving import ServingEngine
from repro_torch.serving.engine import BucketedPrefill

torch.set_num_threads(1)
DEPTH = 96


def _model():
    m = Model(get_smoke_config("granite-3-2b"), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _engine(m, p, page_size=16):
    lat = LatencyModel(m.cfg, TPU_V5E)
    sched = make_scheduler("andes", 4096, lat, SchedulerConfig(delta_t=2.0))
    return ServingEngine(m, p, sched, lat, num_slots=4, max_seq=DEPTH,
                         capacity_tokens=4096, page_size=page_size,
                         device="cpu")


def _toks(m, n, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, m.cfg.vocab_size, n).astype(np.int32)


@pytest.mark.parametrize("held", [True, False])
def test_cpu_prefill_runs_eager_and_never_captures(held):
    m, p = _model()
    cache = (m.hold_cache if held else m.init_cache)(1, DEPTH)
    batch = {"tokens": torch.as_tensor(_toks(m, 32, 1))[None],
             "lengths": torch.tensor([29], dtype=torch.int32)}
    log = SpanLog()
    call = log.begin("engine.prefill_call")
    assert m._graph_slot(p, batch, cache) == (None, None)
    logits, out = m.prefill(p, batch, cache)
    log.end(call)
    want_logits, want = m.prefill(p, batch, m.init_cache(1, DEPTH))
    assert torch.equal(logits, want_logits)
    for key in ("k", "v", "length"):
        assert torch.equal(out[key], want[key]), key
    assert log.counters == {}
    assert [s.payload for s in log.spans() if s.name == "model.prefill"] \
        == [{"graph": 0}]
    assert [s.name for s in log.spans()].count("model.cache_fill") == 1
    assert all(not g for g in m._graphs.values())
    assert m._graph_pool is None and m._capture_stream is None


def test_instance_wrapper_sees_one_call_per_bucket_group():
    """As the benchmark's traced run wraps it: ``model.prefill`` replaced
    on the instance by a function of (params, batch, cache)."""
    m, p = _model()
    eng = _engine(m, p, page_size=None)
    seen = []
    inner = m.prefill

    def prefill(params, batch, cache):
        seen.append(tuple(batch["tokens"].shape))
        return inner(params, batch, cache)

    m.prefill = prefill
    lens = (5, 9, 20, 30, 40, 3)            # buckets 16, 16, 32, 32, 64, 16
    toks = [_toks(m, n, i) for i, n in enumerate(lens)]
    _, first, _, groups = eng._prefill.prefill_into(
        p, eng.cache, list(range(len(lens) - 2)) + [0, 1], toks)
    assert groups == 3
    assert seen == [(4, 16), (2, 32), (1, 64)]
    assert len(first) == len(lens)


def test_held_cache_reset_gives_the_paged_writer_fresh_bytes():
    """A 32-token prompt fills bucket 32 after a 64-bucket call into the
    same held cache: position 32, which the writer copies (length + 1
    positions) and this call never writes, holds what a fresh cache
    holds, not the longer call's k/v."""
    m, p = _model()
    eng = _engine(m, p)
    assert eng.physical_pages
    bp = eng._prefill
    bp.run(p, [_toks(m, 50, 2)])                       # bucket 64
    first, src = bp.run(p, [_toks(m, 32, 3)])          # bucket 32
    fresh = BucketedPrefill(m, eng._cache_seq, torch.float32,
                            max_seq=DEPTH)
    want_first, want = fresh.run(p, [_toks(m, 32, 3)])
    assert src["k"] is bp._held[1]["k"] and len(bp._held) == 1
    assert torch.equal(first, want_first)
    for key in ("k", "v", "length"):
        assert torch.equal(src[key], want[key]), key
    assert not src["k"][:, :, 32:].any() and not src["v"][:, :, 32:].any()
    pages = eng._max_pages
    eng._bt_host = np.full((eng.kv.num_slots + 1, pages), eng._pool_pages,
                           np.int32)
    eng._bt_host[0] = np.arange(pages)
    pad = np.array([0], np.int32)
    pools = []
    for rows in (src, want):
        cache = {k: v.clone() for k, v in eng.cache.items()}
        cache["k"].fill_(7.0)
        cache["v"].fill_(7.0)
        pools.append(eng._paged_writer(cache, rows, pad))
    for key in ("k", "v"):
        assert torch.equal(pools[0][key], pools[1][key]), key
        # positions 0..32 of slot 0 (pages 0..2) were written, 32 as zero
        assert not pools[0][key][:, 2, 0].any()


def test_recorded_launches_run_only_on_replay():
    before = dict(tcuda.launches), dict(tcuda.variant_launches)
    with tcuda.recorded_launches() as rec:
        tcuda.launches["flash_attention"] += 3
        tcuda.variant_launches["flash_attention/tensor_core"] += 3
    assert (dict(tcuda.launches), dict(tcuda.variant_launches)) == before
    assert rec == {"flash_attention": 3, "flash_attention/tensor_core": 3}
    tcuda.add_launches(rec)
    tcuda.add_launches(rec)
    assert tcuda.launches["flash_attention"] == \
        before[0]["flash_attention"] + 6
    assert tcuda.variant_launches["flash_attention/tensor_core"] == \
        before[1]["flash_attention/tensor_core"] + 6


def test_graph_kinds_leave_out_moe():
    assert "dense" in model_mod.GRAPH_KINDS
    assert "moe" not in model_mod.GRAPH_KINDS
    assert set(model_mod.GRAPH_KINDS) <= set(PORTED_KINDS)


def test_held_caches_of_several_row_counts_live_as_long_as_they_are_held():
    """Each row count's held cache is registered by its own `length`
    leaf, multi-row ones too, and drops out once freed."""
    import gc
    m, _ = _model()
    held = {r: m.hold_cache(r, DEPTH) for r in (1, 2, 4)}
    batch = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
             "lengths": torch.tensor([16, 3], dtype=torch.int32)}
    assert len(m._graphs) == 3
    assert m._graphs.get(id(held[2]["length"])) == {}
    assert m._graphs.get(id(m.init_cache(2, DEPTH)["length"])) is None
    assert m._graph_slot({}, batch, held[2]) == (None, None)   # the CPU
    del held
    gc.collect()
    assert m._graphs == {}


def test_the_graph_decision_on_a_model_placed_on_cuda():
    """``_graph_slot`` alone, with the model's device read as CUDA (the
    decision reads only the device, the kind, the cache, the batch's keys
    and grad mode): a held cache engages, anything else runs eagerly."""
    m, p = _model()
    held = m.hold_cache(1, DEPTH)
    batch = {"tokens": torch.zeros((1, 16), dtype=torch.int32),
             "lengths": torch.tensor([9], dtype=torch.int32)}
    m.device = torch.device("cuda")
    graphs, key = m._graph_slot(p, batch, held)
    assert graphs is m._graphs[id(held["length"])]
    assert key[0] == (1, 16)
    assert m._graph_slot(p, batch, m.init_cache(1, DEPTH, abstract=True)) \
        == (None, None)
    assert m._graph_slot(p, dict(batch, frames=batch["tokens"]), held) \
        == (None, None)
    grad = dict(p, final_norm={"scale": p["final_norm"]["scale"]
                               .clone().requires_grad_()})
    assert m._graph_slot(grad, batch, held) == (None, None)
    with torch.no_grad():
        assert m._graph_slot(grad, batch, held)[0] is not None
    m.cfg = get_smoke_config("qwen2-moe-a2.7b")
    assert m._graph_slot(p, batch, held) == (None, None)
