"""The port's copy of ``hlo_stats`` against the reference's (CPU).

``repro_torch.launch.hlo_stats`` is ``repro.launch.hlo_stats`` with its
collective byte factors pulled out into ``collective_bytes`` (which
``launch.dryrun`` applies to DTensor's collectives). On the HLO text of
the reference's ``test_hlo_stats_parser`` (``tests/test_distributed.py``)
and on one with nested whiles around a dot, a fusion call and a
reduce-scatter, both modules must give equal ``collective_stats`` and
``flop_stats``; the parser case's own numbers are checked too.
"""
import pytest

from repro.launch import hlo_stats as ref
from repro_torch.launch import hlo_stats as port

PARSER_HLO = """
HloModule test

%cond (x: s32[]) -> pred[] {
  %c = s32[] constant(12)
  ROOT %lt = pred[] compare(%x, %c), direction=LT
}

%body (x: s32[]) -> s32[] {
  %ag = f32[128,64]{1,0} all-gather(%p), channel_id=1, replica_groups=[2,4]<=[8], dimensions={1}
  ROOT %n = s32[] add(%x, %one)
}

ENTRY %main () -> f32[] {
  %w = (s32[]) while(%t), condition=%cond, body=%body
  %ar = f32[256]{0} all-reduce(%z), channel_id=2, replica_groups=[2,4]<=[8]
  ROOT %r = f32[] constant(0)
}
"""

NESTED_HLO = """
HloModule nested

%inner_cond (x: s32[]) -> pred[] {
  %c = s32[] constant(4)
  ROOT %lt = pred[] compare(%x, %c), direction=LT
}

%fused_dot (a: bf16[8,32], b: bf16[32,16]) -> bf16[8,16] {
  %a = bf16[8,32]{1,0} parameter(0)
  %b = bf16[32,16]{1,0} parameter(1)
  ROOT %d = bf16[8,16]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
}

%inner_body (x: s32[]) -> s32[] {
  %p = f32[64,128]{1,0} parameter(0)
  %q = f32[128,32]{1,0} parameter(1)
  %dot.1 = f32[64,32]{1,0} dot(%p, %q), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %f = bf16[8,16]{1,0} fusion(%u, %v), kind=kOutput, calls=%fused_dot
  %rs = bf16[16,32]{1,0} reduce-scatter(%dot.1), channel_id=3, replica_groups=[4,2]<=[8], dimensions={0}
  ROOT %n = s32[] add(%x, %one)
}

%outer_cond (x: s32[]) -> pred[] {
  %c = s32[] constant(3)
  ROOT %lt = pred[] compare(%x, %c), direction=LT
}

%outer_body (x: s32[]) -> s32[] {
  %w = (s32[]) while(%t), condition=%inner_cond, body=%inner_body
  %ar = f32[512]{0} all-reduce(%z), channel_id=4, replica_groups=[1,8]<=[8]
  ROOT %n = s32[] add(%x, %one)
}

ENTRY %main () -> f32[] {
  %x = f32[16,256]{1,0} parameter(0)
  %y = f32[256,8]{1,0} parameter(1)
  %top = f32[16,8]{1,0} dot(%x, %y), lhs_contracting_dims={1}, rhs_contracting_dims={0}
  %w = (s32[]) while(%t), condition=%outer_cond, body=%outer_body
  ROOT %r = f32[] constant(0)
}
"""


@pytest.mark.parametrize("hlo", [PARSER_HLO, NESTED_HLO],
                         ids=["parser", "nested"])
def test_collective_and_flop_stats_equal_reference(hlo):
    got, want = port.collective_stats(hlo), ref.collective_stats(hlo)
    assert got.bytes_by_op == want.bytes_by_op
    assert got.count_by_op == want.count_by_op
    assert got.total_bytes == want.total_bytes
    gf, wf = port.flop_stats(hlo), ref.flop_stats(hlo)
    assert (gf.naive_dot_flops, gf.trip_aware_dot_flops,
            gf.trip_aware_dot_bytes, gf.correction) == \
        (wf.naive_dot_flops, wf.trip_aware_dot_flops,
         wf.trip_aware_dot_bytes, wf.correction)


def test_hlo_stats_parser():
    """The reference's own parser case, on the port's module."""
    stats = port.collective_stats(PARSER_HLO)
    assert stats.count_by_op["all-gather"] == 12
    assert stats.bytes_by_op["all-gather"] == pytest.approx(
        128 * 64 * 4 * (3 / 4) * 12)
    assert stats.bytes_by_op["all-reduce"] == pytest.approx(256 * 4 * 2 * 0.75)


def test_nested_whiles_multiply():
    """Trip counts nest (3 x 4 = 12 for the inner body) and a fusion's
    dot runs once per call of its caller."""
    f = port.flop_stats(NESTED_HLO)
    top = 2 * 16 * 8 * 256
    inner = 2 * 64 * 32 * 128
    fused = 2 * 8 * 16 * 32
    assert f.naive_dot_flops == top + inner + fused
    assert f.trip_aware_dot_flops == top + 12 * (inner + fused)
    c = port.collective_stats(NESTED_HLO)
    assert c.count_by_op == {"reduce-scatter": 12, "all-reduce": 3}
    assert c.bytes_by_op["reduce-scatter"] == 12 * 16 * 32 * 2 * (2 - 1)
    assert c.bytes_by_op["all-reduce"] == 3 * 512 * 4 * 2 * 7 / 8
