"""The port's speculative engine against the JAX reference engine at
k = 1 and k = 2 (CPU, f32; k = 3 is in ``test_torch_speculative.py``).

The engine tests' trace (``test_torch_speculative``: 12 staggered requests,
EOS off, 4 slots, max_seq 64, Andes, a KV capacity of 100 tokens, swap
preemption) runs through both engines for each draft — exact, perturbed
and foreign — with weights carried from JAX. Timing fingerprints,
preemptions, tokens, acceptance counters and the hot-path counters must
be identical, any token flip classified as a documented near-tie by
``audit_flips``.
"""
import pytest

from test_torch_speculative import (DRAFTS, assert_matches_reference,
                                    jax_spec_engine, run_jax, run_torch,
                                    torch_spec_engine)


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("draft", DRAFTS)
def test_spec_engine_matches_reference(draft, k):
    jeng = jax_spec_engine(draft, k)
    jout = run_jax(jeng)
    teng = torch_spec_engine(draft, k)
    tout = run_torch(teng)
    assert teng.preemptions > 0, "the trace must preempt"
    assert teng.spec_steps > 0
    assert teng._cache_seq == 64 + k + 1
    assert_matches_reference(jout, jeng, tout, teng)
