"""The harness's check, with the timed path broken underneath, comes out
not correct: one run of the one-token smoke cell per fault its timed path
(admission and the bucketed prefill) can have on one chip. Its served
token comes from the prefill alone, so no decode step, and no state that
a step hands on, is on that path; the exchange between chips does not
exist here."""
import pytest

from test_qoebench_reference import run_smoke_cell


def _token_altered(monkeypatch):
    """A token altered where it is produced: the prefill hands back each
    row's first choice plus one."""
    from repro_torch.serving.engine import BucketedPrefill
    inner = BucketedPrefill._call

    def call(self, params, tokens, lengths, frames):
        ids, cache = inner(self, params, tokens, lengths, frames)
        return (ids + 1) % self.model.cfg.vocab_size, cache

    monkeypatch.setattr(BucketedPrefill, "_call", call)


def _half_prompt(monkeypatch):
    """Half of each prompt left out: the prefill attends, and answers
    from, the first half of the prompt's tokens."""
    from repro_torch.models.model import Model
    inner = Model.prefill

    def prefill(self, params, batch, cache):
        lengths = batch["lengths"]
        batch = dict(batch, lengths=(lengths + 1) // 2)
        return inner(self, params, batch, cache)

    monkeypatch.setattr(Model, "prefill", prefill)


def _padding_read(monkeypatch):
    """The prompt's padding read as prompt: the prefill attends the whole
    padded bucket and answers from its last position."""
    from repro_torch.models.model import Model
    inner = Model.prefill

    def prefill(self, params, batch, cache):
        tokens = batch["tokens"]
        full = tokens.new_full(batch["lengths"].shape, tokens.shape[1])
        return inner(self, params, dict(batch, lengths=full), cache)

    monkeypatch.setattr(Model, "prefill", prefill)


@pytest.mark.parametrize("fault", [_token_altered, _half_prompt,
                                   _padding_read])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    result, record = run_smoke_cell(tmp_path, "tiny-dense.score",
                                    seconds=6.0)
    assert record["check"]["tokens"] == record["check"]["requests"] == 8
    assert not result["correct"], result["checks"]
