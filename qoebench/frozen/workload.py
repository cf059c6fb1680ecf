"""Traffic generators: frozen copies of the port's ShareGPT-shaped lengths
(``workload/sharegpt.py:sample_lengths``), its Poisson and gamma arrivals
(``workload/arrivals.py``) and its reading-speed QoE trace
(``workload/qoe_traces.py:reading_qoe_trace``), and ``make_trace``, which
turns a traffic mix's parameters and a seed into the requests of one run.

A run's seed changes the order of the work and not its amount. The sizes
(lengths, inter-arrival gaps, reading speeds) are one multiset per span,
drawn once from the mix's own ``sizes_seed``, with the gaps scaled so the
span is filled exactly; the run's seed permutes each multiset and draws
the prompts' token ids. So every seed offers the same requests over the
lead-in and the same requests over the window, and two seeds differ in
which request comes when.

A closed-loop mix (``arrival: closed``) has ``clients`` clients, each
sending its next request the moment its last one finishes:
``make_closed_trace`` gives each client its queue, from one multiset of
``clients * per_client`` sizes drawn from ``sizes_seed`` and dealt out
in the order the run's seed gives. Their due times are set as they are
sent.

A mix with ``output_len`` asks every request for that many tokens (one,
for a label or a score) in place of the sampled output lengths; the
prompts keep the sampled shape.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

WORD_PER_TOKEN = 0.75
EXPECTED_TTFT = 1.0

# (share, words per minute) by age group: the paper's Table 1
READING_WPM = [
    (0.280, 236),   # 18-24
    (0.519, 200),   # 25-44
    (0.112, 192),   # 45-54
    (0.056, 185),   # 55-64
    (0.033, 175),   # 65+
]


def sample_lengths(n: int, rng: np.random.Generator,
                   dataset: str = "sharegpt") -> Tuple[np.ndarray, np.ndarray]:
    """(prompt_len, output_len) int arrays of the paper's Fig. 9 shapes."""
    if dataset == "sharegpt":
        p = rng.lognormal(mean=5.0, sigma=0.9, size=n)        # median ~148
    elif dataset == "multiround":
        p = rng.lognormal(mean=6.1, sigma=0.7, size=n)        # ~3x longer
    else:
        raise ValueError(dataset)
    o = rng.lognormal(mean=5.3, sigma=0.8, size=n)            # median ~200
    prompt = np.clip(p, 4, 1024).astype(np.int64)
    out = np.clip(o, 4, 1024).astype(np.int64)
    return prompt, out


def poisson_gaps(rate: float, n: int, rng: np.random.Generator) -> np.ndarray:
    """Exponential inter-arrival gaps at `rate` req/s."""
    return rng.exponential(1.0 / rate, size=n)


def gamma_gaps(rate: float, n: int, rng: np.random.Generator,
               cv: float = 3.0) -> np.ndarray:
    """Gamma inter-arrival gaps of coefficient of variation `cv` and mean
    1/rate (the paper's bursty setting, cv = 3)."""
    shape = 1.0 / (cv * cv)
    return rng.gamma(shape, 1.0 / (rate * shape), size=n)


def reading_tds(n: int, rng: np.random.Generator) -> np.ndarray:
    """Expected token delivery speeds (tokens/s) of the reading trace."""
    shares = np.array([s for s, _ in READING_WPM])
    shares = shares / shares.sum()
    wpms = np.array([w for _, w in READING_WPM], dtype=np.float64)
    idx = rng.choice(len(READING_WPM), size=n, p=shares)
    return wpms[idx] / 60.0 / WORD_PER_TOKEN


@dataclasses.dataclass
class TraceRequest:
    rid: int
    due: float              # seconds after the engine's clock starts
    prompt_len: int
    output_len: int
    ttft: float             # expected time to first token (s)
    tds: float              # expected delivery speed (tokens/s)
    prompt: np.ndarray      # int32 token ids
    in_window: bool


def _lengths(mix: dict, n: int, base: np.random.Generator):
    """(prompt_len, output_len) of n requests of the mix."""
    prompt, out = sample_lengths(n, base, mix["lengths"])
    if "output_len" in mix:
        out = np.full(n, int(mix["output_len"]), dtype=np.int64)
    return prompt, out


def _span(mix: dict, base: np.random.Generator, n: int, span: float):
    """One span's multiset: gaps filling `span` exactly, lengths, speeds."""
    if mix["arrival"] == "poisson":
        gaps = poisson_gaps(mix["rate"], n, base)
    elif mix["arrival"] == "gamma":
        gaps = gamma_gaps(mix["rate"], n, base, mix.get("cv", 3.0))
    else:
        raise ValueError(mix["arrival"])
    gaps = gaps * (span / gaps.sum())
    prompt, out = _lengths(mix, n, base)
    if mix.get("qoe_trace", "reading") != "reading":
        raise ValueError(mix["qoe_trace"])
    tds = reading_tds(n, base)
    return gaps, prompt, out, tds


def make_closed_trace(mix: dict, seed: int,
                      vocab: int) -> List[List[TraceRequest]]:
    """Each client's queue of requests (due times unset: NaN)."""
    clients, per = int(mix["clients"]), int(mix["per_client"])
    n = clients * per
    base = np.random.default_rng(int(mix["sizes_seed"]))
    rng = np.random.default_rng(int(seed))
    prompt, olen = _lengths(mix, n, base)
    tds = reading_tds(n, base)
    order = [rng.permutation(n) for _ in range(3)]
    prompt, olen, tds = prompt[order[0]], olen[order[1]], tds[order[2]]
    reqs = [TraceRequest(rid=i, due=float("nan"), prompt_len=int(prompt[i]),
                         output_len=int(olen[i]), ttft=EXPECTED_TTFT,
                         tds=float(tds[i]),
                         prompt=rng.integers(0, vocab, int(prompt[i]))
                         .astype(np.int32), in_window=False)
            for i in range(n)]
    return [reqs[c * per:(c + 1) * per] for c in range(clients)]


def make_trace(mix: dict, seed: int, seconds: float, vocab: int):
    """The requests of one run: a lead-in of ``mix["lead_in_s"]`` seconds
    and then the measured window of `seconds`, both at ``mix["rate"]``;
    for a closed-loop mix, each client's queue."""
    if mix["arrival"] == "closed":
        return make_closed_trace(mix, seed, vocab)
    lead = float(mix["lead_in_s"])
    rate = float(mix["rate"])
    base = np.random.default_rng(int(mix["sizes_seed"]))
    rng = np.random.default_rng(int(seed))
    out: List[TraceRequest] = []
    for start, span, in_window in ((0.0, lead, False),
                                   (lead, float(seconds), True)):
        n = max(int(round(rate * span)), 1)
        gaps, prompt, olen, tds = _span(mix, base, n, span)
        order = [rng.permutation(n) for _ in range(4)]
        gaps, prompt = gaps[order[0]], prompt[order[1]]
        olen, tds = olen[order[2]], tds[order[3]]
        due = start + np.concatenate([[0.0], np.cumsum(gaps)[:-1]])
        for i in range(n):
            toks = rng.integers(0, vocab, int(prompt[i])).astype(np.int32)
            out.append(TraceRequest(
                rid=len(out), due=float(due[i]), prompt_len=int(prompt[i]),
                output_len=int(olen[i]), ttft=EXPECTED_TTFT,
                tds=float(tds[i]), prompt=toks, in_window=in_window))
    return out
