"""The end-to-end metrics of a run, from the harness's own stamps.

`record["window"]` is [start, end) on the engine's clock; each entry of
`record["requests"]` has its due time, expected TTFT and TDS, output
length, and `emits`: [time, tokens] pairs stamped by the harness when the
engine handed the tokens over. Every metric is over the requests due
inside the window; a token stamped at or after the window's end was not
delivered in it.
"""
from __future__ import annotations

from typing import List

import numpy as np

from qoebench.frozen.qoe import request_qoe


def percentile(values, q: float) -> float:
    """The q-th percentile, linearly interpolated (numpy's default)."""
    return float(np.percentile(np.asarray(values, dtype=np.float64), q))


def due_in_window(record: dict) -> List[dict]:
    w0, w1 = record["window"]
    return [r for r in record["requests"] if w0 <= r["due"] < w1]


def token_times(req: dict, before: float) -> List[float]:
    return [t for t, k in req["emits"] if t < before for _ in range(int(k))]


def qoe_mean(record: dict) -> float:
    """Mean Eq. 1 over the requests due in the window, each cut at the
    window's end if it was still streaming."""
    w1 = record["window"][1]
    scores = [request_qoe(token_times(r, w1), r["due"], r["ttft"], r["tds"],
                          r["output_len"], w1)
              for r in due_in_window(record)]
    return float(np.mean(scores))


def ttfts(record: dict) -> List[float]:
    """First stamp less due time; a request with no token by the end
    counts as end less due."""
    w1 = record["window"][1]
    out = []
    for r in due_in_window(record):
        first = [t for t, _k in r["emits"] if t < w1]
        out.append((min(first) if first else w1) - r["due"])
    return out


def ttft_p95_s(record: dict) -> float:
    return percentile(ttfts(record), 95)


def tokens_per_s(record: dict) -> float:
    """Every token stamped inside the window, over its seconds."""
    w0, w1 = record["window"]
    n = sum(int(k) for r in record["requests"] for t, k in r["emits"]
            if w0 <= t < w1)
    return n / (w1 - w0)


END_TO_END = {"qoe_mean": qoe_mean, "ttft_p95_s": ttft_p95_s,
              "tokens_per_s": tokens_per_s}
