"""QoE requirement traces (paper Tables 1–2, §6.1).

Expected TTFT is 1 s for all requests. Expected TDS is drawn from the
user-demographic mix: reading speeds by age group (text chat) or speaking
speeds by language (voice chat), converted words→tokens with the average
word-to-token ratio (~0.75 words/token ⇒ tokens/s = WPM / 60 / 0.75).
The paper's summary numbers: average reading 4.8 tok/s, speaking 3.3 tok/s.
"""
from __future__ import annotations

from typing import List

import numpy as np

from repro_torch.core.qoe import QoESpec

WORD_PER_TOKEN = 0.75
EXPECTED_TTFT = 1.0

# (share, words-per-minute)
READING_WPM = [
    (0.280, 236),   # 18-24
    (0.519, 200),   # 25-44
    (0.112, 192),   # 45-54
    (0.056, 185),   # 55-64
    (0.033, 175),   # 65+
]
SPEAKING_WPM = [
    (0.793, 150),   # English
    (0.070, 158),   # Chinese
    (0.069, 150),   # Korean
    (0.036, 195),   # French
    (0.032, 218),   # Spanish
]


def _wpm_to_tds(wpm: float) -> float:
    return wpm / 60.0 / WORD_PER_TOKEN


def _trace(mix, n: int, rng: np.random.Generator, ttft: float) -> List[QoESpec]:
    shares = np.array([s for s, _ in mix])
    shares = shares / shares.sum()
    wpms = np.array([w for _, w in mix])
    idx = rng.choice(len(mix), size=n, p=shares)
    return [QoESpec(ttft=ttft, tds=_wpm_to_tds(wpms[i])) for i in idx]


def reading_qoe_trace(n: int, rng: np.random.Generator,
                      ttft: float = EXPECTED_TTFT) -> List[QoESpec]:
    """Text-chat trace (Table 1): mean ≈ 4.5–4.8 tokens/s."""
    return _trace(READING_WPM, n, rng, ttft)


def voice_qoe_trace(n: int, rng: np.random.Generator,
                    ttft: float = EXPECTED_TTFT) -> List[QoESpec]:
    """Voice-chat trace (Table 2): mean ≈ 3.3–3.5 tokens/s."""
    return _trace(SPEAKING_WPM, n, rng, ttft)
