"""Token-level expert importance scoring (HOBBIT §3.2).

The unimportance degree of the i-th selected expert (experts sorted by
descending normalized gate magnitude ||G(x)||) is the cumulative mass of the
experts ranked above it:

    s_{e_0} = 0;   s_{e_i} = sum_{j<i} ||G(x)_{e_j}||        (Eq. 2)

Precision policy: s <= T1 -> high precision; T1 < s <= T2 -> low precision;
s > T2 -> skip.  e_0 always loads high precision.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

PREC_HI, PREC_LO, PREC_SKIP = 0, 1, 2
PREC_NAMES = {PREC_HI: "hi", PREC_LO: "lo", PREC_SKIP: "skip"}


@dataclasses.dataclass(frozen=True)
class Thresholds:
    t1: float = 0.6
    t2: float = 0.9

    def __post_init__(self):
        assert 0.0 <= self.t1 <= self.t2 <= 1.0 + 1e-9, (self.t1, self.t2)


def normalize_gates(gate_vals: np.ndarray) -> np.ndarray:
    """Normalize selected-expert gate magnitudes to sum to 1 (the paper
    normalizes ||G(x)|| before accumulating)."""
    g = np.abs(np.asarray(gate_vals, np.float64))
    s = g.sum(axis=-1, keepdims=True)
    return g / np.maximum(s, 1e-12)


def unimportance_scores(gate_vals: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """gate_vals: (k,) or (B,k) selected-expert gate magnitudes (any order).

    Returns (order, scores): `order` indexes experts by descending gate value;
    `scores[i]` is Eq. 2's s for the expert at rank i."""
    g = normalize_gates(gate_vals)
    order = np.argsort(-g, axis=-1, kind="stable")
    g_sorted = np.take_along_axis(g, order, axis=-1)
    cum = np.cumsum(g_sorted, axis=-1)
    scores = np.concatenate([np.zeros_like(cum[..., :1]), cum[..., :-1]], axis=-1)
    return order, scores


def precision_decisions(gate_vals: np.ndarray, th: Thresholds) -> np.ndarray:
    """Per selected expert (original order), decide PREC_HI / LO / SKIP."""
    order, scores = unimportance_scores(gate_vals)
    dec_sorted = np.where(scores <= th.t1, PREC_HI,
                          np.where(scores <= th.t2, PREC_LO, PREC_SKIP))
    dec_sorted[..., 0] = PREC_HI  # rank-0 expert always high precision
    dec = np.empty_like(dec_sorted)
    np.put_along_axis(dec, order, dec_sorted, axis=-1)
    return dec


def calibrate_thresholds(score_samples: np.ndarray, *, frac_hi: float = 0.67,
                         frac_lo: float = 0.30) -> Thresholds:
    """Pick T1/T2 so that ~frac_hi of selections are high precision and
    ~frac_lo low precision (the paper's 67/30/3 split, Fig. 5b).

    score_samples: flat array of Eq. 2 scores collected on a calibration set."""
    s = np.sort(np.asarray(score_samples, np.float64).ravel())
    if len(s) == 0:
        return Thresholds()
    t1 = float(s[min(int(frac_hi * len(s)), len(s) - 1)])
    t2 = float(s[min(int((frac_hi + frac_lo) * len(s)), len(s) - 1)])
    t1 = min(max(t1, 0.0), 1.0)
    t2 = min(max(t2, t1), 1.0)
    return Thresholds(t1, t2)


def gate_output_correlation(gate_norms: np.ndarray,
                            output_norms: np.ndarray) -> float:
    """Pearson correlation between ||G(x)|| and ||G(x) E(x)|| (Fig. 5a's
    0.99 claim).  Both inputs are flat sample vectors."""
    a = np.asarray(gate_norms, np.float64).ravel()
    b = np.asarray(output_norms, np.float64).ravel()
    a = (a - a.mean()) / (a.std() + 1e-12)
    b = (b - b.mean()) / (b.std() + 1e-12)
    return float(np.mean(a * b))
