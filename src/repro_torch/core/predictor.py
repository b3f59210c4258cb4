"""Layer-level Adaptive Expert Predictor (HOBBIT §3.3).

Uses the *current* layer's gating input (the pre-FFN hidden state) as a proxy
for the gating inputs of the next `p` layers — valid because the residual
stream changes slowly across layers (Fig. 7a) — and evaluates all `p` gate
matmuls at once with the Stacking Computer (the stacked_gating kernel,
`kernels/ops.stacked_gating`, on the card).

The adaptive walk: predict layer l+1; if all predicted experts are cached,
continue to l+2, ... stop at the first layer with a miss (that's the one
worth prefetching for) or after `p` layers.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.cache import MultidimensionalCache
from repro_torch.core.scoring import Thresholds, precision_decisions, PREC_HI, PREC_SKIP
from repro_torch.device import to_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import softmax_last
from repro_torch.spans import span


@dataclasses.dataclass
class Prediction:
    layer: int                 # the layer these experts belong to
    experts: List[int]         # predicted top-k
    gate_vals: np.ndarray      # predicted gate magnitudes (for precision choice)


class AdaptiveExpertPredictor:
    """Holds stacked router weights (L, D, E); predicts future layers' experts."""

    def __init__(self, routers: Sequence, top_k: int,
                 p: int = 2, *, device=None, fleet=None,
                 fleet_weight: float = 0.0):
        """fleet: optional ``core.fleet_heat.FleetHeat``.  With
        fleet_weight > 0, each predicted layer's gate distribution is
        blended with the fleet's per-layer expert prior
        (``(1-w)*probs + w*layer_prior``) before the top-k cut, so a fresh
        request's first prefetches lean on cross-request popularity.  The
        default weight 0.0 leaves the prediction numerics untouched.

        routers: per-layer (D, E) router weights (tensors or arrays); they
        are stacked once, float32, on `device` (default: the routers' own)."""
        rs = [torch.as_tensor(r) for r in routers]
        dev = torch.device(device) if device is not None else rs[0].device
        self.gates = torch.stack([r.to(device=dev, dtype=torch.float32)
                                  for r in rs]).contiguous()
        self.num_layers, self.d_model, self.num_experts = self.gates.shape
        self.top_k = top_k
        self.p = p
        self.fleet = fleet
        self.fleet_weight = float(fleet_weight)
        # accuracy bookkeeping: self.eval[d] = (correct_top1, total) for dist d
        self._acc: dict[int, List[int]] = {}

    # ---------------- raw prediction ----------------
    def predict_layers(self, hidden: np.ndarray, layer: int,
                       p: Optional[int] = None) -> List[Prediction]:
        """hidden: (D,) gating input at `layer`.  Predict layers l+1..l+p via
        one stacked gating call."""
        p = p if p is not None else self.p
        lo, hi = layer + 1, min(layer + p, self.num_layers - 1)
        if lo > hi:
            return []
        with span("predictor.gating", layer, hi + 1 - lo):
            x = to_device(np.asarray(hidden, np.float32),
                          self.gates.device)[None, :]              # (1, D)
            stack = self.gates[lo : hi + 1]                        # (P, D, E)
            logits = kops.stacked_gating(x, stack)                 # (P, 1, E)
            probs = softmax_last(logits)[:, 0].cpu().numpy()
        preds = []
        w = self.fleet_weight if self.fleet is not None else 0.0
        for i, l in enumerate(range(lo, hi + 1)):
            pl = probs[i]
            if w > 0.0:
                pl = (1.0 - w) * pl + w * self.fleet.layer_prior(
                    l, self.num_experts)
            idx = np.argsort(-pl)[: self.top_k]
            preds.append(Prediction(l, idx.tolist(), pl[idx]))
        return preds

    # ---------------- adaptive walk ----------------
    def adaptive_walk(self, hidden: np.ndarray, layer: int,
                      cache: MultidimensionalCache,
                      th: Thresholds) -> List[Tuple[Prediction, np.ndarray]]:
        """Walk forward; return [(prediction, precision_decisions)] for the
        first future layer whose predicted experts are not fully cached
        (the paper preloads exactly those), or [] if everything is resident."""
        preds = self.predict_layers(hidden, layer)
        for pr in preds:
            dec = precision_decisions(pr.gate_vals, th)
            missing = []
            for e, d in zip(pr.experts, dec):
                if d == PREC_SKIP:
                    continue
                if cache.lookup((pr.layer, e), d == PREC_HI) is None:
                    missing.append(True)
                else:
                    missing.append(False)
            # pin resident predicted experts either way (§3.3 "mask")
            for e, d in zip(pr.experts, dec):
                if d != PREC_SKIP:
                    cache.pin((pr.layer, e), d == PREC_HI)
            if any(missing):
                return [(pr, dec)]
        return []

    # ---------------- accuracy bookkeeping ----------------
    def record_accuracy(self, predicted: Prediction, actual_top: Sequence[int],
                        distance: int):
        c, t = self._acc.get(distance, [0, 0])
        c += int(predicted.experts[0] in list(actual_top[: 1]))
        t += 1
        self._acc[distance] = [c, t]

    def accuracy(self) -> dict[int, float]:
        return {d: c / t for d, (c, t) in sorted(self._acc.items()) if t}


def gating_input_similarity(hiddens: np.ndarray, max_dist: int = 3) -> dict[int, float]:
    """Mean cosine similarity of gating inputs between layer l and l+d
    (Fig. 7a reproduction).  hiddens: (L, D) per-layer gating inputs for one
    token (or (L, T, D) averaged over tokens)."""
    h = np.asarray(hiddens, np.float64)
    if h.ndim == 2:
        h = h[:, None, :]
    l = h.shape[0]
    out = {}
    for d in range(1, max_dist + 1):
        sims = []
        for i in range(l - d):
            a, b = h[i], h[i + d]
            num = (a * b).sum(-1)
            den = np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1) + 1e-12
            sims.append(num / den)
        out[d] = float(np.mean(sims))
    return out
