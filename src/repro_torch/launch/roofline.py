"""Roofline terms of a dry-run record on the H100 (the JAX package's
``launch/roofline.py`` with the H100 SXM5 datasheet constants of
``launch.mesh``):

compute term    = FLOPs_per_GPU / peak bf16 FLOP/s
memory term     = bytes_per_GPU / HBM bandwidth
collective term = model-axis collective bytes / NVLink bandwidth
                  + data- and pod-axis collective bytes / InfiniBand bandwidth

All quantities are per GPU (``launch.op_analysis`` counts each GPU's own
shards).  The collective term is the H100's counterpart of the reference's
one ICI term: the model axis lives inside an NVLink node, the data and pod
axes cross nodes.  Collective bytes are the result bytes of each
collective, to within the usual 2(n-1)/n ring factor, as in the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

from repro_torch.launch.mesh import HBM_BW, IB_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.op_analysis import COLLECTIVES


def collective_bytes(analysis: Dict) -> Dict[str, float]:
    """Per-kind collective bytes of an ``OpAnalysis.result()``, with the
    count and the total, keyed as the reference keys its HLO parse."""
    coll = analysis["collectives"]
    out = {k: float(coll.get(k, 0.0)) for k in COLLECTIVES}
    out["count"] = int(coll.get("count", 0))
    out["total"] = sum(out[k] for k in COLLECTIVES)
    return out


@dataclasses.dataclass
class Roofline:
    arch: str
    shape: str
    mesh: str
    flops_per_chip: float
    bytes_per_chip: float
    coll_bytes_per_chip: float
    nvlink_bytes_per_chip: float = 0.0     # model-axis share of coll_bytes
    peak_flops: float = PEAK_FLOPS_BF16
    hbm_bw: float = HBM_BW
    nvlink_bw: float = NVLINK_BW
    ib_bw: float = IB_BW

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.peak_flops

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / self.hbm_bw

    @property
    def collective_s(self) -> float:
        ib = max(self.coll_bytes_per_chip - self.nvlink_bytes_per_chip, 0.0)
        return self.nvlink_bytes_per_chip / self.nvlink_bw + ib / self.ib_bw

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def step_s(self) -> float:
        """Roofline step-time estimate = max of the three terms."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    def asdict(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "coll_bytes_per_chip": self.coll_bytes_per_chip,
            "nvlink_bytes_per_chip": self.nvlink_bytes_per_chip,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s, "bottleneck": self.bottleneck,
            "step_s": self.step_s,
        }


def model_flops(cfg, shape, n_tokens: int) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE); decode: D=1 token/seq."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * n_tokens
    # inference fwd only ~ 2*N per token (+ attn, ignored in the ratio metric)
    return 2.0 * n * n_tokens
