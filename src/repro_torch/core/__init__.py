from repro_torch.core.cache import CacheStarvation, CacheStats, MultidimensionalCache
from repro_torch.core.engine import EngineConfig, OffloadEngine
from repro_torch.core.loader import (DynamicExpertLoader, LoadTask, StagingEngine,
                                     measure_link_bps)
from repro_torch.core.policies import (FLD, LFU, LHU, LRU, MULTIDIM, NAMED_POLICIES,
                                       PolicyWeights)
from repro_torch.core.predictor import AdaptiveExpertPredictor
from repro_torch.core.scoring import (PREC_HI, PREC_LO, PREC_SKIP, Thresholds,
                                      precision_decisions)
from repro_torch.core.simulator import (HARDWARE, HobbitSimConfig, TraceLayer,
                                        simulate_systems)

__all__ = [
    "CacheStarvation", "CacheStats", "MultidimensionalCache", "EngineConfig",
    "OffloadEngine", "DynamicExpertLoader", "LoadTask",
    "StagingEngine", "measure_link_bps", "FLD", "LFU", "LHU", "LRU", "MULTIDIM",
    "NAMED_POLICIES", "PolicyWeights", "AdaptiveExpertPredictor", "PREC_HI",
    "PREC_LO", "PREC_SKIP", "Thresholds", "precision_decisions", "HARDWARE",
    "HobbitSimConfig", "TraceLayer", "simulate_systems",
]
