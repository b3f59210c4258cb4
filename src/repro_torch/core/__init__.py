from repro_torch.core.cache import CacheStarvation, CacheStats, MultidimensionalCache
from repro_torch.core.engine import EngineConfig, OffloadEngine
from repro_torch.core.loader import (DynamicExpertLoader, LoadTask, StagingEngine,
                                     measure_link_bps)
from repro_torch.core.policies import (FLD, LFU, LHU, LRU, MULTIDIM, NAMED_POLICIES,
                                       PolicyWeights)
from repro_torch.core.predictor import AdaptiveExpertPredictor, gating_input_similarity
from repro_torch.core.scoring import (PREC_HI, PREC_LO, PREC_SKIP, Thresholds,
                                      calibrate_thresholds, gate_output_correlation,
                                      precision_decisions, unimportance_scores)
from repro_torch.core.simulator import (H100_HOST, HARDWARE, JETSON_ORIN, RTX4090,
                                        HobbitSimConfig, OffloadSimulator, TraceLayer,
                                        cache_policy_penalty, simulate_systems)

# the reference's names, less AsyncExpertScheduler (removed by design: use
# StagingEngine(streams=1, ordered=True)) and TPU_V5E_HOST (the port's host
# model is H100_HOST, measured on the card it runs on)
__all__ = [
    "CacheStarvation", "CacheStats", "MultidimensionalCache", "EngineConfig",
    "OffloadEngine", "StagingEngine", "DynamicExpertLoader", "LoadTask",
    "measure_link_bps", "FLD", "LFU", "LHU", "LRU", "MULTIDIM",
    "NAMED_POLICIES", "PolicyWeights", "AdaptiveExpertPredictor",
    "gating_input_similarity", "PREC_HI", "PREC_LO", "PREC_SKIP", "Thresholds",
    "calibrate_thresholds", "gate_output_correlation", "precision_decisions",
    "unimportance_scores", "HARDWARE", "HobbitSimConfig", "JETSON_ORIN",
    "OffloadSimulator", "RTX4090", "H100_HOST", "TraceLayer",
    "cache_policy_penalty", "simulate_systems",
]
