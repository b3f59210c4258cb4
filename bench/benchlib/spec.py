"""A configuration file (``bench/configs/<config>.json``, the published
``config.json`` keys as run, plus the port's block and the engine's
settings) read two ways: as the plain size table that the reference and the
FLOP counts use, and as the port's ``ModelConfig`` and ``EngineConfig``."""

from __future__ import annotations

import dataclasses


def plain_spec(cfg: dict) -> dict:
    """The sizes and semantics the plain reference computes with."""
    d, hq = cfg["hidden_size"], cfg["num_attention_heads"]
    eng = cfg["engine"]
    return {
        "d_model": d,
        "num_heads": hq,
        "num_kv_heads": cfg["num_key_value_heads"],
        "head_dim": cfg.get("head_dim", d // hq),
        "num_layers": cfg["num_hidden_layers"],
        "num_experts": cfg["num_local_experts"],
        "top_k": cfg["num_experts_per_tok"],
        "d_ff_expert": cfg["intermediate_size"],
        "vocab_size": cfg["vocab_size"],
        "norm": cfg["port"]["norm_type"],
        "norm_eps": cfg["rms_norm_eps"],
        "rope_theta": cfg["rope_theta"],
        "tied": bool(cfg["tie_word_embeddings"]),
        "thresholds": tuple(eng["thresholds"]),
        "lo_bits": eng["lo_bits"],
        "group_size": eng["group_size"],
        "dtype": cfg["torch_dtype"],
    }


def port_config(cfg: dict):
    """The port's ``ModelConfig``: its registered block for the architecture,
    with every size and setting taken from the file."""
    from repro_torch.configs import get_config
    from repro_torch.configs.base import MoEConfig

    s = plain_spec(cfg)
    base = get_config(cfg["port"]["arch"])
    moe = MoEConfig(num_experts=s["num_experts"], top_k=s["top_k"],
                    d_ff_expert=s["d_ff_expert"],
                    capacity_factor=float(cfg["port"]["capacity_factor"]))
    return dataclasses.replace(
        base, name=f"{base.name}-bench", num_layers=s["num_layers"], d_model=s["d_model"],
        num_heads=s["num_heads"], num_kv_heads=s["num_kv_heads"], head_dim=s["head_dim"],
        d_ff=s["d_ff_expert"], vocab_size=s["vocab_size"], moe=moe,
        norm_type=s["norm"], norm_eps=s["norm_eps"], rope_theta=s["rope_theta"],
        tie_embeddings=s["tied"], max_seq_len=cfg["max_position_embeddings"],
        dtype=cfg["torch_dtype"]).validate()


def engine_config(cfg: dict):
    """The engine's settings from the file's "engine" block (defaults for
    the rest)."""
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.scoring import Thresholds

    eng = dict(cfg["engine"])
    t1, t2 = eng.pop("thresholds")
    return EngineConfig(thresholds=Thresholds(t1, t2), **eng)
