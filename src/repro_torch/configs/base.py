"""Config system.

A ``ModelConfig`` fully describes one architecture.  Heterogeneous layer stacks
are expressed as a repeating *block pattern* (one period of layer kinds) plus an
optional unrolled prefix (e.g. DeepSeek's dense first layer) and tail (layers
left over when depth % period != 0).  The scanned body keeps HLO size and
compile time O(period) instead of O(depth).

Layer kinds:  "attn" (global), "attn_local" (sliding window), "attn_chunked"
(block-local chunks, llama4 iRoPE style), "ssm" (Mamba2 SSD).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared_experts: int = 0
    d_ff_shared: int = 0                 # per shared expert (deepseek style)
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    router_z_weight: float = 1e-3
    # beyond-paper: resident expert weight precision on the distributed path
    expert_precision: str = "bf16"       # bf16 | int8 | int4


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    kv_lora_rank: int = 512
    q_lora_rank: int = 0                 # 0 = full-rank queries
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256
    n_groups: int = 1


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    """Whisper-style bidirectional encoder consumed via cross-attention."""
    num_layers: int = 4
    d_model: int = 384
    num_heads: int = 6
    d_ff: int = 1536
    seq_len: int = 1500                  # mel frames after conv frontend (stubbed)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                          # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                    # 0 -> d_model // num_heads
    block_pattern: Tuple[str, ...] = ("attn",)
    moe_pattern: Tuple[bool, ...] = (False,)   # which pattern slots use MoE FFN
    prefix_pattern: Tuple[str, ...] = ()       # unrolled leading layers
    prefix_moe: Tuple[bool, ...] = ()
    window_size: int = 4096                    # attn_local / attn_chunked extent
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    ffn_activation: str = "swiglu"             # swiglu | gelu | sq_relu
    norm_type: str = "rmsnorm"                 # rmsnorm | layernorm
    sandwich_norm: bool = False                # gemma2/3 post-norms
    qk_norm: bool = False                      # gemma3
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    scale_embedding: bool = False              # gemma: x *= sqrt(d_model)
    encoder: Optional[EncoderConfig] = None
    frontend: Optional[str] = None             # audio_frames | vision_patches
    num_prefix_tokens: int = 0                 # VLM patch tokens prepended
    tie_embeddings: bool = True
    dtype: str = "bfloat16"
    max_seq_len: int = 131072
    source: str = ""                           # citation for the config

    # ----- derived -----
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def body_layers(self) -> int:
        return self.num_layers - len(self.prefix_pattern)

    @property
    def period(self) -> int:
        return len(self.block_pattern)

    @property
    def num_blocks(self) -> int:
        return self.body_layers // self.period

    @property
    def tail_pattern(self) -> Tuple[str, ...]:
        tail = self.body_layers % self.period
        return self.block_pattern[:tail]

    @property
    def tail_moe(self) -> Tuple[bool, ...]:
        tail = self.body_layers % self.period
        return self.moe_pattern[:tail]

    def layer_kinds(self) -> Tuple[str, ...]:
        """Flat per-layer kind list (prefix + scanned body + tail)."""
        return (self.prefix_pattern
                + self.block_pattern * self.num_blocks
                + self.tail_pattern)

    def layer_is_moe(self) -> Tuple[bool, ...]:
        return (self.prefix_moe
                + self.moe_pattern * self.num_blocks
                + self.tail_moe)

    @property
    def is_sub_quadratic(self) -> bool:
        """True when no layer does *global* attention over the full context,
        or the architecture is explicitly long-context by design (hybrid SSM).

        Used by the launcher to decide long_500k eligibility together with the
        per-arch skip table in DESIGN.md §5."""
        kinds = set(self.layer_kinds())
        if kinds <= {"ssm"}:
            return True
        return "attn" not in kinds

    def validate(self) -> "ModelConfig":
        assert self.num_layers > 0 and self.d_model > 0
        assert len(self.moe_pattern) == len(self.block_pattern), self.name
        assert len(self.prefix_moe) == len(self.prefix_pattern), self.name
        assert self.body_layers >= self.period, self.name
        if any(self.layer_is_moe()):
            assert self.moe is not None, self.name
        if "ssm" in self.layer_kinds():
            assert self.ssm is not None, self.name
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ValueError(f"{self.name}: heads not divisible by kv heads")
        return self

    def param_count(self) -> int:
        """Analytic parameter count (used for MODEL_FLOPS = 6*N*D)."""
        d, hd = self.d_model, self.resolved_head_dim
        n = self.vocab_size * d  # embedding
        if not self.tie_embeddings:
            n += self.vocab_size * d
        for kind, is_moe in zip(self.layer_kinds(), self.layer_is_moe()):
            if kind.startswith("attn"):
                if self.mla is not None:
                    m = self.mla
                    qd = m.nope_head_dim + m.rope_head_dim
                    n += d * self.num_heads * qd                       # wq
                    n += d * (m.kv_lora_rank + m.rope_head_dim)        # w_dkv
                    n += m.kv_lora_rank * self.num_heads * m.nope_head_dim
                    n += m.kv_lora_rank * self.num_heads * m.v_head_dim
                    n += self.num_heads * m.v_head_dim * d             # wo
                else:
                    n += d * self.num_heads * hd
                    n += 2 * d * self.num_kv_heads * hd
                    n += self.num_heads * hd * d
            elif kind == "ssm":
                s = self.ssm
                d_in = s.expand * d
                nheads = d_in // s.head_dim
                conv_dim = d_in + 2 * s.n_groups * s.d_state
                n += d * (2 * d_in + 2 * s.n_groups * s.d_state + nheads)
                n += s.d_conv * conv_dim + 2 * nheads + d_in * d
            # FFN
            if is_moe:
                mc = self.moe
                mult = 3 if self.ffn_activation == "swiglu" else 2
                n += d * mc.num_experts  # router
                n += mc.num_experts * mult * d * mc.d_ff_expert
                if mc.num_shared_experts:
                    n += mult * d * (mc.d_ff_shared or mc.d_ff_expert) * mc.num_shared_experts
            else:
                mult = 3 if self.ffn_activation == "swiglu" else 2
                n += mult * d * self.d_ff
        if self.encoder is not None:
            e = self.encoder
            per = 4 * e.d_model * e.d_model + 2 * e.d_model * e.d_ff
            n += e.num_layers * per
            # decoder cross-attention (one per decoder layer)
            n += self.num_layers * 4 * d * d
        return n

    def active_param_count(self) -> int:
        """Activated params per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        d = self.d_model
        mc = self.moe
        mult = 3 if self.ffn_activation == "swiglu" else 2
        per_expert = mult * d * mc.d_ff_expert
        n_moe_layers = sum(self.layer_is_moe())
        total = self.param_count()
        total -= n_moe_layers * mc.num_experts * per_expert
        total += n_moe_layers * mc.top_k * per_expert
        return total


# Input shapes assigned to this paper (see the brief).
@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def smoke_variant(cfg: ModelConfig, *, layers: int = 2, d_model: int = 256,
                  vocab: int = 512) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests (<=4 experts etc.)."""
    period = cfg.period
    layers = max(layers, period)
    layers = (layers // period) * period + len(cfg.prefix_pattern)
    heads = max(2, min(4, cfg.num_heads))
    kv = max(1, min(heads, cfg.num_kv_heads))
    while heads % kv:
        kv -= 1
    kw = dict(
        num_layers=layers, d_model=d_model, num_heads=heads, num_kv_heads=kv,
        d_ff=d_model * 2, vocab_size=vocab, head_dim=d_model // heads,
        max_seq_len=1024, num_prefix_tokens=min(cfg.num_prefix_tokens, 8),
        window_size=min(cfg.window_size, 64),
    )
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, num_experts=4, top_k=min(cfg.moe.top_k, 2),
            d_ff_expert=d_model, d_ff_shared=d_model if cfg.moe.d_ff_shared else 0)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(kv_lora_rank=64, rope_head_dim=32,
                              nope_head_dim=d_model // heads, v_head_dim=d_model // heads)
    if cfg.ssm is not None:
        kw["ssm"] = dataclasses.replace(cfg.ssm, d_state=32, head_dim=32, chunk_size=32)
    if cfg.encoder is not None:
        kw["encoder"] = EncoderConfig(num_layers=2, d_model=d_model, num_heads=heads,
                                      d_ff=d_model * 2, seq_len=32)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **kw).validate()
