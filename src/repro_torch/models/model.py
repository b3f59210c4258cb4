"""Model assembly of the port: config -> init / prefill / decode_step / logits.

Covers decoder-only models whose layers are attention layers -- full-window
"attn", sliding-window "attn_local" or chunked "attn_chunked", or
DeepSeek-V2's multi-head latent attention (MLA) -- or Mamba-2 SSD "ssm"
layers (``models.ssm``), each with a MoE or a dense FFN or, where the
config has d_ff 0 and the layer is not MoE, none: a MoE FFN in every layer
(Mixtral / Phi-MoE, the HOBBIT engine's model class; Llama-4-Scout's top-1
experts beside a shared expert), a dense first layer before MoE layers with
two shared experts (DeepSeek-V2), Mamba2-780m's SSD layers without FFN,
Jamba's periods of 7 SSD layers and one attention layer without positional
encoding, dense and MoE FFN alternating, or a
dense FFN in every layer: Granite (RMSNorm, SwiGLU, tied embeddings),
Nemotron-4 (layernorm, squared ReLU, an untied LM head), InternVL2's
InternLM2 backbone, whose "vision_patches" frontend puts precomputed patch
embeddings (``Batch.prefix_embeds``) in front of the text, and Gemma-2 /
Gemma-3 (sandwich norms, embeddings scaled by sqrt(d_model), attention and
final logit softcaps, qk-norm); and the encoder-decoder Whisper: a
bidirectional encoder over precomputed audio frames (``Batch.audio_frames``,
the "audio_frames" frontend; the conv/mel feature extractor is stubbed, as
in the reference), then decoder layers with cross-attention into the
encoder states after the self-attention, sinusoidal absolute positions in
place of RoPE (``rope_theta <= 0``).  Other configurations raise
NotImplementedError.

Parameters are a plain dict of tensors with a flat per-layer list::

    {"embed": (V_pad, D), "final_norm": {"scale": (D,)[, "bias"]},
     ["lm_head": (D, V_pad) when the embeddings are untied,]
     "layers": [{"pre_norm", "attn": {wq, wk, wv, wo[, q_norm, k_norm]}
                                  or {wq, w_dkv, w_uk, w_uv, wo, kv_norm} (MLA),
                              or "mixer": {in_proj, conv_w, conv_b, A_log, D,
                                           dt_bias, norm, out_proj}  (SSM),
                 ["cross_norm", "cross": {wq, wk, wv, wo}]       (Whisper)
                 ["post_norm",] ["ffn_norm", ["post_ffn_norm",]
                 "ffn": {"router": (D, E), "experts": {"wi", "wo"}
                         [, "shared": {"wi", "wo"}]}                 (MoE)
                     or {"wi", "wo"}]}, ...]
     ["encoder": {"layers": [{"norm1", "attn": {wq, wk, wv, wo}, "norm2",
                              "ffn": {wi, wo}}, ...], "final_norm"}]}  (Whisper)

(the JAX package stacks repeating blocks for ``lax.scan``; PyTorch runs
eagerly, so the port keeps the flat view ``unstack_layers`` gives there).  A
norm holds a float32 "scale" and, for layernorm, a float32 "bias".  A
dense FFN weight may be a `QTensor` (``quant.quantize_tree``); its products
then run the dequant-matmul kernel.  The decode cache is a list of per-layer
{"k", "v"} (B, Smax, Hkv, hd) buffers updated in place -- Smax = max_len for
"attn" layers, min(max_len, window) for windowed ones, whose cache is a
ring (``layers.attn_decode``); an MLA layer's is the latent cache
{"c_kv": (B, max_len, R), "k_rope": (B, max_len, rope)}, an SSM layer's
its float32 state {"h": (B, H, P, N), "conv": (B, K - 1, conv_dim)}, the
same size at any length; a Whisper decoder layer's also holds the encoder's
keys and values {"cross_k", "cross_v"} (B, F, Hkv, hd), projected once at
prefill -- or, for
all-"attn" models without MLA, a `kv_pages.PagedKVPool`
(``init_cache(..., paged=True)``) driven by ``decode_step_paged`` /
``prefill_chunk_paged``.  Prefix embeddings and audio frames enter
through ``forward`` and ``prefill`` (a `Batch`); the paged chunked prefill
is text-only, as in the reference.  ``loss`` is the reference's training
objective (next-token cross-entropy in float32 chunks plus the MoE aux
losses), differentiated by autograd (``training``).
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, NamedTuple, Optional, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.device import DeviceLike, resolve_device
from repro_torch.models import kv_pages as kvp
from repro_torch.models import layers, moe as moe_lib, shard_utils, ssm as ssm_lib


class Batch(NamedTuple):
    """One batch of the data pipeline (``data.pipeline``)."""
    tokens: torch.Tensor                          # (B, S) int32
    loss_mask: torch.Tensor                       # (B, S) f32 (1 = predict this target)
    prefix_embeds: Optional[torch.Tensor] = None  # (B, P, D) vlm patch embeds
    audio_frames: Optional[torch.Tensor] = None   # (B, F, D_enc) whisper frames


def check_supported(cfg: ModelConfig) -> None:
    """Raise NotImplementedError unless `cfg` is in the ported model class:
    attention decoder layers (full-window, sliding-window, chunked or MLA)
    and Mamba-2 SSD layers, each FFN dense, MoE or absent, RMSNorm or
    layernorm, an optional Whisper encoder read through cross-attention,
    and no frontend but "vision_patches" (InternVL2's precomputed patch
    embeddings) or "audio_frames" (Whisper's precomputed encoder frames)."""
    if cfg.frontend not in (None, "vision_patches", "audio_frames"):
        raise NotImplementedError(f"{cfg.name}: the {cfg.frontend!r} frontend is not "
                                  "one of the JAX package's")
    if cfg.norm_type not in ("rmsnorm", "layernorm"):
        raise NotImplementedError(
            f"{cfg.name}: norm_type={cfg.norm_type!r} is neither RMSNorm nor "
            "layernorm (ROADMAP Queue 1, item 7)")


def supports_paged_kv(cfg: ModelConfig) -> bool:
    """True iff the paged KV layout serves this architecture: every layer a
    full-window "attn" layer (no ring caches), no MLA, no encoder."""
    return (cfg.mla is None and cfg.encoder is None
            and all(k == "attn" for k in cfg.layer_kinds()))


def _use_rope(cfg: ModelConfig) -> bool:
    """RoPE in every attention layer, except a hybrid's (Jamba's attention
    layers have no positional encoding)."""
    return cfg.family != "hybrid" and cfg.rope_theta > 0


def _ffn(p, h, cfg: ModelConfig, token_mask=None):
    """The layer's FFN on normed h: (y, aux loss).  MoE layers (a router in
    `p`) take the live-token mask (dead slots and pads take no dispatch
    capacity); dense layers have no aux loss."""
    if "router" in p:
        return moe_lib.moe_forward(p, h, cfg, token_mask=token_mask)
    return layers.ffn_forward(p, h, cfg), None


def _layer(p, x, mix, cfg: ModelConfig, token_mask=None, enc_kv=None):
    """One decoder layer around its mixer call `mix(normed x)` (attention
    or the SSM): pre norm, the mixer, the post norm under sandwich norms,
    the residual; then, given the encoder's keys and values `enc_kv`
    (Whisper), cross-attention into them behind its own norm and residual;
    then the same around the FFN, which a layer without one skips.
    Returns (x, aux loss or None)."""
    out = mix(layers.apply_norm(p["pre_norm"], x, cfg))
    if cfg.sandwich_norm:
        out = layers.apply_norm(p["post_norm"], out, cfg)
    x = _residual(x + out)
    if enc_kv is not None:
        x = _residual(x + layers.cross_attn_forward(
            p["cross"], layers.apply_norm(p["cross_norm"], x, cfg), enc_kv, cfg))
    if "ffn" not in p:
        return x, None
    y, aux = _ffn(p["ffn"], layers.apply_norm(p["ffn_norm"], x, cfg), cfg,
                  token_mask=token_mask)
    if cfg.sandwich_norm:
        y = layers.apply_norm(p["post_ffn_norm"], y, cfg)
    return _residual(x + y), aux


def _residual(x):
    """The residual stream under a mesh: rows over the data axes, whole over
    the model axis (the row-parallel products' partial sums reduced here,
    as Megatron reduces them); the identity without one."""
    return shard_utils.constrain(x, "batch", None, None)


def _layer_decode_paged(p, x, kp, vp, table, positions, active, cfg: ModelConfig):
    """One-token layer step against paged KV; `active` doubles as the MoE
    token mask so released slots take no dispatch capacity."""
    return _layer(p, x, lambda h: layers.paged_attn_decode(
        p["attn"], h, kp, vp, table, positions, active, cfg), cfg, token_mask=active)[0]


def _layer_chunk_paged(p, x, kp, vp, table, start, n, wstart, valid_flat,
                       cfg: ModelConfig):
    """One prefill-chunk layer step against paged KV; valid_flat (B*C,)
    keeps pad tokens out of the MoE capacity."""
    return _layer(p, x, lambda h: layers.paged_attn_prefill_chunk(
        p["attn"], h, kp, vp, table, start, n, cfg, wstart=wstart), cfg,
        token_mask=valid_flat)[0]


def _ln(p, x: torch.Tensor, eps: float) -> torch.Tensor:
    """The encoder's layernorm: float32 statistics, a (1 + scale) gain and a
    bias, the result in x's dtype."""
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    return (((xf - mu) * torch.rsqrt(var + eps)) * (1.0 + p["scale"]) + p["bias"]).to(x.dtype)


def _encoder_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device):
    """Whisper's encoder: per layer two layernorms (float32 zeros), the
    square attention projections and the GELU FFN in the config dtype; a
    final layernorm."""
    e, dt = cfg.encoder, layers.dtype_of(cfg)

    def ln():
        return {"scale": torch.zeros((e.d_model,), dtype=torch.float32, device=device),
                "bias": torch.zeros((e.d_model,), dtype=torch.float32, device=device)}

    def w(shape):
        return layers.dense_init(shape, dt, gen, device)

    sq = (e.d_model, e.d_model)
    return {"layers": [{"norm1": ln(),
                        "attn": {"wq": w(sq), "wk": w(sq), "wv": w(sq), "wo": w(sq)},
                        "norm2": ln(),
                        "ffn": {"wi": w((e.d_model, e.d_ff)), "wo": w((e.d_ff, e.d_model))}}
                       for _ in range(e.num_layers)],
            "final_norm": ln()}


def _encoder_forward(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """x: (B, F, d_enc) frames with their positions added, in the compute
    dtype -> encoder states (B, F, d_enc): pre-norm layers of bidirectional
    attention (every frame attends to every frame) and a GELU FFN (tanh
    form, in float32), then the final layernorm."""
    e = cfg.encoder
    hd = e.d_model // e.num_heads
    b, f, _ = x.shape
    mask = torch.ones((b, f, f), dtype=torch.bool, device=x.device)
    for lp in p["layers"]:
        lp = shard_utils.gather_data_axes(lp)
        a = lp["attn"]
        h = _ln(lp["norm1"], x, cfg.norm_eps)
        q, k, v = (layers.heads(h @ a[n], b, f, e.num_heads, hd) for n in ("wq", "wk", "wv"))
        o = layers.mha(q, k, v, mask, 0.0, 1.0 / math.sqrt(hd))
        x = x + layers.merge_heads(o) @ a["wo"]
        h = _ln(lp["norm2"], x, cfg.norm_eps)
        h = F.gelu((h @ lp["ffn"]["wi"]).to(torch.float32), approximate="tanh").to(x.dtype)
        x = x + h @ lp["ffn"]["wo"]
    return _ln(p["final_norm"], x, cfg.norm_eps)


def _cross_kv(p, enc: torch.Tensor, cfg: ModelConfig):
    """A decoder layer's keys and values over the encoder states enc
    (B, F, d_enc): (k, v), each (B, F, Hkv, hd)."""
    b, f, _ = enc.shape
    hkv, hd = cfg.num_kv_heads, cfg.resolved_head_dim
    return (layers.heads(enc @ p["cross"]["wk"], b, f, hkv, hd),
            layers.heads(enc @ p["cross"]["wv"], b, f, hkv, hd))


def _xent_chunks(h, y, m, chunk: int):
    """The loss's token chunks (h (T, D), targets y (T,), mask m (T,)):
    consecutive runs of `chunk` tokens.  Under a mesh the tokens are split
    over the data shards, so a run would gather them; there each chunk
    takes chunk / dp tokens from every shard's own rows instead (the same
    tokens per chunk, summed in another order)."""
    t, d = h.shape
    n = shard_utils.dp_size() if shard_utils.is_sharded(h) else 1
    if n == 1 or t % n:
        for c0 in range(0, t, chunk):
            yield h[c0:c0 + chunk], y[c0:c0 + chunk], m[c0:c0 + chunk]
        return
    rows = t // n
    c = max(1, min(chunk // n, rows))
    while rows % c:
        c -= 1
    lr = shard_utils.local_reshape     # each shard's own rows
    h3, y2, m2 = lr(h, n, rows, d), lr(y, n, rows), lr(m, n, rows)
    for c0 in range(0, rows, c):
        yield (lr(h3[:, c0:c0 + c], n * c, d), lr(y2[:, c0:c0 + c], n * c),
               lr(m2[:, c0:c0 + c], n * c))


def _generator(seed: Union[int, torch.Generator], device: torch.device):
    if isinstance(seed, torch.Generator):
        return seed
    return torch.Generator(device=device).manual_seed(int(seed))


class Model:
    def __init__(self, cfg: ModelConfig):
        self.cfg = cfg.validate()
        check_supported(self.cfg)
        self.has_cross = cfg.encoder is not None
        # padded vocab as in the reference (pad columns are masked)
        self.v_pad = -(-cfg.vocab_size // 256) * 256
        self._pos_tables: Dict[tuple, torch.Tensor] = {}

    # -------------------- init --------------------
    def init(self, seed: Union[int, torch.Generator] = 0,
             device: DeviceLike = "cuda") -> Dict[str, Any]:
        """Seeded random parameters on `device` (the reference's init
        scales; the numbers differ from jax.random's)."""
        cfg = self.cfg
        dev = resolve_device(device)
        gen = _generator(seed, dev)
        dt = layers.dtype_of(cfg)
        params: Dict[str, Any] = {
            "embed": layers.dense_init((self.v_pad, cfg.d_model), dt, gen, dev,
                                       scale=0.02),
            "final_norm": layers.norm_init(cfg, dev),
            "layers": [],
        }
        if not cfg.tie_embeddings:
            params["lm_head"] = layers.dense_init((cfg.d_model, self.v_pad), dt,
                                                  gen, dev)
        for kind, is_moe in zip(cfg.layer_kinds(), cfg.layer_is_moe()):
            lp: Dict[str, Any] = {"pre_norm": layers.norm_init(cfg, dev)}
            if kind == "ssm":
                lp["mixer"] = ssm_lib.ssm_init(cfg, gen, dev)
            else:
                lp["attn"] = (layers.mla_init(cfg, gen, dev) if cfg.mla is not None
                              else layers.attn_init(cfg, gen, dev))
            if self.has_cross:
                lp["cross_norm"] = layers.norm_init(cfg, dev)
                lp["cross"] = layers.attn_init(cfg, gen, dev, cross=True)
            if cfg.d_ff > 0 or is_moe:      # Mamba-2's layers have no FFN
                lp["ffn_norm"] = layers.norm_init(cfg, dev)
                lp["ffn"] = (moe_lib.moe_init(cfg, gen, dev) if is_moe
                             else layers.ffn_init(cfg, gen, dev))
            if cfg.sandwich_norm:
                lp["post_norm"] = layers.norm_init(cfg, dev)
                if "ffn" in lp:
                    lp["post_ffn_norm"] = layers.norm_init(cfg, dev)
            params["layers"].append(lp)
        if self.has_cross:
            params["encoder"] = _encoder_init(cfg, gen, dev)
        return params

    # -------------------- embedding / logits --------------------
    def logits(self, params, x: torch.Tensor) -> torch.Tensor:
        """(..., D) hidden -> (..., vocab) float32 logits, softcapped when
        the config has a final logit softcap."""
        cfg = self.cfg
        h = layers.apply_norm(params["final_norm"], x, cfg)
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        lg = layers._softcap(h.to(torch.float32) @ w.to(torch.float32),
                             cfg.final_logit_softcap)
        return lg[..., : cfg.vocab_size]

    def embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        """Token embeddings, times sqrt(d_model) under scale_embedding: the
        factor rounded to the compute dtype first, as the reference has it
        (torch.full on the device: no host copy inside a captured step)."""
        if shard_utils.is_sharded(params["embed"]):
            x = shard_utils.vocab_parallel_embed(params["embed"], tokens.to(torch.long))
        else:
            x = params["embed"][tokens.to(torch.long)]
        if not self.cfg.scale_embedding:
            return x
        return x * torch.full((), float(np.sqrt(self.cfg.d_model)), dtype=x.dtype,
                              device=x.device)

    def pos_table(self, n: int, d: int, device) -> torch.Tensor:
        """The first n rows (at least the config's max_seq_len, so that
        one table serves every call) of the float32 sinusoidal table of
        width d on `device`, built once per (length, width, device): the
        decode step only indexes it, with nothing copied to the device
        inside a captured step."""
        n = max(n, self.cfg.max_seq_len)
        key = (n, d, str(device))
        if key not in self._pos_tables:
            self._pos_tables[key] = torch.from_numpy(
                layers.sinusoidal_positions(n, d)).to(device)
        return self._pos_tables[key]

    def encode(self, params, frames: torch.Tensor) -> torch.Tensor:
        """Whisper's encoder: frames (B, F, d_enc) (the stubbed conv
        frontend's output, any float dtype, moved to the parameters'
        device) cast to the compute dtype, sinusoidal positions added, then
        the encoder layers.  Returns the states (B, F, d_enc)."""
        e = self.cfg.encoder
        dev = params["embed"].device
        # float32 first, as the reference holds host frames, then the compute dtype
        x = frames.to(device=dev, dtype=torch.float32).to(layers.dtype_of(self.cfg))
        x = x + self.pos_table(x.shape[1], e.d_model, dev)[: x.shape[1]].to(x.dtype)[None]
        return _encoder_forward(params["encoder"], x, self.cfg)

    # -------------------- prefill --------------------
    def forward(self, params, batch: Union[Batch, torch.Tensor], *, remat: bool = False):
        """Full-sequence forward of a `Batch` (or its tokens (B, S) alone).
        A "vision_patches" model puts the batch's P prefix embeddings (cast
        to the compute dtype) in front of the token embeddings, positions
        running over both; other models ignore them, as the reference does.
        A model with an encoder (Whisper) needs the batch's audio frames:
        each layer projects the encoder states to its cross keys and
        values.  Sinusoidal positions are added when the config has no
        RoPE (rope_theta <= 0).  `remat`: each layer runs under
        ``torch.utils.checkpoint`` (its activations recomputed in the
        backward pass) and no cache entries are kept.
        Returns (hidden (B, P + S, D) with the prefix positions first,
        [(k, v) per layer (Whisper: (k, v, cross k, cross v)), MLA:
        (c_kv, k_rope), SSM: the state {"h", "conv"} that decode continues
        from], or None under remat, aux_loss)."""
        cfg = self.cfg
        tokens = batch.tokens if isinstance(batch, Batch) else batch
        x = self.embed(params, tokens)
        prefix = batch.prefix_embeds if isinstance(batch, Batch) else None
        if cfg.frontend == "vision_patches" and prefix is not None:
            x = torch.cat([prefix.to(device=x.device, dtype=x.dtype), x], dim=1)
        b, s, _ = x.shape
        if cfg.rope_theta <= 0:     # absolute positions (Whisper)
            x = x + self.pos_table(s, cfg.d_model, x.device)[:s].to(x.dtype)[None]
        x = shard_utils.constrain(x, "batch", None, None)
        enc = None
        if self.has_cross:
            frames = batch.audio_frames if isinstance(batch, Batch) else None
            if frames is None:
                raise ValueError(f"{cfg.name} has an encoder: its batch needs audio_frames "
                                 f"(B, F, {cfg.encoder.d_model})")
            enc = self.encode(params, frames)
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        rope = _use_rope(cfg)

        def run(x, p, kind):
            # under a mesh: the layer's weights gathered over the data axes
            # (FSDP), inside the checkpoint so the backward gathers again
            p = shard_utils.gather_data_axes(p)
            kv = []

            def mix(h):
                if kind == "ssm":
                    out, c = ssm_lib.ssm_forward(p["mixer"], h, cfg)
                elif cfg.mla is not None:
                    out, c = layers.mla_forward(p["attn"], h, positions, cfg)
                else:
                    out, c = layers.attn_forward(p["attn"], h, positions, cfg, kind, rope)
                kv.append(c)
                return out

            cross = None if enc is None else _cross_kv(p, enc, cfg)
            x, a = _layer(p, x, mix, cfg, enc_kv=cross)
            return x, a, (kv[0] if cross is None else (*kv[0], *cross))

        kvs = None if remat else []
        for p, kind in zip(params["layers"], cfg.layer_kinds()):
            if remat:
                x, a, _ = checkpoint(run, x, p, kind, use_reentrant=False)
            else:
                x, a, kv = run(x, p, kind)
                kvs.append(kv)
            if a is not None:
                aux = aux + a
        return x, kvs, aux

    # -------------------- loss --------------------
    def loss(self, params, batch: Batch, *, remat: bool = True, xent_chunk: int = 65536):
        """The reference's training objective: next-token cross-entropy
        (position t predicts token t + 1, weighted by the batch's loss
        mask) plus the MoE aux losses summed over layers.  Returns (loss,
        {"nll", "aux", "tokens"}), 0-dim float32 tensors.

        As the reference computes it: the logits come from the forward's
        hidden state WITHOUT the final norm (``logits`` applies it, this
        objective does not, so ``final_norm`` gets no gradient); float32
        products with the (tied or untied) head, the final softcap, the
        padded vocabulary columns masked to NEG_INF; a vision model's
        prefix positions dropped; the tokens in chunks of the largest
        divisor of T = B (S - 1) not above `xent_chunk`, each chunk's logits
        recomputed in the backward pass (``torch.utils.checkpoint``, the
        reference's ``jax.checkpoint``); `remat` checkpoints every layer."""
        cfg = self.cfg
        x, _, aux = self.forward(params, batch, remat=remat)
        if cfg.frontend == "vision_patches" and batch.prefix_embeds is not None:
            x = x[:, batch.prefix_embeds.shape[1]:]
        d = x.shape[-1]
        h = x[:, :-1].reshape(-1, d)
        y = batch.tokens[:, 1:].reshape(-1).to(device=x.device, dtype=torch.long)
        m = batch.loss_mask[:, 1:].reshape(-1).to(device=x.device, dtype=torch.float32)
        t = h.shape[0]
        w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
        chunk = min(xent_chunk, t)
        while t % chunk:
            chunk -= 1
        pad = None
        if self.v_pad != cfg.vocab_size:
            pad = torch.arange(self.v_pad, device=x.device) >= cfg.vocab_size

        # a vocabulary split over the model axis takes the sharded form below
        sharded = shard_utils.is_sharded(h) and shard_utils.axis_size("model") > 1
        if shard_utils.is_sharded(h):     # the head's d_model dim gathered once (FSDP)
            w = shard_utils.constrain(w, None, "model")

        def xent_block(hc, yc, mc):
            hc = shard_utils.constrain(hc, "batch", None)
            lg = hc.to(torch.float32) @ w.to(torch.float32)
            lg = shard_utils.constrain(lg, "batch", "model")    # (T, V_pad) sharded
            lg = layers._softcap(lg, cfg.final_logit_softcap)
            if pad is not None:
                lg = lg.masked_fill(pad, layers.NEG_INF)
            if not sharded:
                lse = torch.logsumexp(lg, dim=-1)
                gold = torch.gather(lg, -1, yc[:, None])[:, 0]
                return torch.sum((lse - gold) * mc), torch.sum(mc)
            # vocabulary shards: the max, the exp-sum and the target's logit
            # reduced over the model axis; no logit leaves its shard
            top = lg.detach().amax(dim=-1, keepdim=True)
            lse = torch.log(torch.sum(torch.exp(lg - top), dim=-1)) + top[:, 0]
            ids = torch.arange(lg.shape[-1], device=lg.device)
            hit = shard_utils.constrain(ids[None, :] == yc[:, None], "batch", "model")
            gold = torch.sum(torch.where(hit, lg, 0.0), dim=-1)
            return torch.sum((lse - gold) * mc), torch.sum(mc)

        tot = cnt = torch.zeros((), dtype=torch.float32, device=x.device)
        for args in _xent_chunks(h, y, m, chunk):
            a, c = checkpoint(xent_block, *args, use_reentrant=False)
            tot, cnt = tot + a, cnt + c
        nll = tot / torch.clamp(cnt, min=1.0)
        return nll + aux, {"nll": nll, "aux": aux, "tokens": cnt}

    def init_cache(self, batch: int, max_len: int, device: DeviceLike, *,
                   paged: bool = False, page_size: int = 64,
                   num_pages: Optional[int] = None, prefix_sharing: bool = True):
        """Decode cache for every layer.  paged=False: zeroed dense per-slot
        caches, one {"k", "v"} per layer (MLA: {"c_kv", "k_rope"}, the
        latent and the rope key; SSM: the zeroed float32 state {"h",
        "conv"}, ``ssm.init_ssm_state``).  paged=True: a started
        `kv_pages.PagedKVPool` of `num_pages` pages (default the dense
        equivalent, batch * ceil(max_len / page_size)) with the radix prefix
        index on or off (`prefix_sharing`).  A windowed layer's dense cache
        is a ring of min(max_len, window_size) slots.  With an encoder
        (Whisper) each layer's dict also holds zeroed cross keys and values
        {"cross_k", "cross_v"} (B, F = encoder seq_len, Hkv, hd), which
        ``prefill`` fills; a sinusoidal-position model refuses a max_len
        past its max_seq_len (the reference's position table ends there)."""
        cfg = self.cfg
        dt = layers.dtype_of(cfg)
        dev = torch.device(device)
        zeros = shard_utils.cache_zeros
        self._check_max_len(max_len)
        if paged:
            if not supports_paged_kv(cfg):
                raise ValueError(f"paged KV unsupported for arch {cfg.name}: needs "
                                 "all-'attn' layers, no MLA, no encoder")
            maxp = kvp.pages_for(max_len, page_size)
            pool = kvp.PagedKVPool(
                num_layers=cfg.num_layers, num_kv_heads=cfg.num_kv_heads,
                head_dim=cfg.resolved_head_dim, dtype=dt,
                num_pages=num_pages or batch * maxp, page_size=page_size,
                max_pages_per_slot=maxp, prefix_sharing=prefix_sharing, device=dev)
            pool.start(batch)
            return pool
        cache = []
        for kind in cfg.layer_kinds():
            if kind == "ssm":
                cache.append(ssm_lib.init_ssm_state(cfg, batch, dev))
                continue
            if cfg.mla is not None:
                m = cfg.mla
                cache.append({
                    "c_kv": zeros("c_kv", (batch, max_len, m.kv_lora_rank), dt, dev),
                    "k_rope": zeros("k_rope", (batch, max_len, m.rope_head_dim), dt, dev)})
                continue
            sm = max_len if kind == "attn" else min(max_len, cfg.window_size)
            shape = (batch, sm, cfg.num_kv_heads, cfg.resolved_head_dim)
            c = {"k": zeros("k", shape, dt, dev), "v": zeros("v", shape, dt, dev)}
            if self.has_cross:
                xs = (batch, cfg.encoder.seq_len, cfg.num_kv_heads, cfg.resolved_head_dim)
                c["cross_k"] = zeros("cross_k", xs, dt, dev)
                c["cross_v"] = zeros("cross_v", xs, dt, dev)
            cache.append(c)
        return cache

    def _check_max_len(self, max_len: int) -> None:
        """A decode step gathers row `position` of the sinusoidal table, whose
        reference ends at max_seq_len (its gather clamps past the end; a
        CUDA gather out of range is a device assert): refuse the length."""
        if self.cfg.rope_theta <= 0 and max_len > self.cfg.max_seq_len:
            raise ValueError(f"{self.cfg.name}: max_len={max_len} exceeds max_seq_len="
                             f"{self.cfg.max_seq_len}, where its sinusoidal position "
                             "table ends")

    def prefill(self, params, batch: Union[Batch, torch.Tensor], max_len: int):
        """Run whole prompts (a `Batch`, or tokens (B, S)) and build a decode
        cache padded to max_len, which must hold the prefix and the prompt
        where a layer keeps a row per position (an all-SSM model takes any
        length); a ring keeps the last Smax keys, position p at slot p % Smax
        (an MLA layer's latent cache is full-window); an SSM layer's state
        is copied as the forward left it; a Whisper layer's cross keys and
        values over the batch's audio frames are copied whole (any frame
        count).  ``prefill_entries`` then the layout in fresh buffers
        (``_layer_cache``); the backends run the first part captured and
        copy the second into their persistent cache (``write_cache``).
        Returns (last-token logits (B, V), cache, next positions as a host
        array (B,): prefix plus prompt tokens)."""
        self._check_max_len(max_len)
        s = self.prompt_len(batch)
        self.check_prompt_fits(s, max_len)
        last, kvs = self.prefill_entries(params, batch)
        kinds = self.cfg.layer_kinds()
        cache = [self._layer_cache(kv, kind, s, max_len) for kv, kind in zip(kvs, kinds)]
        return last, cache, np.full((last.shape[0],), s, np.int64)

    def prefill_entries(self, params, batch: Union[Batch, torch.Tensor]):
        """The capturable part of ``prefill``: ``forward`` over whole
        prompts and the last position's logits.  Returns (last-token
        logits (B, V), each layer's forward entry at the prompt's own
        length, as ``forward`` returns them).  Nothing here depends on a
        cache's length or reads back to the host, so a backend captures it
        keyed by the prompt's shape alone."""
        x, kvs, _ = self.forward(params, batch)
        return self.logits(params, x[:, -1:, :])[:, 0, :], kvs

    def prompt_len(self, batch: Union[Batch, torch.Tensor]) -> int:
        """Positions a prefill of `batch` fills: its tokens, and in front of
        them a "vision_patches" model's prefix embeddings."""
        tokens = batch.tokens if isinstance(batch, Batch) else batch
        prefix = batch.prefix_embeds if isinstance(batch, Batch) else None
        if self.cfg.frontend == "vision_patches" and prefix is not None:
            return tokens.shape[1] + prefix.shape[1]
        return tokens.shape[1]

    def check_prompt_fits(self, s: int, max_len: int) -> None:
        """A decode cache of max_len rows cannot hold an s-position prompt
        where a layer keeps a row per position (an all-SSM model keeps
        none)."""
        if s > max_len and any(k != "ssm" for k in self.cfg.layer_kinds()):
            raise ValueError(f"a decode cache of max_len={max_len} cannot hold the "
                             f"{s} prefix and prompt positions")

    def write_cache(self, cache, entries, s: int, max_len: int,
                    slot: Optional[int] = None) -> None:
        """The eager layout part of ``prefill``: `entries` (``prefill_entries``'
        second result for an s-position prompt) laid out by
        ``_layer_cache``, as ``prefill`` lays them out, and copied in place
        into `cache`, a dense decode cache of ``init_cache``'s layout for
        max_len.  `slot` None writes every row; an int writes one prompt's
        entries (batch 1) into row `slot` of every buffer (a join: an SSM
        row's state is overwritten, whatever the dead row was stepped to)."""
        rows = slice(None) if slot is None else slice(slot, slot + 1)
        for dst, kv, kind in zip(cache, entries, self.cfg.layer_kinds()):
            laid = self._layer_cache(kv, kind, s, max_len)
            for name, buf in dst.items():
                buf[rows].copy_(laid[name])

    def _layer_cache(self, kv, kind: str, s: int, max_len: int):
        """One layer's decode cache from its forward entry, in fresh buffers
        laid out as ``init_cache`` lays them out: a row-per-position entry
        keeps Smax rows (a ring the last Smax, position p at slot p % Smax;
        a full window padded with zeros to max_len); an SSM state and the
        cross keys and values are copied whole.  Under a mesh each entry
        is redistributed to its decode-cache layout (``as_cache``); without
        one that is the identity."""
        cfg = self.cfg
        if kind == "ssm":   # a state, not a row per position
            return {n: shard_utils.as_cache(n, _fresh(v, torch.float32))
                    for n, v in kv.items()}
        dt = layers.dtype_of(cfg)
        names = (("c_kv", "k_rope") if cfg.mla is not None else ("k", "v")) + (
            ("cross_k", "cross_v") if self.has_cross else ())
        sm = (max_len if kind == "attn" or cfg.mla is not None
              else min(max_len, cfg.window_size))
        c = {}
        for name, src in zip(names, kv):
            if name.startswith("cross_"):       # the encoder's, every frame
                src = _fresh(src, dt)
            elif s >= sm:
                src = torch.roll(src[:, -sm:].to(dt), (s - sm) % sm, dims=1)
            else:
                pad = torch.zeros((src.shape[0], sm - s, *src.shape[2:]), dtype=dt,
                                  device=src.device)
                src = torch.cat([src.to(dt), pad], dim=1)
            c[name] = shard_utils.as_cache(name, src)
        return c

    # -------------------- decode --------------------
    def decode_step(self, params, cache, tokens: torch.Tensor,
                    positions: torch.Tensor, active: Optional[torch.Tensor] = None):
        """tokens (B, 1); positions (B,) int64 write index; active: optional
        (B,) bool live-slot mask (dead slots take no MoE capacity; an SSM
        layer steps every row's state, a dead slot's too, as the reference
        does: a join or a resume overwrites the row).  A sinusoidal-position
        model adds row `positions` of its table (on the device since the
        prefill); a Whisper layer attends into the cross keys and values in
        its cache.  The cache is updated in place.  Returns logits (B, V)."""
        cfg = self.cfg
        x = self.embed(params, tokens)
        if cfg.rope_theta <= 0:
            table = self.pos_table(cfg.max_seq_len, cfg.d_model, x.device)
            x = x + table[positions][:, None, :].to(x.dtype)
        rope = _use_rope(cfg)
        for p, c, kind in zip(params["layers"], cache, cfg.layer_kinds()):
            if kind == "ssm":
                def mix(h, p=p, c=c):
                    return ssm_lib.ssm_decode(p["mixer"], h, c, cfg)
            elif cfg.mla is not None:
                def mix(h, p=p, c=c):
                    return layers.mla_decode(p["attn"], h, c, positions, cfg)
            else:
                def mix(h, p=p, c=c, kind=kind):
                    return layers.attn_decode(p["attn"], h, c, positions, cfg, kind, rope)
            cross = (c["cross_k"], c["cross_v"]) if self.has_cross else None
            x, _ = _layer(p, x, mix, cfg, token_mask=active, enc_kv=cross)
        return self.logits(params, x)[:, 0, :]

    # -------------------- paged decode / chunked prefill --------------------
    def decode_step_paged(self, params, k_pages, v_pages, table, tokens, positions,
                          active) -> torch.Tensor:
        """One decode step against a paged KV pool.  k_pages / v_pages:
        per-layer (P + 1, psz, Hkv, hd) buffers, written in place; table
        (B, maxp) int32; tokens (B, 1); positions (B,) write index; active
        (B,) bool (inactive slots write nothing and take no MoE capacity).
        Returns logits (B, V)."""
        cfg = self.cfg
        x = self.embed(params, tokens)
        for p, kp, vp in zip(params["layers"], k_pages, v_pages):
            x = _layer_decode_paged(p, x, kp, vp, table, positions, active, cfg)
        return self.logits(params, x)[:, 0, :]

    def prefill_chunk_paged(self, params, k_pages, v_pages, table, tokens, start, n,
                            wstart=None) -> torch.Tensor:
        """One chunk of chunked prefill against a paged KV pool: tokens
        (B, C), row b valid for its first n[b] tokens from absolute position
        start[b]; K/V written into the rows' pages in place (positions below
        the optional write floor wstart[b] attend but do not write).
        Returns the last valid token's logits (B, V)."""
        cfg = self.cfg
        b, c = tokens.shape
        x = self.embed(params, tokens)
        valid_flat = (torch.arange(c, device=x.device)[None, :] < n[:, None]).reshape(-1)
        for p, kp, vp in zip(params["layers"], k_pages, v_pages):
            x = _layer_chunk_paged(p, x, kp, vp, table, start, n, wstart, valid_flat, cfg)
        last = torch.clamp(n - 1, 0, c - 1).to(torch.long)
        xl = x[torch.arange(b, device=x.device), last][:, None, :]
        return self.logits(params, xl)[:, 0, :]


def _fresh(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A contiguous copy of `t` in `dtype` (never `t`'s own storage: the
    decode step writes its cache in place)."""
    return t.to(dtype, copy=True, memory_format=torch.contiguous_format)


def unstack_layers(cfg: ModelConfig, params) -> List[Dict[str, Any]]:
    """The flat per-layer parameter list (the port stores it flat)."""
    del cfg
    return list(params["layers"])


def build_model(cfg: ModelConfig) -> Model:
    return Model(cfg)
