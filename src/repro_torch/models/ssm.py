"""Mamba-2 (SSD, state-space duality, arXiv:2405.21060) in the port.

PyTorch twin of the JAX package's ``models/ssm.py``, function by function.
Prefill runs the chunked matmul form: a quadratic, attention-like term
inside each chunk plus a sequential recurrence of the state across chunks
(a Python loop over the chunks, the reference's ``lax.scan``), so the cost
is O(S * L) for chunk length L.  Decode is the O(1) recurrent update of the
carried state, written into the caller's state buffers in place, so a
captured decode step (``capture.CapturedStep``) updates them on every
replay.  Plain tensor math, as the reference is plain ``jnp``: no kernel.

Shapes: d_inner = expand * d_model, H = d_inner / head_dim heads, state N =
d_state, head dim P = head_dim, n_groups G (B and C shared per group).  The
state is float32, {"h": (B, H, P, N), "conv": (B, K - 1, conv_dim)}: the
SSM state and the last K - 1 pre-activation conv inputs.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import shard_utils
from repro_torch.models.layers import dense_init, dtype_of


def ssm_dims(cfg: ModelConfig):
    """(d_inner, heads, conv channels: d_inner plus B and C of every group)."""
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    nheads = d_in // s.head_dim
    conv_dim = d_in + 2 * s.n_groups * s.d_state
    return d_in, nheads, conv_dim


def ssm_init(cfg: ModelConfig, gen: torch.Generator, device: torch.device):
    """in_proj (D, 2 d_inner + 2 G N + H), conv_w (K, conv_dim) and out_proj
    (d_inner, D) in the config dtype; conv_b, A_log (log 1..16 over the
    heads), D (ones), dt_bias and the gated norm's gain "norm" (zeros: a
    unit gain) float32, as the reference keeps them."""
    s = cfg.ssm
    d = cfg.d_model
    d_in, nheads, conv_dim = ssm_dims(cfg)
    dt = dtype_of(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    in_cols = 2 * d_in + 2 * s.n_groups * s.d_state + nheads
    return {
        "in_proj": dense_init((d, in_cols), dt, gen, device),
        "conv_w": dense_init((s.d_conv, conv_dim), dt, gen, device, scale=0.5),
        "conv_b": torch.zeros((conv_dim,), **f32),
        "A_log": torch.log(torch.linspace(1.0, 16.0, nheads, **f32)),
        "D": torch.ones((nheads,), **f32),
        "dt_bias": torch.zeros((nheads,), **f32),
        "norm": torch.zeros((d_in,), **f32),
        "out_proj": dense_init((d_in, d), dt, gen, device),
    }


def _split_proj(proj: torch.Tensor, cfg: ModelConfig):
    """in_proj's output -> (z (..., d_in), xbc (..., d_in + 2 G N), dt (..., H))."""
    s = cfg.ssm
    d_in, nheads, _ = ssm_dims(cfg)
    gn = s.n_groups * s.d_state
    return torch.split(proj, [d_in, d_in + 2 * gn, nheads], dim=-1)


def _causal_conv(xbc: torch.Tensor, conv_w: torch.Tensor, conv_b: torch.Tensor,
                 cfg: ModelConfig) -> torch.Tensor:
    """Depthwise causal conv over the sequence dim in float32, then SiLU,
    the result in xbc's dtype.  xbc: (B, S, C)."""
    del cfg
    w = conv_w.to(torch.float32)                        # (K, C)
    k = w.shape[0]
    xf = xbc.to(torch.float32)
    pad = F.pad(xf, (0, 0, k - 1, 0))
    out = sum(pad[:, i:i + xf.shape[1], :] * w[i] for i in range(k))
    return F.silu(out + conv_b).to(xbc.dtype)


def _gated_norm(y: torch.Tensor, z: torch.Tensor, scale: torch.Tensor,
                eps: float) -> torch.Tensor:
    """RMSNorm(y * silu(z)) with a (1 + scale) gain, in float32, the result
    in y's dtype: Mamba-2's gated output norm.  (..., d_in)."""
    g = y.to(torch.float32) * F.silu(z.to(torch.float32))
    ms = torch.mean(torch.square(g), dim=-1, keepdim=True)
    return (g * torch.rsqrt(ms + eps) * (1.0 + scale)).to(y.dtype)


def ssd_chunked(x, dt, a, b, c, d_skip, chunk: int):
    """The SSD scan in matmul form, in float32.
    x: (B, S, H, P)  dt: (B, S, H)  a: (H,) negative  b, c: (B, S, G, N)
    d_skip: (H,); S a multiple of `chunk`.
    Returns y (B, S, H, P) in x's dtype and the final state (B, H, P, N)."""
    bs, s, h, p = x.shape
    g, n = b.shape[2], b.shape[3]
    assert s % chunk == 0, (s, chunk)
    nc = s // chunk
    rep = h // g

    xf = x.to(torch.float32).reshape(bs, nc, chunk, h, p)
    dtf = dt.to(torch.float32).reshape(bs, nc, chunk, h)
    bf = b.to(torch.float32).reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)
    cf = c.to(torch.float32).reshape(bs, nc, chunk, g, n).repeat_interleave(rep, dim=3)

    da = dtf * a                                        # (B, nc, L, H) <= 0
    da_cs = torch.cumsum(da, dim=2)                     # within-chunk cumsum
    da_total = da_cs[:, :, -1, :]                       # (B, nc, H)

    # intra-chunk (the attention-like term): lmat[i, j] = exp(da_cs[i] -
    # da_cs[j]) for i >= j, else 0.  Above the diagonal the difference is
    # positive and exp can overflow, so it is masked to -inf before exp
    # (exp(-inf) = 0 exactly; a multiplied mask would give inf * 0 = NaN).
    diff = da_cs[:, :, :, None, :] - da_cs[:, :, None, :, :]   # (B, nc, L, L, H)
    ii = torch.arange(chunk, device=x.device)
    causal = (ii[:, None] >= ii[None, :])[None, None, :, :, None]
    lmat = torch.exp(diff.masked_fill(~causal, float("-inf")))
    cb = torch.einsum("bzihn,bzjhn->bzijh", cf, bf)           # (B, nc, L, L, H)
    y_diag = torch.einsum("bzijh,bzjhp->bzihp", cb * lmat * dtf[:, :, None], xf)

    # per-chunk input -> state contribution
    decay_to_end = torch.exp(da_total[:, :, None, :] - da_cs)  # (B, nc, L, H)
    s_chunk = torch.einsum("bzlhn,bzlhp->bzhpn", bf * (decay_to_end * dtf)[..., None], xf)

    # inter-chunk recurrence; h_prevs[z] is the state before chunk z
    state = torch.zeros((bs, h, p, n), dtype=torch.float32, device=x.device)
    decay = torch.exp(da_total)
    h_prevs = []
    for z in range(nc):
        h_prevs.append(state)
        state = state * decay[:, z, :, None, None] + s_chunk[:, z]
    h_prev = torch.stack(h_prevs, dim=1)                       # (B, nc, H, P, N)

    # inter-chunk output: y_off[i] = C_i . (exp(da_cs[i]) * h_prev)
    y_off = torch.einsum("bzlhn,bzhpn->bzlhp", cf * torch.exp(da_cs)[..., None], h_prev)
    y = (y_diag + y_off).reshape(bs, s, h, p)
    y = y + xf.reshape(bs, s, h, p) * d_skip[None, None, :, None]
    return y.to(x.dtype), state


def ssm_forward(p, x: torch.Tensor, cfg: ModelConfig):
    """Full-sequence Mamba-2 block.  x: (B, S, D).  Returns (out (B, S, D),
    state {"h", "conv"}) where the state continues into ``ssm_decode``: the
    final SSM state and the last K - 1 pre-activation conv inputs (zeros in
    front of a prompt shorter than that).  The sequence is padded to a chunk
    multiple after the softplus, so padded steps have dt = 0 (decay 1, no
    input) and leave the final state as the prompt left it."""
    s = cfg.ssm
    d_in, nheads, _ = ssm_dims(cfg)
    proj = x @ p["in_proj"]
    z, xbc, dt = _split_proj(proj, cfg)
    kw = p["conv_w"].shape[0]
    pad_raw = F.pad(xbc.to(torch.float32), (0, 0, kw - 1, 0))
    conv_tail = pad_raw[:, pad_raw.shape[1] - (kw - 1):, :]
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"], cfg)
    gn = s.n_groups * s.d_state
    xs, b, c = torch.split(xbc, [d_in, gn, gn], dim=-1)
    bsz, seq, _ = x.shape
    xs = xs.reshape(bsz, seq, nheads, s.head_dim)
    b = b.reshape(bsz, seq, s.n_groups, s.d_state)
    c = c.reshape(bsz, seq, s.n_groups, s.d_state)
    dtf = F.softplus(dt.to(torch.float32) + p["dt_bias"])
    a = -torch.exp(p["A_log"])
    chunk = min(s.chunk_size, seq)
    pad = -seq % chunk
    if pad:
        xs, b, c = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (xs, b, c))
        dtf = F.pad(dtf, (0, 0, 0, pad))
    y, h_final = ssd_chunked(xs, dtf, a, b, c, p["D"], chunk)
    y = _gated_norm(y[:, :seq].reshape(bsz, seq, d_in), z, p["norm"], cfg.norm_eps)
    return y @ p["out_proj"], {"h": h_final, "conv": conv_tail}


def ssm_decode(p, x: torch.Tensor, state, cfg: ModelConfig) -> torch.Tensor:
    """One-token recurrent update.  x: (B, 1, D); state {"h": (B, H, P, N),
    "conv": (B, K - 1, conv_dim)} float32, written in place (the conv window
    rolled by one, the SSM state stepped).  Every row is stepped, a dead
    slot's with whatever token it is fed, as in the reference.  Returns out
    (B, 1, D)."""
    s = cfg.ssm
    d_in, nheads, _ = ssm_dims(cfg)
    bsz = x.shape[0]
    proj = x[:, 0, :] @ p["in_proj"]                     # (B, cols)
    z, xbc, dt = _split_proj(proj, cfg)
    # rolling causal conv
    window = torch.cat([state["conv"], xbc[:, None, :].to(torch.float32)], dim=1)
    wf = p["conv_w"].to(torch.float32)
    conv_out = torch.einsum("bkc,kc->bc", window, wf) + p["conv_b"]
    xbc_act = F.silu(conv_out).to(x.dtype)

    gn = s.n_groups * s.d_state
    rep = nheads // s.n_groups
    xs, b, c = torch.split(xbc_act, [d_in, gn, gn], dim=-1)
    xs = xs.reshape(bsz, nheads, s.head_dim).to(torch.float32)
    b = b.reshape(bsz, s.n_groups, s.d_state).repeat_interleave(rep, dim=1).to(torch.float32)
    c = c.reshape(bsz, s.n_groups, s.d_state).repeat_interleave(rep, dim=1).to(torch.float32)
    dtf = F.softplus(dt.to(torch.float32) + p["dt_bias"])   # (B, H)
    a = -torch.exp(p["A_log"])
    da = torch.exp(dtf * a)                                  # (B, H)
    h = state["h"] * da[:, :, None, None] + torch.einsum(
        "bhp,bhn->bhpn", xs * dtf[:, :, None], b)
    y = torch.einsum("bhn,bhpn->bhp", c, h)
    y = y + xs * p["D"][None, :, None]
    y = y.reshape(bsz, d_in).to(x.dtype)
    y = _gated_norm(y, z, p["norm"], cfg.norm_eps)
    state["h"].copy_(shard_utils.as_cache("h", h))
    state["conv"].copy_(shard_utils.as_cache("conv", window[:, 1:, :]))
    return (y @ p["out_proj"])[:, None, :]


def init_ssm_state(cfg: ModelConfig, batch: int, device) -> dict:
    """A zeroed float32 state of `batch` rows: {"h": (B, H, P, N), "conv":
    (B, K - 1, conv_dim)}."""
    s = cfg.ssm
    _, nheads, conv_dim = ssm_dims(cfg)
    return {
        "h": shard_utils.cache_zeros("h", (batch, nheads, s.head_dim, s.d_state), torch.float32, device),
        "conv": shard_utils.cache_zeros("conv", (batch, s.d_conv - 1, conv_dim), torch.float32, device),
    }
