"""On-card smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card (an H100 is the target) and the CUDA toolkit; it exits
non-zero without printing a result when either is missing, or when this file
stands outside a checkout of the repository.  Phases, each fatal on failure
and each printing its seconds:

  1. device  — card name and power limit, TF32 off for float32 products;
  2. build   — the Hopper kernels from ``src/repro_torch/kernels/csrc``;
  3. kernels — each kernel against its plain PyTorch version at the serving
               path's full Mixtral-8x7B shapes; device time from CUDA-graph
               replays timed with CUDA events; the router kernels timed
               beside a launch floor, swept over cluster sizes, checked at
               edge variants and bit-identical over two calls, their layout
               constants held to ops.py's; the grouped dequant pair on its
               tensor-core kernel at P = 1-5 and 8 pairs and two pairs on
               one slot, pools cold in L2, swept over cluster size,
               then bits 8/2, float32 x, pads, passes of more
               than 8 pairs, groups, ragged N and every cluster size, each
               bit-identical over two calls on the kernel its shape names;
               the grouped bf16 GEMV of the hi experts (``grouped_matmul``,
               no TPU kernel: the reference's jitted hi einsum) at
               Mixtral's wi and wo shapes, P = 1, 2, 4, 8, two pairs on one
               slot and 8 pairs with 6 pads, timed beside its bytes bound
               and torch.matmul on the pool views (P in one graph), with
               its plan and weight bytes per SM, then float32, ragged N,
               K off the ring's stage, 9 and 17 pairs on a slot and 1024
               pairs, each bit-identical over two calls; an out-of-range pool slot (a
               pad's too) must abort both grouped dequant kernels and the
               grouped GEMV, and an out-of-range page id the paged
               flash-decode kernel (checked in child processes);
               paged flash decode also at 4 x 4096 and 1 x 32768 tokens;
  3b. g = 6    — paged flash decode at Nemotron-4-15B's and InternVL2-26B's
               heads (48 query heads on 8 kv heads, hd 128): the Nemotron
               serve's shape, 4 x 4096 and 1 x 32768 tokens, lengths 0 and
               1 in a ragged batch, float32 K/V and a NaN-poisoned pool,
               each bit-identical over two calls, timed beside its bytes
               bound and SDPA, with the pass-1 kernels' registers and
               spills and the blocks per SM the runtime gives;
  3c. dequant_matmul — the dense dequant-matmul kernels at Granite-3.0-2B's
               FFN shapes (decode M = 1-4 on the tensor-core decode kernel,
               timed beside the gemv kernel; prefill M = 64 / 256 on the
               tensor-core prefill kernel; 4-bit codes, group 128, bf16 x;
               weights cold in L2), two calls bit-identical, the decode
               kernel at every cluster size, then bits 8/2, float32 x,
               ragged M and N, groups 8-512, raw codes, leading dims,
               unaligned x and codes, clusters, each with the kernel it
               took; then the decode kernel at Mixtral-8x7B's expert shapes
               (wi 4096 -> 28672, wo 14336 -> 4096, M = 1, group 64, the
               weight a pool slot's view), as the per-expert engine path
               calls it, beside its bound and torch.matmul; and at
               Nemotron-4-15B's FFN (wi 6144 -> 24576, wo 24576 -> 6144,
               192 groups of K; 4 bits, group 128): decode M = 1-4 and
               prefill M = 64, 256, two calls bit-identical, timed beside
               its bound and torch.matmul;
  3d. flash_decode — the contiguous flash-decode kernel at (a) Granite's
               serving shape, (b) 4 x 4096 and (c) 1 x 32768 tokens (the
               paged kernel's shapes), then length 0 and 1, S off the tile,
               g = 1, float32 K/V; SDPA on the same cache as the yardstick;
               then the same three shapes at g = 6 (48/8 heads), lengths 0
               and 1 in a ragged batch and float32 K/V;
  4. serve   — HobbitBackend under BatchingServer on full-width Mixtral-8x7B
               (depth cut to 4 layers, seeded random bf16 weights): mixed-
               length greedy requests, with every kernel's launch counted,
               the engine's gating_s, the lo pairs and distinct slots per
               grouped launch, every grouped launch on the tensor-core
               kernel; every MoE layer's captured segment (attention, norm,
               router and predictor gating) and grouped FFN (fixed pair count B * top_k, one
               graph for every layer: as many FFN calls as layer steps, two
               grouped_matmul and one of each grouped dequant launch per
               layer step) and the step's embed and logits replayed as CUDA
               graphs and never run eagerly; one segment's replay and one
               FFN replay on a fixed input against the same function called
               eagerly (the FFN's max |diff| must be 0), and the segment's
               predictor probabilities for every row equal to the
               predictor's one-row call bit for bit;
  5. parity  — the offload engine with every expert resident at full
               precision against the dense model, step by step;
  6. serve-paged — the same server and model on the paged KV layout
               (``EngineConfig(paged_kv=True)`` defaults): requests sharing
               a 48-token system prompt, so a partial page is aliased and
               copied on write; every kernel's launch counted; the grouped
               FFN checked as in phase 4, and the admission chunks
               replayed as CUDA graphs (``prefill_chunk``) after their
               capture, never eagerly;
  7. paged parity — the unconstrained engine on paged KV against the same
               engine on dense KV, step by step;
  7b. per-expert — the per-expert reference path (``grouped=False``)
               against the grouped path on the same Mixtral-cut weights and
               teacher-forced workload, synchronous loading, constrained
               cache, dense and paged KV: equal routes, precision decisions
               and load counts and logits within atol 0.1 until a row's
               routes part at a near tie, the dense dequant-matmul kernel
               for every lo expert and no grouped kernel; the per-expert
               path's embedding, segments (attention and FFN norm,
               ``engine_attn<i>``), hi and lo experts (one graph per
               precision and pool slot) and logits replayed as CUDA graphs
               and never run eagerly, the one-shot dense-KV prefill's one
               call eager (a shape's first) on both paths; both paths'
               decode tok/s, the per-expert path's beside commit e06ac32's (its
               steps eager);
  7c. host-mode — ``score_nll`` through the engine in host compute mode
               (experts on the CPU in float32) against the device
               per-expert path, and its seconds;
  7d. single-sequence — ``engine.generate`` against ``api.generate``
               through HobbitBackend on one prompt, and ``api.score_nll``
               through HobbitBackend against DenseBackend (the unconstrained
               configuration of phase 5);
  7f. simulator — the simulator's host model on the card
               (``core.host_model``): the pinned copy rate of one hi expert
               and the resident engine's decode_token wall per MoE layer,
               the slope between 2 and 4 layers (beside the per-step
               intercept, a profiler window's device time and the
               committed ``H100_HOST``); then one batch-1 sequence on the
               serve configuration, the engine's tok/s, load stall,
               overlap, hit ratio and loads against the simulator's on the
               same trace under ``H100_HOST`` and under this run's
               constants, a replay step's wall split into load stall,
               compute kernels and host work (profiler), and the four
               systems' simulated table;
  7e. engine-prefill — the offload engine's dense-KV ``prefill_batch`` and
               joins captured (``models.prefill.DenseKVPrefill``): a 4 x 64
               prefill 21 times across ``start_batch`` and 21 one-row
               64-token joins into slots 0-3, each shape's first call
               eager, its second captured, every later call a replay,
               against the same series through ``DenseBackend(jit=False)``:
               logits and KV cache equal, first-call / capture / replay /
               eager ms and the graphs' memory;
  8. serve-dense — Granite-3.0-2B at full width and depth (40 layers,
               seeded random bf16 weights) through DenseBackend(paged=True)
               under BatchingServer, once with bf16 FFN weights and once
               with them quantized by ``quantize_tree`` (4 bits), every
               dense-FFN product then in the dequant-matmul kernel, the
               decode step a replayed CUDA graph and each prefill chunk
               captured (``jit=True``, the default); then 3 decode steps of
               the quantized model under
               torch.profiler (the device's busy share and its top
               kernels);
  8b. serve-dense-jit — the quantized Granite's serve again with
               ``DenseBackend(jit=False)`` (eager) and once on the dense KV
               layout (captured): greedy outputs and per-op launch counts of
               the captured and eager runs equal, the step's logits equal,
               both runs' decode tok/s and median step wall, the profiler
               window both ways, and ``decode.generate`` captured against
               eager;
  8c. prefill-capture — the one-shot dense-KV prefill of Granite-3.0-2B
               (40 layers) through ``DenseBackend`` captured (``jit=True``)
               against eager (``jit=False``), bf16 and with the 4-bit FFN:
               the series of 7e (two graphs surviving ``start_batch``, the q4
               prefills on the tensor-core prefill kernel only), logits,
               cache and launches equal, eager / first-call (eager) /
               capture / replay ms (medians of 19), the graphs' pool
               memory, and one prefill each way under torch.profiler
               (kernels and device ms per prefill); phases 10, 12, 12d, 13,
               14 and 14d add one B = 1 64-token prefill of their model,
               four times (eager, captured, replayed twice) against eager;
               every dense-KV serve phase prints its prefill calls by
               route, the prefill graphs' memory after serving prompts of
               32-64 tokens, and its time to first token;
  9. dense parity — the quantized Granite at full width cut to 4 layers on
               the card (kernels) against the same weights on the CPU (plain
               versions), step by step;
  10. serve-nemotron — Nemotron-4-15B at full width and depth (32 layers,
               ~15.6 B parameters, ~31 GB of seeded bf16: layernorm,
               squared-ReLU FFN, the untied 6144 x 256000 head) served as in
               phase 8 (paged flash decode at g = 6, decode steps replayed
               graphs), once in bf16 and once with the FFN quantized in
               place to 4 bits (the bf16 FFN freed first; the dequant-matmul
               kernels launched): decode tok/s, median step wall, peak device
               memory, the seconds to seed and to quantize, a 3-step profiler
               window, and the logits' float32 head cast timed alone;
  10b. nemotron-parity — Nemotron at full width cut to 2 layers, bf16, on
               the card against the CPU, step by step, as phase 9;
  11. internvl2 — InternVL2-26B at full width cut to 8 layers with 256
               seeded patch embeddings per row: ``decode.generate`` with the
               prefix captured against eager (tokens and every step's logits
               equal), then a text-only paged serve (g = 6 launches);
  3e. (run with phase 3) dequant_matmul — the dense dequant-matmul kernels
               at Gemma-2-27B's FFN (wi 4608 -> 73728, wo 36864 -> 4608:
               288 quant groups of K over 36 column tiles; 4 bits, group
               128): decode M = 1-4 and prefill M = 64, 256 against the plain
               version, two calls bit-identical, each shape's kernel and
               K-split, timed beside its bound and torch.matmul;
  12. serve-gemma2 — Gemma-2-27B at full width and depth (46 layers, ~27.2 B
               parameters, ~54 GB of seeded bf16: sliding-window and global
               layers, softcaps, sandwich norms, scaled embeddings) through
               DenseBackend on the dense KV layout with ring caches (decode
               steps replayed graphs; no kernel on the bf16 path: the
               windowed attention is plain PyTorch, as in the reference),
               once in bf16 and once with the FFN quantized in place to 4
               bits (the dequant-matmul kernels launched, their plain
               version never): decode tok/s, median step wall, peak device
               memory, seconds to seed and to quantize, a 3-step profiler
               window and the logits' float32 head cast;
  12b. gemma2-parity — Gemma-2 at full width cut to 2 layers (one local,
               one global), bf16, on the card against the CPU, as phase 9;
  12c. ring-gemma3 — Gemma-3-27B at full width cut to 12 layers: a 1020-
               token prompt decoded through the ring's wrap at 1024 and a
               1040-token prompt (longer than the window), each captured
               step against ``Model.forward`` within 0.1 in float32 weights;
               the bf16 model's gap to the forward measured, then a serve;
  12d. llama4-scout — Llama-4-Scout-17B-16E at full width cut to 8 layers
               (~37 GB of bf16): a serve, HobbitBackend's refusal, and an
               8188-token prompt decoded across the chunk boundary at 8192
               with its gap to ``Model.forward`` measured; then the same
               held within 0.1 in float32 weights at 4 layers (capacity
               factor 16 in both: no drops); each MoE layer's top-1 expert
               at position 8193 printed for the step and for the forward;
  3f. (run with phase 3) dequant_matmul — the dense dequant-matmul kernels
               at DeepSeek-V2-236B's dense first layer (wi 5120 -> 24576, wo
               12288 -> 5120) and its 2 shared experts run as one FFN (wi
               5120 -> 6144, wo 3072 -> 5120; 4 bits, group 128), as 3e;
  13. serve-deepseek — DeepSeek-V2-236B at full width (MLA over a 512-wide
               latent, 128 heads, 160 experts at top-6 beside 2 shared
               experts, a dense first layer) cut to 4 layers (~26 GB of
               seeded bf16) through DenseBackend on dense KV with latent
               caches (no kernel on the bf16 path: the MLA attention is
               plain PyTorch, as in the reference), then with the dense and
               shared FFN quantized in place to 4 bits (the dequant-matmul
               kernels, never their plain version): decode tok/s, median
               step, peak memory, a profiler window, the logits' head cast,
               the absorbed decode's float32 casts of w_uk / w_uv and the
               latent cache's bytes per token (1152); HobbitBackend's
               refusal names MLA;
  13b. deepseek-parity — 2 layers (dense + MoE), bf16, card against CPU;
  13c. mla-long — an 1100-token prompt decoded across mla_forward's
               1024-query chunk, each captured step against
               ``Model.forward`` within 0.1 in float32 weights at 2 layers
               (capacity factor E / top_k: no drops), the bf16 gap at 4
               layers measured;
  3g. (run with phase 3) dequant_matmul — the dense dequant-matmul kernels
               at Jamba-v0.1-52B's dense FFN (wi 4096 -> 28672, wo 14336 ->
               4096; 4 bits, group 128), as 3e;
  14. serve-mamba2 — Mamba2-780m as published (48 Mamba-2 SSD layers, 1536
               wide, 48 heads of 64, d_state 128, no attention, no FFN; 1.56
               GB of seeded bf16, no cut) through DenseBackend on the dense
               layout, whose cache is the float32 SSM state (77.4 MB per
               slot at any length; no kernel: the SSD scan, the causal conv
               and the gated norm are plain PyTorch, as in the reference):
               decode tok/s, median step, peak memory, the graph replays, a
               profiler window (device ms and launches per step by kernel,
               the busy share) and the head cast; the paged layout's and
               HobbitBackend's refusals;
  14b. mamba2-parity — card against CPU: gated within 0.1 in float32
               weights at full depth and in bf16 at 2 layers; the bf16 gap
               at full depth measured (48 bf16 layers of seeded weights
               amplify rounding differences to O(1));
  14c. ssm-long — a 600-token prompt (two 256-token SSD chunks and an
               88-token tail padded with dt = 0), then 8 captured steps
               against ``Model.forward``: gated within 0.1 in float32
               weights (3.1 GB), measured in bf16;
  14d. serve-jamba — Jamba-v0.1-52B at full width (7 SSD layers and one
               attention layer without positional encoding per period, 16
               experts at top-2 in every other layer) cut from 32 to 16
               layers (51.5 GB of seeded bf16) on the dense layout (SSM
               states and two layers' K/V), then with its dense FFN
               quantized in place to 4 bits (16 dequant-matmul launches per
               decode step, never the plain version); the bf16 gap of a
               300-token prompt to ``Model.forward`` with each MoE layer's
               top-2 experts wherever it exceeds 0.1; HobbitBackend's
               refusal names the ssm layers;
  14e. jamba-long — one 8-layer period in float32 weights (52.0 GB): the
               300-token prompt (over the 256-token SSD chunk) and 6
               captured steps held to ``Model.forward`` within 0.1
               (capacity factor E / top_k = 8: no drops);
  15. serve-whisper — whisper-tiny as published (4 encoder + 4 decoder
               layers, 384 wide, 6 heads of 64, vocab 51865; ~73 MB of
               seeded bf16, no cut; no kernel on its path: the reference
               decodes it on the dense cache's plain attention and its
               cross-attention is plain ``mha``) through
               ``decode.generate(jit=True)`` with seeded frames (4, 1500,
               384) x 0.02, 4-token prompts and 64 new tokens, every decode
               step after the first a graph replay; the same steps timed one
               by one (median step, decode tok/s), the encoder and the
               prefill per call, a profiler window (kernels and device ms
               per step, the busy share), peak memory, the cross K/V bytes
               per slot (9,216,000);
  15b. whisper-parity — card against CPU at full width on the same seeded
               weights and frames, float32 and bf16, each gated at 0.1;
  15c. whisper-long — float32: a 16-token prompt, then 48 captured steps
               against ``Model.forward``, each position within 0.1;
  16. train-mixtral — Mixtral-8x7B at full width cut from 32 to 2 layers
               (3.03 B parameters: 6.1 GB of bf16 parameters, 6.1 GB of
               gradients, 24.3 GB of float32 moments), ``make_train_step``
               with remat on 4 x 512 tokens of the port's data pipeline, 6
               steps: the step's wall split into forward + backward and the
               optimizer, tokens/s, the model-FLOPs share of the bf16 dense
               peak, peak memory; gated: finite losses, 6 optimizer steps,
               the parameters moved (no kernel on the training path);
  16b. train-parity — the repository's float32 mixtral-smoke checkpoint
               (step 300) restored by the port on the card and on the CPU,
               10 steps on each from the same batches, every step's loss
               within 1e-3; the card's checkpoint, saved in the reference's
               format, restored on the CPU bit-identical;
  17. roofline-check — the op analysis (``launch.op_analysis``) of two
               kernel-free steps twice, on fake CPU tensors and on the card:
               train-mixtral (phase 16's step) and the bf16 Granite-3.0-2B
               decode step on dense KV at batch 4; gated: FLOPs equal,
               bytes within 1%, the analysed peak within 15% of
               max_memory_allocated; printed: the roofline step from the
               H100 SXM5 datasheet constants, the measured median step and
               their ratio;
  17b. nccl-mesh — NCCL at world size 1 (FileStore, no network), the
               production mesh's code path at shape (1, 1) on cuda,
               mixtral-smoke's checkpoint trained one step with DTensor
               parameters laid out by the rule table against the unsharded
               step: loss and every parameter within 1e-6 in float32;
  17c. dryrun — ``launch.dryrun.run_one`` for Mixtral-8x7B x train_4k and
               x decode_32k on the (32, 8) production mesh (fake process
               group and tensors; analysis, not measurement): both ok.

The line before the last is one JSON object with a row per kernel; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import itertools
import json
import math
import os
import statistics
import subprocess
import sys
import time
from typing import Optional

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, the float32
# rate outside the tensor cores (float32 FMAs) and the dense bf16
# tensor-core rate (the flash-decode kernels' bf16 K/V products)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
BF16_FLOPS = 989e12
SEED = 0
ARCH = "mixtral-8x7b"
LAYERS = 4
SERVE_BATCH = 4     # rows of the Mixtral serve phases: the grouped path's B
GRANITE = "granite-3-2b"
NEMOTRON = "nemotron-4-15b"
INTERNVL = "internvl2-26b"
GEMMA2 = "gemma2-27b"
GEMMA3 = "gemma3-27b"
LLAMA4 = "llama4-scout-17b-a16e"
DEEPSEEK = "deepseek-v2-236b"
MAMBA2 = "mamba2-780m"
JAMBA = "jamba-v0.1-52b"
WHISPER = "whisper-tiny"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def cuda_ms(fn, *, warmup: int = 3, iters: int = 20) -> float:
    """Milliseconds per call of `fn()` as called from Python: CUDA events
    around `iters` back-to-back calls after `warmup` untimed ones.  For a
    short kernel this is the host's launch cost, not the card's time."""
    for _ in range(warmup):
        fn()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, *, launches: int = 20, replays: int = 20) -> float:
    """Device milliseconds per call of `fn()`: `launches` calls captured back
    to back in one CUDA graph (so host launch cost drops out), the graph
    replayed `replays` times, each replay timed with CUDA events; the median
    replay over `launches`."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / launches)
    del graph
    return statistics.median(times)


def bound(nbytes: int, flops: int, peak: float = F32_FLOPS):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and the
    operations over the card's peak for their type (float32 by default)."""
    t_b = nbytes / HBM_BPS * 1e3
    t_o = flops / peak * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class phase:
    """Context manager printing a phase's seconds when it ends."""

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            print(f"[{self.name}] phase done in {time.perf_counter() - self.t0:.1f} s",
                  flush=True)
        return False


# ---------------------------------------------------------------------------
# phase 1: device
# ---------------------------------------------------------------------------
def phase_device() -> str:
    if not torch.cuda.is_available():
        print("FAIL: torch.cuda.is_available() is False; this smoke test needs a "
              "CUDA card", flush=True)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[device] {torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}; "
          f"torch {torch.__version__} cuda {torch.version.cuda}; TF32 off for "
          "float32 matmul and cuDNN (allow_tf32 = False)", flush=True)
    return card


# ---------------------------------------------------------------------------
# phase 2: build
# ---------------------------------------------------------------------------
def phase_build() -> None:
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    spent = build.build()
    for name in build.SOURCES:
        build.library(name)
    each = ", ".join(f"{n} {t:.1f} s" for n, t in sorted(build.source_build_s.items()))
    print(f"[build] {len(build.SOURCES)} libraries for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s (nvcc {spent:.1f} s, parallel: {each})",
          flush=True)


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version at the serving shapes
# ---------------------------------------------------------------------------
def _close(name: str, got, want, rtol: float, atol: float) -> float:
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    bad = int((err > lim).sum())
    check(bad == 0, f"{name}: {bad} elements outside rtol={rtol} atol={atol} "
                    f"(max abs err {float(err.max()):.3e})")
    return float(err.max())


def _topk_ok(name: str, idx, want_idx, want_probs) -> None:
    """idx must equal the plain version's except where the plain version's
    top-k gap (between the selected value and the next candidate) is below
    1e-6, where float32 summation order may legitimately flip the pick."""
    if torch.equal(idx, want_idx):
        return
    probs = want_probs.sort(dim=-1, descending=True).values
    k = want_idx.shape[-1]
    gaps = (probs[..., :k] - probs[..., 1:k + 1]).abs().min(dim=-1).values
    rows = (idx != want_idx).any(dim=-1)
    check(bool((gaps[rows] < 1e-6).all()),
          f"{name}: top-k indices differ where the gap exceeds 1e-6")


def phase_kernels(dev) -> list:
    g = torch.Generator(device=dev).manual_seed(SEED)
    rows = _gating_rows(dev, g)

    rows += _grouped_rows(dev, g)
    _other_instantiations(dev, g)
    rows.append(_grouped_matmul_row(dev, g))
    _slot_faults()
    rows.append(_paged_decode_row(dev, g))
    rows.append(_paged_decode_g6_row(dev, g))
    return rows


# logits: float32 sums over D in another order than the plain version's
GATING_TOL = dict(rtol=1e-5, atol=1e-5)
# the cluster sizes timed at the serving shapes: every portable one
GATING_SWEEP = tuple(range(1, 9))


def _gating_call(op, x, gates, k, ranks=None):
    """One router kernel call: the wrapper, or with the cluster size forced
    to `ranks`; a tuple of outputs either way."""
    from repro_torch.kernels import ops
    if ranks is None:
        out = ops.gating_topk(x, gates, top_k=k) if op == "gating_topk" \
            else ops.stacked_gating(x, gates)
    else:
        out = ops._gating_at(ranks, x, gates, top_k=k if op == "gating_topk" else None)
    return out if isinstance(out, tuple) else (out,)


def _gating_check(name, op, x, gates, k, ranks=None) -> float:
    """Max abs error of one call against the plain version: logits at
    GATING_TOL; for gating_topk also vals (atol 1e-6) and idx (exact unless
    the top-k gap is under 1e-6)."""
    from repro_torch.kernels import ref
    got = _gating_call(op, x, gates, k, ranks)
    if op == "stacked_gating":
        want = ref.stacked_gating_ref(x, gates)
        torch.cuda.synchronize()
        return _close(f"{name} logits", got[0], want, **GATING_TOL)
    rl, rv, ri = ref.gating_topk_ref(x, gates, top_k=k)
    torch.cuda.synchronize()
    check(got[2].dtype == torch.int32, f"{name}: idx is {got[2].dtype}")
    err = max(_close(f"{name} logits", got[0], rl, **GATING_TOL),
              _close(f"{name} vals", got[1], rv, 1e-5, 1e-6))
    _topk_ok(name, got[2], ri, ref.softmax_last(rl))
    return err


def _gating_same(name, op, x, gates, k) -> None:
    """Two calls of the wrapper give bit-identical outputs."""
    a = _gating_call(op, x, gates, k)
    b = _gating_call(op, x, gates, k)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(a, b)), f"{name}: two calls differ")


def _gating_gates(dev, g, p, d, e, *, aligned=True):
    """Seeded routers (P, D, E) / sqrt(D); `aligned` False puts them, still
    contiguous, one float into their storage (4-byte loads)."""
    gates = torch.randn((p, d, e), generator=g, device=dev) / math.sqrt(d)
    if not aligned:
        buf = torch.empty(gates.numel() + 1, device=dev)
        buf[1:].copy_(gates.reshape(-1))
        gates = buf[1:].view(p, d, e)
    return gates


def _gating_rows(dev, g) -> list:
    """Both router kernels at the serving path's shapes (Mixtral-8x7B: D
    4096, E 8; gating_topk over bf16 x at B = 1-4 with K 2, stacked_gating
    over float32 x at B = 1 with P = 1, 2 (the per-expert path's one-row
    calls) and at the serve batch B = 4 with P = 2, at E 8 and at
    Phi-3.5-MoE's E 16 (the grouped path's one call per MoE layer, in its
    captured segment)), through the wrappers, against the plain versions;
    two calls bit-identical.  Timed twice each, between two timings of the
    launch floor (a one-element fill, timed the same way), beside
    torch.einsum for stacked_gating.  Then the cluster size swept at the
    serving shapes (``ops._gating_at``), and the edge variants
    (E 1-256, K 1-6, B 1-17, P 2-3, ragged and tiny D, float32 x, unaligned
    gates, tied logits; the wrapper's cluster size 1-8) through the
    wrappers, each bit-identical over two calls.  The kernel's layout
    constants must equal ops.py's mirror."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    layout = ops.gating_layout()
    mirror = {n: getattr(ops, n) for n in layout}
    check(layout == mirror, f"gating.cu's layout {layout} != ops.py's {mirror}")
    print(f"[kernels] gating layout (gating.cu = ops.py): {layout}", flush=True)
    cfg = get_config(ARCH)
    d, e, k = cfg.d_model, cfg.moe.num_experts, cfg.moe.top_k
    one = torch.zeros(1, device=dev)
    floor = [graph_ms(lambda: one.fill_(1.0))]
    gates = _gating_gates(dev, g, 1, d, e)
    stack = _gating_gates(dev, g, 2, d, e)
    cases = [("gating_topk", f"B={b}", torch.randn((b, d), generator=g, device=dev)
              .to(torch.bfloat16), gates, k) for b in (1, 2, 3, 4)]
    x1 = torch.randn((1, d), generator=g, device=dev)
    cases += [("stacked_gating", f"P={p}", x1, stack[:p], None) for p in (1, 2)]
    xb = torch.randn((SERVE_BATCH, d), generator=g, device=dev)
    cases += [("stacked_gating", f"B={SERVE_BATCH} P=2{'' if ee == e else f' E={ee}'}", xb, gt,
               None) for ee, gt in ((e, stack), (16, _gating_gates(dev, g, 2, d, 16)))]
    shapes = {"gating_topk": {}, "stacked_gating": {}}
    err = {"gating_topk": 0.0, "stacked_gating": 0.0}
    same = []
    for op, label, x, gt, kk in cases:
        name = f"{op} {label}"
        err[op] = max(err[op], _gating_check(name, op, x, gt, kk))
        _gating_same(name, op, x, gt, kk)
        same.append(name)

        def new():
            return _gating_call(op, x, gt, kk)

        runs = [graph_ms(new), graph_ms(new)]
        ms = sum(runs) / 2
        call = cuda_ms(new)
        if op == "gating_topk":
            plain = cuda_ms(lambda: ref.gating_topk_ref(x, gt, top_k=kk))
            lib = None
        else:
            plain = cuda_ms(lambda: ref.stacked_gating_ref(x, gt))
            lib = graph_ms(lambda: torch.einsum("bd,pde->pbe", x, gt))
        p, b, ee = gt.shape[0], x.shape[0], gt.shape[2]
        out = new()
        bms, by = bound(nbytes(x, gt, *out), 2 * p * b * d * ee)
        plan = ops.gating_plan(d, ee, b, vec=gt.data_ptr() % 16 == 0)
        bf = int(x.dtype == torch.bfloat16)
        regs = ops.gating_regs(bf, op == "gating_topk", plan.vec, b)
        shapes[op][label] = dict(
            p=p, b=b, d=d, e=ee, k=kk, x=str(x.dtype)[6:], ms=ms, ms_runs=runs, call_ms=call,
            plain_ms=plain, library_ms=lib, bound_ms=bms, bound_by=by, cluster=plan.ranks,
            slice=plan.slice, blocks=plan.ranks * p, regs=regs)
        lib_s = f", torch.einsum {lib:.4f} ms on the card" if lib is not None else ""
        print(f"[kernels] {name}: cluster kernel (cluster of {plan.ranks} x {p} routers, "
              f"{plan.slice} rows of D per rank, {ops.GATING_THREADS} threads, {regs} "
              f"registers) {runs[0]:.4f} / {runs[1]:.4f} ms on the card{lib_s}; {call:.4f} "
              f"ms per call from Python (plain {plain:.4f} ms per call); bound {bms:.6f} ms "
              f"by {by}", flush=True)
    floor.append(graph_ms(lambda: one.fill_(1.0)))
    print(f"[kernels] gating launch floor (a one-element fill, graph replays): "
          f"{floor[0]:.4f} / {floor[1]:.4f} ms", flush=True)

    sweep = {}
    for op, label, x, gt, kk in (cases[0], cases[3], cases[5], cases[6]):
        name = f"{op} {label}"
        sweep[name] = {}
        for c in GATING_SWEEP:
            err[op] = max(err[op], _gating_check(f"{name} cluster {c}", op, x, gt, kk, ranks=c))
            sweep[name][c] = graph_ms(lambda: _gating_call(op, x, gt, kk, c))
        chosen = ops.gating_plan(d, gt.shape[2], x.shape[0]).ranks
        each = " ".join(f"{c}: {t:.4f}" for c, t in sweep[name].items())
        print(f"[kernels] {name} by cluster size, ms on the card: {each}; the wrapper "
              f"picks {chosen}", flush=True)

    # (B, D, E, K, P, x dtype, gates aligned, tied columns)
    bf, f32 = torch.bfloat16, torch.float32
    edges = [(1, 4096, 1, 1, 1, bf, True, False), (3, 4096, 2, 2, 1, bf, True, False),
             (5, 4097, 3, 2, 1, bf, True, False), (2, 2048, 6, 6, 1, f32, True, False),
             (9, 4096, 8, 2, 1, bf, True, False), (17, 4096, 8, 2, 1, f32, True, False),
             (6, 4096, 16, 6, 1, bf, True, False), (7, 5120, 60, 2, 1, bf, True, False),
             (8, 5120, 64, 6, 3, bf, True, False), (4, 2048, 128, 2, 1, f32, True, False),
             (9, 5120, 160, 6, 1, bf, True, False), (2, 4096, 160, 1, 1, f32, True, False),
             (3, 7168, 256, 6, 1, bf, True, False), (1, 100, 8, 2, 1, bf, True, False),
             (2, 5, 16, 3, 1, f32, True, False), (1, 14336, 8, 2, 1, bf, True, False),
             (4, 4096, 8, 2, 1, bf, False, False), (9, 2048, 256, 2, 1, f32, False, False),
             (4, 4096, 8, 3, 1, bf, True, True), (9, 2048, 160, 6, 1, bf, True, True),
             (1, 1024, 8, 2, 1, f32, True, False), (2, 1100, 8, 2, 1, bf, True, False),
             (3, 2560, 8, 2, 2, f32, True, False), (1, 3000, 8, 2, 1, bf, True, False),
             (5, 3500, 8, 2, 1, bf, True, False)]
    variants = []
    picked = set()
    for b, dd, ee, kk, p, dt, aligned, tied in edges:
        gt = _gating_gates(dev, g, p, dd, ee, aligned=aligned)
        picked.add(ops.gating_plan(dd, ee, b, vec=gt.data_ptr() % 16 == 0).ranks)
        x = torch.randn((b, dd), generator=g, device=dev)
        if tied:
            gt[:, :, 5] = gt[:, :, 2]
            gt[:, :, 7] = gt[:, :, 2]
            x += 8.0 * gt[0, :, 2][None, :] / gt[0, :, 2].square().sum()
        x = x.to(dt)
        label = (f"B={b} D={dd} E={ee} K={kk} P={p} {str(dt)[6:]}"
                 f"{'' if aligned else ' unaligned gates'}{' tied' if tied else ''}")
        for op in ("gating_topk", "stacked_gating"):
            err[op] = max(err[op], _gating_check(f"{op} {label}", op, x, gt, kk))
            _gating_same(f"{op} {label}", op, x, gt, kk)
        if tied:
            lg, _, idx = ops.gating_topk(x, gt, top_k=kk)
            check(bool((lg[..., 2] == lg[..., 5]).all() and (lg[..., 2] == lg[..., 7]).all()),
                  f"gating_topk {label}: tied columns differ")
            check(bool((idx[..., :3].cpu() == torch.tensor([2, 5, 7], dtype=torch.int32)).all()),
                  f"gating_topk {label}: ties not taken lowest index first")
        variants.append(label)
        same.append(label)
    check(picked == set(GATING_SWEEP), f"edge variants' cluster sizes {sorted(picked)}")
    print(f"[kernels] gating: {len(variants)} edge variants agree with the plain versions "
          f"through both wrappers, at cluster sizes {sorted(picked)}: {'; '.join(variants)}",
          flush=True)
    print(f"[kernels] gating: two calls gave bit-identical outputs at {len(same)} shapes",
          flush=True)
    out = []
    for op, label, line in (("gating_topk", "B=4", "stacked_gating.py:113"),
                            ("stacked_gating", f"B={SERVE_BATCH} P=2", "stacked_gating.py:53")):
        a = shapes[op][label]
        out.append(dict(
            name=op, route="cuda", source="src/repro_torch/kernels/csrc/gating.cu",
            replaces=f"src/repro/kernels/{line}", max_abs_err=err[op], ms=a["ms"],
            call_ms=a["call_ms"], plain_ms=a["plain_ms"], bound_ms=a["bound_ms"],
            bound_by=a["bound_by"], library_ms=a["library_ms"],
            launch_floor_ms=floor, cluster=a["cluster"], regs=a["regs"], shapes=shapes[op],
            note=f"ms and bound at {label}",
            cluster_sweep_ms={n: s for n, s in sweep.items() if n.startswith(op)},
            variants=len(variants), bit_identical=len(same),
            tolerance="rtol 1e-5 atol 1e-5" + ("; vals atol 1e-6; idx exact unless gap "
                                               "< 1e-6" if op == "gating_topk" else "")))
    return out


def phase_kernels_dense(dev) -> list:
    """Phases 3c, 3d, 3e, 3f and 3g: the dense dequant-matmul and the
    contiguous flash-decode kernels, then the dequant-matmul at Gemma-2-27B's
    FFN, at DeepSeek-V2-236B's dense and shared FFN and at Jamba's dense
    FFN."""
    g = torch.Generator(device=dev).manual_seed(SEED + 10)
    with phase("kernels-3c"):
        dq = _dequant_matmul_row(dev, g)
        dq_n = _dq_ffn(dev, g, NEMOTRON, "nemotron")
    torch.cuda.empty_cache()
    with phase("kernels-3d"):
        fd = _flash_decode_row(dev, g)
        fd6 = _flash_decode_g6_row(dev, g)
    torch.cuda.empty_cache()
    with phase("kernels-3e"):
        dq_g = _dq_ffn(dev, g, GEMMA2, "gemma2")
    torch.cuda.empty_cache()
    with phase("kernels-3f"):
        dq_d = _dq_ffn(dev, g, DEEPSEEK, "deepseek")
    torch.cuda.empty_cache()
    with phase("kernels-3g"):
        dq_j = _dq_ffn(dev, g, JAMBA, "jamba")
    torch.cuda.empty_cache()
    return [dq, dq_n, fd, fd6, dq_g, dq_d, dq_j]


# ---------------------------------------------------------------------------
# phase 3, rows 3-4: the grouped lo-expert pair at Mixtral's expert shapes
# ---------------------------------------------------------------------------
# float32 sums over K <= 14336 in another order than the plain version's
GROUPED_TOL = dict(rtol=1e-4, atol=1e-3)
# pair counts as the serve launches them (its lo_pairs_per_launch: 1-5, and
# up to 8 at batch 4): name -> (token rows B, each pair's row, each pair's
# pool slot).  P = 8 carries one pad (row B, weight 0) on a slot of its own
# and a row no pair visits (row 2); "P=2 one slot" is two token rows'
# pairs on one slot.
GROUPED_CASES = {
    "P=1": (1, [0], [0]), "P=2": (1, [0, 0], [1, 0]), "P=3": (2, [0, 0, 1], [2, 0, 1]),
    "P=4": (2, [0, 0, 1, 1], [3, 1, 0, 2]), "P=5": (3, [0, 0, 1, 1, 2], [4, 2, 0, 3, 1]),
    "P=8": (4, [0, 0, 1, 1, 3, 3, 3, 4], [5, 2, 7, 0, 3, 6, 1, 4]),
    "P=2 one slot": (1, [0, 0], [0, 0]),
}


def _grouped_pools(dev, g, slots, k, n, bits=4, group=64):
    """Seeded pools (data, scale) of `slots` experts (random codes, scales
    in [0, 0.02)), enough copies that cycling through them moves over twice
    the card's 50 MB L2: each timed launch finds its experts cold, as a
    decode step does."""
    from repro_torch.quant.quantize import PACK_FACTOR
    per = slots * (k // PACK_FACTOR[bits] * n + k // group * n * 4)
    return [(torch.randint(-128, 128, (slots, k // PACK_FACTOR[bits], n), generator=g,
                           device=dev, dtype=torch.int8),
             torch.rand((slots, k // group, n), generator=g, device=dev) * 0.02)
            for _ in range(max(2, -(-L2_CYCLE_BYTES // per)))]


def _grouped_call(op, x, data, scale, slot, rows=None, w=None, num_rows=None, *, bits=4,
                  group=64, ranks=None):
    """One call of the op through its wrapper, or through the tensor-core
    kernel with its cluster size forced."""
    from repro_torch.kernels import ops
    kw = dict(bits=bits, group_size=group)
    if op == "grouped_dequant_combine":
        kw["num_rows"] = num_rows
    if ranks is not None:
        return ops._grouped_at(ranks, x, data, scale, slot, rows, w, **kw)
    if op == "grouped_dequant_combine":
        return ops.grouped_dequant_combine(x, data, scale, slot, rows, w, **kw)
    return ops.grouped_dequant_matmul(x, data, scale, slot, **kw)


def _grouped_check(name, op, x, data, scale, slot, rows=None, w=None, num_rows=None, *,
                   bits=4, group=64, ranks=None, want_kernel=None):
    """(max abs error against the plain version, the kernel that ran): two
    calls must be bit-identical, rows no pair visits exact zeros, and the
    kernel the one named by `want_kernel` when given."""
    from repro_torch.kernels import ops, ref
    before = ops.grouped_launches()
    got = _grouped_call(op, x, data, scale, slot, rows, w, num_rows, bits=bits, group=group,
                        ranks=ranks)
    after = ops.grouped_launches()
    ran = [key.split(".")[1] for key in after if after[key] != before.get(key, 0)]
    check(len(ran) == 1, f"{name}: launched {ran}, not one grouped kernel")
    again = _grouped_call(op, x, data, scale, slot, rows, w, num_rows, bits=bits, group=group,
                          ranks=ranks)
    kw = dict(bits=bits, group_size=group)
    if op == "grouped_dequant_combine":
        want = ref.grouped_dequant_combine_ref(x, data, scale, slot, rows, w,
                                               num_rows=num_rows, **kw)
    else:
        want = ref.grouped_dequant_matmul_ref(x, data, scale, slot, **kw)
    torch.cuda.synchronize()
    check(tuple(got.shape) == tuple(want.shape), f"{name}: shape {tuple(got.shape)}")
    check(torch.equal(got, again), f"{name}: two calls differ")
    if op == "grouped_dequant_combine":
        for r in range(num_rows):
            if r not in rows.tolist():
                check(bool((got[r] == 0).all()), f"{name}: unvisited row {r} not zero")
    if want_kernel is not None:
        check(ran[0] == want_kernel, f"{name}: ran the {ran[0]} kernel, not {want_kernel}")
    return _close(f"{name} ({ran[0]})", got, want, **GROUPED_TOL), ran[0]


def _grouped_rows(dev, g) -> list:
    """Both ops at Mixtral-8x7B's expert shapes (the matmul over wi, K 4096
    -> N 28672; the combine over wo, K 14336 -> N 4096; 4-bit codes, group
    64, bf16 x), at every P of GROUPED_CASES, through the wrappers, against
    the plain versions, two calls bit-identical, every launch on the
    tensor-core kernel.  Timed with the pool cold in L2; the bound counts
    each distinct live slot's codes and scales once (a pad's slot is not
    read).  Then the tensor-core kernel by cluster size (wo 1-8, wi 1-2)
    at P = 1, and the layout constants held to ops.py's mirror."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.quantize import PACK_FACTOR

    layout = ops.grouped_layout()
    mirror = {n: getattr(ops, n) for n in layout}
    check(layout == mirror, f"dequant.cu's grouped layout {layout} != ops.py's {mirror}")
    cfg = get_config(ARCH)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    bits, gs = 4, 64                      # EngineConfig defaults (lo_bits, group)
    pack = PACK_FACTOR[bits]
    out = []
    for op in ("grouped_dequant_matmul", "grouped_dequant_combine"):
        k, n = (d, 2 * f) if op == "grouped_dequant_matmul" else (f, d)
        combine = op == "grouped_dequant_combine"
        plan = ops._grouped_plan_for(k, n, gs, bits, combine, dev)
        info = ops.grouped_info(bits, combine, gs)
        err, by_p = 0.0, {}
        for name, (b, r, sl) in GROUPED_CASES.items():
            p = len(r)
            pools = _grouped_pools(dev, g, max(sl) + 1, k, n)
            data, scale = pools[0]
            slot = torch.tensor(sl, dtype=torch.int32, device=dev)
            x = torch.randn((p, k), generator=g, device=dev).to(torch.bfloat16)
            rws = torch.tensor(r, dtype=torch.int32, device=dev) if combine else None
            w = None
            if combine:
                w = torch.rand((p,), generator=g, device=dev)
                w[rws == b] = 0.0
            label = f"{op} {name} B={b}"
            e, _ = _grouped_check(label, op, x, data, scale, slot, rws, w, b,
                                  want_kernel="mmv")
            err = max(err, e)
            calls = [lambda dt=dt, sc=sc: _grouped_call(op, x, dt, sc, slot, rws, w, b)
                     for dt, sc in pools]
            ms = graph_ms(_cycling(calls))
            call = cuda_ms(calls[0])
            plain = cuda_ms(
                (lambda: ref.grouped_dequant_combine_ref(x, data, scale, slot, rws, w,
                                                         bits=bits, group_size=gs, num_rows=b))
                if combine else
                (lambda: ref.grouped_dequant_matmul_ref(x, data, scale, slot, bits=bits,
                                                        group_size=gs)), warmup=1, iters=5)
            live = [s_ for s_, rr in zip(sl, r) if not combine or rr < b]
            y = calls[0]()
            moved = (nbytes(x, slot, y, *((rws, w) if combine else ()))
                     + len(set(live)) * (k // pack * n + k // gs * n * 4))
            bms, by = bound(moved, 2 * len(live) * k * n, BF16_FLOPS)
            by_p[name] = dict(b=b, p=p, slots=len(set(live)), ms=ms, call_ms=call,
                              plain_ms=plain, bound_ms=bms, bound_by=by, of_bound=bms / ms,
                              gbps=moved / ms / 1e6, pool_copies=len(pools))
            print(f"[kernels] {label}: {ms:.4f} ms on the card, L2 cold ({moved / ms / 1e6:.0f} "
                  f"GB/s; {len(set(live))} distinct live slots; bound {bms:.4f} ms by {by}, "
                  f"{bms / ms:.0%} of it), {call:.4f} ms per call (plain {plain:.3f} ms per call)",
                  flush=True)
            del pools, data, scale, calls, y
            torch.cuda.empty_cache()
        # the tensor-core kernel by cluster size at P = 1
        pools = _grouped_pools(dev, g, 1, k, n)
        x = torch.randn((1, k), generator=g, device=dev).to(torch.bfloat16)
        slot = torch.zeros(1, dtype=torch.int32, device=dev)
        rws = torch.zeros(1, dtype=torch.int32, device=dev) if combine else None
        w = torch.ones(1, device=dev) if combine else None
        sweep = {}
        tiles = -(-n // ops.GROUPED_TILE_N)
        for ranks in range(1, 9 if n <= 4096 else 3):
            e, _ = _grouped_check(f"{op} P=1 cluster {ranks}", op, x, *pools[0], slot, rws, w,
                                  1, ranks=ranks)
            err = max(err, e)
            calls = [lambda dt=dt, sc=sc: _grouped_call(op, x, dt, sc, slot, rws, w, 1,
                                                       ranks=ranks)
                     for dt, sc in pools]
            sweep[ranks] = graph_ms(_cycling(calls))
        each = " ".join(f"{key}: {t:.4f}" for key, t in sweep.items())
        print(f"[kernels] {op} P=1 by cluster size, ms on the card (L2 cold): {each}; "
              f"the wrapper picks {plan.ranks} ({tiles} column tiles, "
              f"{plan.blocks_per_sm} blocks/SM, clusters that fit at once {info.clusters}); "
              f"{info.smem} bytes of dynamic shared memory per block, {info.regs} registers, "
              f"{info.local_bytes} bytes of local memory per thread", flush=True)
        del pools
        torch.cuda.empty_cache()
        line = "dequant_matmul.py:145" if op == "grouped_dequant_matmul" \
            else "dequant_matmul.py:210"
        head = by_p["P=8"]
        out.append(dict(name=op, route="cuda", source="src/repro_torch/kernels/csrc/dequant.cu",
                        replaces=f"src/repro/kernels/{line}", max_abs_err=err, ms=head["ms"],
                        call_ms=head["call_ms"], plain_ms=head["plain_ms"],
                        bound_ms=head["bound_ms"], bound_by=head["bound_by"], library_ms=None,
                        kernel="mmv", cluster=plan.ranks, blocks_per_sm=plan.blocks_per_sm,
                        smem=info.smem, regs=info.regs, local_bytes=info.local_bytes,
                        tolerance="rtol 1e-4 atol 1e-3", by_pairs=by_p, sweep_ms=sweep,
                        note="ms, bounds and the plain time at P = 8; every P under "
                             "by_pairs; L2 cold"))
    return out


def _other_instantiations(dev, g) -> None:
    """Every compiled variant the serving shapes above do not reach, against
    the plain versions at small shapes, untimed: the routers at Phi-MoE's 16
    experts and float32 x; the grouped pair at bits 8/4/2 and float32/bf16
    x, pads, pads only and a row no pair visits, pairs sharing a slot,
    passes of more than 8 pairs, groups 8-256, ragged N, unaligned x, and
    shapes that make the planner choose every cluster size 1-8; each
    grouped variant bit-identical over two calls and on the kernel the
    shape rule names (``ops.grouped_dequant_kernel``)."""
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.quantize import PACK_FACTOR

    n_checked = 0
    for e in (8, 16):
        for dt in (torch.float32, torch.bfloat16):
            x = torch.randn((3, 512), generator=g, device=dev).to(dt)
            gates = torch.randn((2, 512, e), generator=g, device=dev) / 16
            lg, vals, idx = ops.gating_topk(x, gates, top_k=2)
            rl, rv, ri = ref.gating_topk_ref(x, gates, top_k=2)
            _close("gating_topk", lg, rl, 1e-5, 1e-5)
            _close("gating_topk", vals, rv, 1e-5, 1e-6)
            _topk_ok("gating_topk", idx, ri, ref.softmax_last(rl))
            _close("stacked_gating", ops.stacked_gating(x, gates),
                   ref.stacked_gating_ref(x, gates), 1e-5, 1e-5)
            n_checked += 2

    def pool(s_, k, n, bits, gs):
        return (torch.randint(-128, 128, (s_, k // PACK_FACTOR[bits], n), generator=g,
                              device=dev, dtype=torch.int8),
                torch.rand((s_, k // gs, n), generator=g, device=dev) * 0.05)

    def x_of(p, k, dt=torch.bfloat16, offset=False):
        x = torch.randn((p, k), generator=g, device=dev).to(dt)
        if offset:                         # contiguous, one element into its storage
            buf = torch.empty(x.numel() + 1, dtype=dt, device=dev)
            buf[1:].copy_(x.reshape(-1))
            x = buf[1:].view(x.shape)
        return x

    # (label, K, N, bits, group, slots, rows (None: the matmul), num_rows, x dtype,
    #  x unaligned, the kernel the shape rule names)
    bf, f32 = torch.bfloat16, torch.float32
    cases = []
    for bits in (8, 4, 2):
        for dt in (f32, bf):
            kern = "mmv" if dt == bf else "two_pass"
            cases += [(f"bits {bits} {str(dt)[6:]} shared slot", 512, 256, bits, 64, [2, 0, 2],
                       None, None, dt, False, kern),
                      (f"bits {bits} {str(dt)[6:]} pad + unvisited row", 512, 256, bits, 64,
                       [2, 0, 2], [0, 0, 3], 3, dt, False, kern),
                      (f"bits {bits} {str(dt)[6:]} pads only", 512, 256, bits, 64, [2, 0, 2],
                       [3, 3, 3], 3, dt, False, kern)]
    cases += [(f"group {gs}", 3072, 384, 4, gs, [1, 0, 1, 3], None, None, bf, False,
               "mmv" if gs % 16 == 0 else "two_pass") for gs in (8, 16, 32, 48, 128, 256)]
    cases += [("group 16 bits 2 combine", 1024, 256, 2, 16, [0, 1, 1], [0, 1, 1], 2, bf, False,
               "mmv"),
              ("ragged N=272", 512, 272, 4, 64, [0, 1], None, None, bf, False, "mmv"),
              ("ragged N=272 combine", 512, 272, 4, 64, [0, 1], [0, 0], 1, bf, False, "mmv"),
              ("unaligned x", 512, 256, 4, 64, [0, 1], None, None, bf, True, "two_pass"),
              ("P=11 shared slots", 1024, 256, 4, 64, [4, 0, 4, 1, 2, 2, 3, 0, 5, 5, 1], None,
               None, bf, False, "mmv"),
              ("P=19 combine over 3 passes", 1024, 256, 4, 64, [i % 5 for i in range(19)],
               [i // 3 for i in range(19)], 7, bf, False, "mmv"),
              ("P=9 combine, pads and shared slots", 1024, 512, 8, 64,
               [3, 3, 0, 1, 0, 2, 2, 3, 1], [0, 0, 1, 1, 1, 3, 4, 4, 4], 4, bf, False, "mmv")]
    # K of c groups caps the cluster at c (N = 256: two column tiles)
    picked = set()
    for c in range(1, 9):
        cases.append((f"K of {c} groups", 64 * c, 256, 4, 64, [1, 0], [0, 1], 2, bf, False,
                      "mmv"))
        picked.add(ops._grouped_plan_for(64 * c, 256, 64, 4, True, dev).ranks)
    check(picked == set(range(1, 9)), f"edge variants' cluster sizes {sorted(picked)}")
    labels = []
    for label, k, n, bits, gs, sl, r, nr, dt, off, kern in cases:
        data, scale = pool(max(sl) + 1, k, n, bits, gs)
        x = x_of(len(sl), k, dt, off)
        slot = torch.tensor(sl, dtype=torch.int32, device=dev)
        op = "grouped_dequant_matmul" if r is None else "grouped_dequant_combine"
        rows = w = None
        if r is not None:
            rows = torch.tensor(r, dtype=torch.int32, device=dev)
            w = torch.rand((len(sl),), generator=g, device=dev)
            w[rows >= nr] = 0.0
        _, ran = _grouped_check(f"{op} {label}", op, x, data, scale, slot, rows, w, nr,
                                bits=bits, group=gs, want_kernel=kern)
        labels.append(f"{label} ({op[16:]}, {ran})")
        n_checked += 1
    torch.cuda.synchronize()
    print(f"[kernels] {n_checked} further variants agree with the plain versions (routers: E "
          f"8/16, f32/bf16 x; grouped pair, bit-identical over two calls, at cluster sizes "
          f"{sorted(picked)}: {'; '.join(labels)})", flush=True)


# ---------------------------------------------------------------------------
# phase 3, the grouped bf16 GEMV of the hi experts (no TPU kernel: the
# reference's jitted hi einsum, src/repro/core/engine.py:437-438)
# ---------------------------------------------------------------------------
# float32 sums over K <= 14336 in another order than the plain version's
GMM_TOL = dict(rtol=1e-4, atol=1e-4)
# pairs as the engine's fixed-shape FFN launches them: name -> each pair's
# pool slot; pads repeat the last real pair's slot ("8 pairs, 6 pads": two
# real pairs at batch 4, top-2)
GMM_CASES = {
    "P=1": [0], "P=2": [0, 1], "P=4": [0, 1, 2, 3], "P=8": list(range(8)),
    "2 pairs on 1 slot": [0, 0], "8 pairs, 6 pads": [0, 1, 1, 1, 1, 1, 1, 1],
}


def _gmm_check(name, x, w, slot) -> float:
    """Max abs error of ``grouped_matmul`` against its plain version; two
    calls must be bit-identical and launch one kernel each."""
    from repro_torch.kernels import ops, ref
    before = ops.dispatch_counts().get("grouped_matmul.cuda", 0)
    got = ops.grouped_matmul(x, w, slot)
    again = ops.grouped_matmul(x, w, slot)
    torch.cuda.synchronize()
    check(ops.dispatch_counts().get("grouped_matmul.cuda", 0) == before + 2,
          f"grouped_matmul {name}: not one launch per call")
    check(torch.equal(got, again), f"grouped_matmul {name}: two calls differ")
    want = ref.grouped_matmul_ref(x, w, slot)
    check(tuple(got.shape) == tuple(want.shape), f"grouped_matmul {name}: shape")
    return _close(f"grouped_matmul {name}", got, want, **GMM_TOL)


def _grouped_matmul_row(dev, g) -> dict:
    """``grouped_matmul`` at Mixtral-8x7B's hi-expert shapes (wi 4096 ->
    28672, wo 14336 -> 4096, bf16), at every P of GMM_CASES, against the
    plain version; timed from CUDA-graph replays with two pool copies in
    turn (each expert matrix is larger than the 50 MB L2 anyway), beside
    the bytes bound over the distinct slots, ``torch.matmul`` on one pool
    view (M = 1) and P such products in one graph (the yardstick at every
    P), with the plan (ranks, clusters) and the schedule's weight tiles per
    SM.  Then edge variants at small shapes (float32, ragged N, K off the
    ring's stage, more than 8 pairs on a slot, the 1024-pair maximum), and
    the layout constants held to ops.py's mirror."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref

    layout = ops.grouped_matmul_layout()
    mirror = {n: getattr(ops, n) for n in layout}
    check(layout == mirror, f"grouped_matmul.cu's layout {layout} != ops.py's {mirror}")
    cfg = get_config(ARCH)
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    err, by_shape = 0.0, {}
    for wname, (k, n) in (("wi", (d, 2 * f)), ("wo", (f, d))):
        by_p = {}
        for name, sl in GMM_CASES.items():
            p, s_ = len(sl), max(sl) + 1
            pools = [(torch.randn((s_, k, n), generator=g, device=dev) * 0.02).to(torch.bfloat16)
                     for _ in range(2)]
            x = torch.randn((p, k), generator=g, device=dev).to(torch.bfloat16)
            slot = torch.tensor(sl, dtype=torch.int32, device=dev)
            err = max(err, _gmm_check(f"{wname} {name}", x, pools[0], slot))
            calls = [lambda w=w: ops.grouped_matmul(x, w, slot) for w in pools]
            ms = graph_ms(_cycling(calls))
            call = cuda_ms(calls[0])
            plain = cuda_ms(lambda: ref.grouped_matmul_ref(x, pools[0], slot), warmup=1, iters=3)
            # P products, each on its pair's pool view, as one graph would run them
            views = [lambda w=w: [torch.matmul(x[i:i + 1], w[sl[i]]) for i in range(p)]
                     for w in pools]
            matmul = graph_ms(_cycling(views))
            plan = ops._grouped_matmul_plan_for(k, n, p, dev)
            groups = len(ops.grouped_matmul_groups(sl))
            # each block's weight MB: its tiles by its rank's rows (edges included)
            mb = [sum(w for _, _, w, _, _ in work) * ops.GMM_TILE_N * plan.rows * 2 / 1e6
                  for work in ops.grouped_matmul_schedule(plan, groups)]
            distinct = len(set(sl))
            moved = nbytes(x, slot) + p * n * 4 + distinct * k * n * 2
            bms, by = bound(moved, 2 * p * k * n, BF16_FLOPS)
            by_p[name] = dict(p=p, slots=distinct, ms=ms, call_ms=call, plain_ms=plain,
                              matmul_ms=matmul, library_ms=matmul if p == 1 else None,
                              bound_ms=bms, bound_by=by, of_bound=bms / ms,
                              gbps=moved / ms / 1e6, ranks=plan.ranks, clusters=plan.clusters,
                              sm_mb_max=max(mb), sm_mb_min=min(mb))
            print(f"[kernels] grouped_matmul {wname} {name}: {ms:.4f} ms on the card "
                  f"({moved / ms / 1e6:.0f} GB/s; {distinct} distinct slots; bound {bms:.4f} ms "
                  f"by {by}, {bms / ms:.0%} of it), {call:.4f} ms per call, plain {plain:.3f} ms, "
                  f"torch.matmul on the pool views ({p} in one graph) {matmul:.4f} ms; "
                  f"{plan.ranks} ranks x {plan.clusters} clusters, weight MB per SM "
                  f"{min(mb):.2f}-{max(mb):.2f} over {len(mb)} blocks", flush=True)
            del pools, calls, views, x
            torch.cuda.empty_cache()
        by_shape[wname] = dict(k=k, n=n, by_pairs=by_p)
    info = ops.grouped_matmul_info(True, 8)
    print(f"[kernels] grouped_matmul: {info.regs} registers, {info.local_bytes} bytes of local "
          f"memory per thread, {info.blocks_per_sm} blocks/SM, {info.smem} bytes of shared "
          f"memory per block (bf16, 8 pairs); clusters at once by ranks {info.clusters}",
          flush=True)
    edges = []
    rng = np.random.default_rng(5)
    for label, k, n, sl, dt in (
            ("float32", 1024, 256, [0, 2, 2, 1], torch.float32),
            ("ragged N=264, K=1000", 1000, 264, [1, 1, 0], torch.bfloat16),
            ("float32 ragged N=132", 3000, 132, [0, 1], torch.float32),
            ("9 pairs on 1 slot", 512, 256, [2] * 9, torch.bfloat16),
            ("P=11 shared slots", 4096, 512, [4, 0, 4, 1, 2, 2, 3, 0, 5, 5, 1], torch.bfloat16),
            ("17 pairs on 1 slot, K=520, N=136", 520, 136, [3] * 17, torch.bfloat16),
            ("1024 pairs", 192, 200, rng.integers(0, 40, 1024).tolist(), torch.bfloat16),
            ("float32 1024 pairs", 192, 200, rng.integers(0, 40, 1024).tolist(),
             torch.float32)):
        x = torch.randn((len(sl), k), generator=g, device=dev).to(dt)
        w = (torch.randn((max(sl) + 1, k, n), generator=g, device=dev) * 0.05).to(dt)
        err = max(err, _gmm_check(label, x, w, torch.tensor(sl, dtype=torch.int32, device=dev)))
        edges.append(label)
    print(f"[kernels] grouped_matmul edge variants agree with the plain version, "
          f"bit-identical over two calls: {'; '.join(edges)}", flush=True)
    head = by_shape["wi"]["by_pairs"]["P=1"]
    return dict(name="grouped_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/grouped_matmul.cu",
                replaces="src/repro/core/engine.py:437 (not a TPU kernel: the reference's "
                         "jitted hi einsum)",
                max_abs_err=err, ms=head["ms"], call_ms=head["call_ms"],
                plain_ms=head["plain_ms"], bound_ms=head["bound_ms"],
                bound_by=head["bound_by"], library_ms=head["library_ms"],
                regs=info.regs, local_bytes=info.local_bytes, blocks_per_sm=info.blocks_per_sm,
                smem_bytes=info.smem, tolerance="rtol 1e-4 atol 1e-4", by_shape=by_shape,
                note="ms, bound, plain and torch.matmul at wi (4096 x 28672), P = 1; wo "
                     "and every P under by_shape")


# A child process calls one grouped wrapper with one pool slot out of range;
# the kernel must abort, so that synchronising raises.  It runs apart from
# this process because an aborted kernel leaves its CUDA context unusable.
_SLOT_FAULT_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import ops
op, bad = sys.argv[2], int(sys.argv[3])
dev = torch.device("cuda", 0)
data = torch.zeros((2, 256, 256), dtype=torch.int8, device=dev)
scale = torch.ones((2, 8, 256), device=dev)
x = torch.ones((2, 512), device=dev,
               dtype=torch.bfloat16 if sys.argv[4] == "bf16" else torch.float32)
slot = torch.tensor([0, bad], dtype=torch.int32, device=dev)
kw = dict(bits=4, group_size=64)
try:
    if op == "grouped_matmul":
        ops.grouped_matmul(x, torch.zeros((2, 512, 256), dtype=x.dtype, device=dev), slot)
    elif op == "grouped_dequant_matmul":
        ops.grouped_dequant_matmul(x, data, scale, slot, **kw)
    else:
        # the second pair is a pad (row == num_rows) when asked
        rows = torch.tensor([0, 2 if sys.argv[5] == "pad" else 1], dtype=torch.int32,
                            device=dev)
        ops.grouped_dequant_combine(x, data, scale, slot, rows,
                                    torch.ones(2, device=dev), num_rows=2, **kw)
    torch.cuda.synchronize()
except Exception as exc:  # a CUDA error, whichever class this torch gives it
    print("ABORTED:", type(exc).__name__, str(exc).strip().splitlines()[0],
          flush=True)
    os._exit(3)
print("NOT ABORTED", flush=True)
os._exit(0)
"""


def _slot_faults() -> None:
    """An out-of-range pool slot (past the end, and negative; a pad's too)
    must fail both grouped dequant kernels (bf16 x: the tensor-core kernel;
    float32 x: the two-pass kernel) and the grouped GEMV, as it makes the
    plain versions raise IndexError."""
    cases = (("grouped_matmul", 2, "bf16", "row"), ("grouped_matmul", -1, "f32", "row"),
             ("grouped_dequant_matmul", 2, "f32", "row"),
             ("grouped_dequant_combine", -1, "f32", "row"),
             ("grouped_dequant_matmul", 2, "bf16", "row"),
             ("grouped_dequant_combine", -1, "bf16", "row"),
             ("grouped_dequant_combine", 2, "bf16", "pad"))
    procs = [(f"{op} {dt} {kind}", bad, subprocess.Popen(
        [sys.executable, "-c", _SLOT_FAULT_CHILD, os.path.join(ROOT, "src"), op,
         str(bad), dt, kind], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        for op, bad, dt, kind in cases]
    for op, bad, proc in procs:
        try:
            out, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail(f"{op}: slot-fault check timed out")
        tail = out.strip().splitlines()[-1] if out.strip() else ""
        check(proc.returncode == 3 and tail.startswith("ABORTED"),
              f"{op} with slot {bad} of 2 did not abort (exit {proc.returncode}): {tail}")
        print(f"[kernels] {op} slot {bad} of 2: {tail}", flush=True)


# ---------------------------------------------------------------------------
# phase 3b: paged flash decode
# ---------------------------------------------------------------------------
PAGED_TOL = dict(rtol=1e-4, atol=1e-4)      # float32 sums in another order


def _paged_case(dev, g, b, hq, hkv, hd, psz, lengths, *, maxp=None, num_pages=None,
                dtype=torch.bfloat16):
    """Seeded q and K/V pages on the card; each slot's table row is a
    permuted, non-contiguous run of pages (maxp of them)."""
    maxp = maxp or max(1, -(-max(lengths) // psz))
    num_pages = num_pages or b * maxp
    q = torch.randn((b, hq, hd), generator=g, device=dev).to(dtype)
    pk = torch.randn((num_pages, psz, hkv, hd), generator=g, device=dev).to(dtype)
    pv = torch.randn((num_pages, psz, hkv, hd), generator=g, device=dev).to(dtype)
    perm = torch.randperm(num_pages, generator=g, device=dev)
    table = perm[: b * maxp].reshape(b, maxp).to(torch.int32).contiguous()
    ln = torch.tensor(lengths, dtype=torch.int32, device=dev)
    return q, pk, pv, table, ln


def _paged_check(name, args, softcap=0.0) -> float:
    from repro_torch.kernels import ops, ref
    got = ops.paged_flash_decode(*args, softcap=softcap)
    want = ref.paged_flash_decode_ref(*args, softcap=softcap)
    torch.cuda.synchronize()
    err = _close(name, got, want, **PAGED_TOL)
    for r, n in enumerate(args[4].tolist()):
        if n <= 0:
            check(bool((got[r] == 0).all()), f"{name}: length-0 row {r} is not exact zeros")
    return err


def _sdpa_call(q, pk, pv, table, lengths):
    """The yardstick: one scaled_dot_product_attention call on a dense view
    of the same K/V gathered beforehand (the gather is not timed)."""
    b, hq, hd = q.shape
    _, psz, hkv, _ = pk.shape
    s = table.shape[1] * psz
    kg = pk[table.long()].reshape(b, s, hkv, hd).transpose(1, 2).contiguous()
    vg = pv[table.long()].reshape(b, s, hkv, hd).transpose(1, 2).contiguous()
    mask = (torch.arange(s, device=q.device)[None, :] < lengths[:, None].long())
    # no mask where every slot fills its table: SDPA may then take its
    # fastest (flash) kernel
    mask = None if bool(mask.all()) else mask[:, None, None, :]
    q4 = q[:, :, None, :]
    F = torch.nn.functional
    try:
        F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask, enable_gqa=True)
        return lambda: F.scaled_dot_product_attention(q4, kg, vg, attn_mask=mask,
                                                      enable_gqa=True)
    except TypeError:       # a torch without enable_gqa: expand the heads first
        ke = kg.repeat_interleave(hq // hkv, dim=1)
        ve = vg.repeat_interleave(hq // hkv, dim=1)
        return lambda: F.scaled_dot_product_attention(q4, ke, ve, attn_mask=mask)


def _paged_bytes(q, pk, table, lengths, out) -> int:
    """K/V bytes of the tokens below each slot's length (at most the table's
    maxp * psz), read once, plus q, the table and lengths read and the output
    written.  Rows of a page past the length are never loaded."""
    _, psz, hkv, hd = pk.shape
    cap = table.shape[1] * psz
    tokens = sum(min(cap, max(n, 0)) for n in lengths.tolist())
    return 2 * tokens * hkv * hd * pk.element_size() + nbytes(q, table, lengths, out)


def _paged_shape(dev, g, label, b, lengths, hq, hkv, hd):
    """One timed shape of the paged kernel (64-token pages, bf16): checked
    against its plain version, two calls bit-identical, device ms from
    graph replays beside its bytes bound, the plain version and SDPA on the
    pre-gathered cache; with the blocks per SM, splits and ring stages the
    wrapper picks.  Returns (max abs error, the shape's numbers)."""
    from repro_torch.kernels import build, ops, ref
    args = _paged_case(dev, g, b, hq, hkv, hd, 64, lengths)
    q, pk, pv, table, ln = args
    err = _paged_check(label, args)
    out, again = ops.paged_flash_decode(*args), ops.paged_flash_decode(*args)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"{label}: two calls differ")
    moved = _paged_bytes(q, pk, table, ln, out)
    bms, by = bound(moved, 4 * hq * hd * sum(lengths), BF16_FLOPS)
    ms = graph_ms(lambda: ops.paged_flash_decode(*args))
    call = cuda_ms(lambda: ops.paged_flash_decode(*args))
    plain = cuda_ms(lambda: ref.paged_flash_decode_ref(*args), warmup=1, iters=5)
    sdpa = _sdpa_call(*args)
    lib = graph_ms(sdpa)
    lib_err = float((sdpa()[:, :, 0].float() - out).abs().max())
    blocks = ops._decode_blocks_per_sm(build.library("flash_decode"), 1, hq // hkv, hd,
                                       table.shape[1])
    splits = ops.decode_splits(b, hkv, table.shape[1], blocks * ops._sm_count(q.device))
    stages = ops.decode_stages(1, hd)
    print(f"[kernels] {label} B={b} Hq/Hkv {hq}/{hkv} tokens={lengths}: {ms:.4f} ms on the "
          f"card ({moved / ms / 1e6:.0f} GB/s, bound {bms:.4f} ms), {call:.4f} ms per call "
          f"(plain {plain:.3f} ms per call; SDPA on the pre-gathered view {lib:.4f} ms on the "
          f"card, max |diff| {lib_err:.1e}); {blocks} blocks/SM, {splits} splits, {stages} "
          "stages", flush=True)
    del args, q, pk, pv, table, ln, out, again, sdpa
    torch.cuda.empty_cache()
    return err, dict(b=b, tokens=lengths, hq=hq, hkv=hkv, maxp=-(-max(lengths) // 64),
                     blocks_per_sm=blocks, splits=splits, stages=stages, ms=ms, call_ms=call,
                     plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=lib,
                     library_max_abs_diff=lib_err, gbps=moved / ms / 1e6)


def _paged_decode_row(dev, g) -> dict:
    """Paged flash decode against its plain version at (a) the serving
    shape, (b) 4 x 4096 and (c) 1 x 32768 tokens (Mixtral's max_seq_len;
    exercises the page split), then every compiled variant and the edge
    cases, then the page-id fault."""
    from repro_torch.kernels import ops

    shapes = {
        "a": dict(b=4, lengths=[70, 95, 112, 57]),        # serving run's range
        "b": dict(b=4, lengths=[4096] * 4),
        "c": dict(b=1, lengths=[32768]),
    }
    per, err = {}, 0.0
    for key, sh in shapes.items():
        e, per[key] = _paged_shape(dev, g, f"paged_flash_decode ({key})", sh["b"],
                                   sh["lengths"], 32, 8, 128)
        err = max(err, e)

    n_checked = 0
    for kv_dt in (torch.bfloat16, torch.float32):
        for grp in ops.FLASH_DECODE_GROUPS:
            for hd in ops.FLASH_DECODE_HEAD_DIMS:
                args = _paged_case(dev, g, 3, 2 * grp, 2, hd, 16, [0, 37, 64],
                                   maxp=5, num_pages=16, dtype=kv_dt)
                err = max(err, _paged_check(f"paged_flash_decode {kv_dt} g={grp} hd={hd}",
                                            args))
                n_checked += 1
    base = _paged_case(dev, g, 4, 32, 8, 128, 64, [1, 64, 128, 0], maxp=3, num_pages=16)
    err = max(err, _paged_check("paged_flash_decode softcap 5", base, softcap=5.0))
    err = max(err, _paged_check("paged_flash_decode page-boundary/1/0 lengths", base))
    q, pk, pv, table, ln = base
    alias = table.clone()
    alias[1] = table[0]                                 # rows 0 and 1 share pages
    err = max(err, _paged_check("paged_flash_decode aliased rows",
                                (q, pk, pv, alias, ln)))
    over = torch.tensor([500, 3, 192, 7], dtype=torch.int32, device=dev)  # > maxp*psz
    err = max(err, _paged_check("paged_flash_decode length past the table",
                                (q, pk, pv, table, over)))
    qf = q.float()
    err = max(err, _paged_check("paged_flash_decode f32 q, bf16 pages", (qf, pk, pv, table, ln)))
    n_checked += 5
    for psz in (16, 128):       # a 64-token tile spans 4 pages / half a page
        args = _paged_case(dev, g, 4, 32, 8, 128, psz, [63, 64, 65, 129], maxp=-(-129 // psz),
                           num_pages=4 * -(-129 // psz))
        err = max(err, _paged_check(f"paged_flash_decode psz {psz}, tile-boundary lengths",
                                    args))
        err = max(err, _paged_check(f"paged_flash_decode psz {psz} softcap 5", args,
                                    softcap=5.0))
        n_checked += 2
    err = max(err, _paged_nan_check(dev, g))
    n_checked += 1
    print(f"[kernels] paged_flash_decode: {n_checked} further variants (bf16/f32 pages, "
          f"g {ops.FLASH_DECODE_GROUPS}, hd {ops.FLASH_DECODE_HEAD_DIMS}, softcap 5, "
          "lengths 0/1/page boundary/past the table, aliased rows, psz 16/128 with "
          "lengths 63/64/65 around the 64-token tile, NaN past the lengths) agree with "
          "the plain version", flush=True)
    _page_fault()
    a = per["a"]
    return dict(name="paged_flash_decode", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:183", max_abs_err=err,
                ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"],
                bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=a["library_ms"],
                library="scaled_dot_product_attention(enable_gqa=True) on the "
                        "pre-gathered dense K/V view, gather not timed",
                shapes=per, tolerance="rtol 1e-4 atol 1e-4")


def _paged_nan_check(dev, g, hq=32, hkv=8, hd=128) -> float:
    """Rows past each slot's length and the pages no slot uses hold NaN: the
    kernel never reads them (a tile's rows past the length repeat a valid
    row), so its output is finite and matches the plain version.  The plain
    version weighs masked rows 0 but 0 x NaN is NaN, so it runs on a copy
    with those rows zero-filled when its output on the poisoned pool is not
    finite."""
    from repro_torch.kernels import ops, ref
    q, pk, pv, table, ln = _paged_case(dev, g, 4, hq, hkv, hd, 16, [0, 37, 64, 65], maxp=6,
                                       num_pages=30)
    _, psz, _, _ = pk.shape
    poison = torch.ones(pk.shape[:2], dtype=torch.bool)           # (P, psz) rows
    rows = table.tolist()
    for r, n in enumerate(ln.tolist()):
        for t in range(n):
            poison[rows[r][t // psz], t % psz] = False
    poison = poison.to(dev)
    pk = pk.masked_fill(poison[:, :, None, None], float("nan"))
    pv = pv.masked_fill(poison[:, :, None, None], float("nan"))
    got = ops.paged_flash_decode(q, pk, pv, table, ln)
    want = ref.paged_flash_decode_ref(q, pk, pv, table, ln)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "paged_flash_decode: NaN past the lengths "
                                           "reached the output")
    note = "on the poisoned pool"
    if not bool(torch.isfinite(want).all()):
        want = ref.paged_flash_decode_ref(q, pk.nan_to_num(0.0), pv.nan_to_num(0.0), table, ln)
        note = "on a zero-filled copy (on the poisoned pool it gives NaN)"
    err = _close("paged_flash_decode NaN past the lengths", got, want, **PAGED_TOL)
    check(bool((got[0] == 0).all()), "paged_flash_decode: length-0 row with NaN pages")
    print(f"[kernels] paged_flash_decode Hq/Hkv {hq}/{hkv} NaN-poisoned pool "
          f"({int(poison.sum())} of "
          f"{poison.numel()} rows): finite, max abs err {err:.1e} against the plain "
          f"version {note}", flush=True)
    return err


_PAGE_FAULT_CHILD = r"""
import os, sys
sys.path.insert(0, sys.argv[1])
import torch
from repro_torch.kernels import ops
dev = torch.device("cuda", 0)
q = torch.ones((2, 8, 128), dtype=torch.bfloat16, device=dev)
pk = torch.zeros((4, 64, 2, 128), dtype=torch.bfloat16, device=dev)
row1 = [int(x) for x in sys.argv[2].split(",")]
table = torch.tensor([[0, 1, 0], row1], dtype=torch.int32, device=dev)
ln = torch.tensor([70, 70], dtype=torch.int32, device=dev)
try:
    ops.paged_flash_decode(q, pk, pk, table, ln)
    torch.cuda.synchronize()
except Exception as exc:  # a CUDA error, whichever class this torch gives it
    print("ABORTED:", type(exc).__name__, str(exc).strip().splitlines()[0],
          flush=True)
    os._exit(3)
print("NOT ABORTED", flush=True)
os._exit(0)
"""


def _page_fault() -> None:
    """A page id past the pool must abort the paged flash-decode kernel, as
    it makes the plain version raise IndexError: in a page the slot reads
    (table row [2, 4, 0], 70 tokens in 64-token pages) and in one it does not
    read ([2, 3, 4]), which the block that owns that share of the row checks."""
    cases = ("2,4,0", "2,3,4")
    procs = [(row, subprocess.Popen([sys.executable, "-c", _PAGE_FAULT_CHILD,
                                     os.path.join(ROOT, "src"), row],
                                    stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for row in cases]
    for row, proc in procs:
        try:
            out, _ = proc.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.communicate()
            fail("paged_flash_decode: page-fault check timed out")
        tail = out.strip().splitlines()[-1] if out.strip() else ""
        check(proc.returncode == 3 and tail.startswith("ABORTED"),
              f"paged_flash_decode with table row [{row}] in a pool of 4 pages did not "
              f"abort (exit {proc.returncode}): {tail}")
        print(f"[kernels] paged_flash_decode table row [{row}], pool of 4 pages: {tail}",
              flush=True)


# ---------------------------------------------------------------------------
# phase 3b, g = 6: paged flash decode at Nemotron-4-15B's and InternVL2-26B's heads
# ---------------------------------------------------------------------------
G6_HEADS = dict(hq=48, hkv=8, hd=128)       # g = 6, as both models publish


def _decode_regs(paged: bool) -> str:
    """Registers and spill bytes per thread of the g = 6, hd 128 pass-1
    kernels (bf16 ring, float32 body) beside g = 4's."""
    from repro_torch.kernels import ops
    out = []
    for kvb, body in ((1, "ring"), (0, "float32")):
        for grp in (4, 6):
            r = ops.decode_kernel_regs(kvb, grp, 128, paged)
            out.append(f"{body} g={grp}: {r['regs']} registers, {r['local_bytes']} B local")
    return "; ".join(out)


def _paged_decode_g6_row(dev, g) -> dict:
    """Paged flash decode at g = 6 (48 query heads on 8 kv heads, hd 128)
    against its plain version at (a) the Nemotron serve's shape (4 slots of
    32-80 tokens), (b) 4 x 4096 and (c) 1 x 32768 tokens, bit-identical over
    two calls, timed from graph replays beside its bytes bound (the bytes
    of g = 4 at 8 kv heads) and SDPA on the same cache; then lengths 0 and
    1 in a ragged batch, float32 K/V and a NaN-poisoned pool.  Prints the
    pass-1 kernels' registers and spills and the blocks per SM the runtime
    gives (``decode_splits`` sizes the grid from it)."""
    from repro_torch.kernels import build, ops

    hq, hkv, hd = G6_HEADS["hq"], G6_HEADS["hkv"], G6_HEADS["hd"]
    shapes = {
        "a": dict(b=4, lengths=[41, 64, 80, 33]),         # Nemotron serve's range
        "b": dict(b=4, lengths=[4096] * 4),
        "c": dict(b=1, lengths=[32768]),
    }
    per, err, same = {}, 0.0, 0
    for key, sh in shapes.items():
        e, per[key] = _paged_shape(dev, g, f"paged_flash_decode g=6 ({key})", sh["b"],
                                   sh["lengths"], hq, hkv, hd)
        err = max(err, e)
        same += 1

    n_checked = 0
    for kv_dt in (torch.bfloat16, torch.float32):
        args = _paged_case(dev, g, 5, hq, hkv, hd, 64, [0, 1, 700, 129, 64], maxp=12,
                           num_pages=64, dtype=kv_dt)
        name = f"paged_flash_decode g=6 {str(kv_dt)[6:]} K/V, lengths 0/1/ragged"
        err = max(err, _paged_check(name, args))
        a, b = ops.paged_flash_decode(*args), ops.paged_flash_decode(*args)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"{name}: two calls differ")
        same += 1
        n_checked += 1
    err = max(err, _paged_nan_check(dev, g, **G6_HEADS))
    n_checked += 1
    f32_blocks = ops._decode_blocks_per_sm(build.library("flash_decode"), 0, 6, hd, 12)
    print(f"[kernels] paged_flash_decode g=6: {n_checked} further variants (bf16 and float32 "
          "K/V with lengths 0/1/ragged, NaN past the lengths) agree with the plain version; "
          f"{same} cases bit-identical over two calls; pass-1 kernels at hd 128: "
          f"{_decode_regs(True)}; float32 body {f32_blocks} blocks/SM (ring: "
          f"{per['b']['blocks_per_sm']})", flush=True)
    a = per["a"]
    return dict(name="paged_flash_decode (g=6)", op="paged_flash_decode",
                paths=("serve_nemotron", "serve_nemotron_q4", "serve_internvl2"), route="cuda",
                source="src/repro_torch/kernels/csrc/flash_decode.cu",
                replaces="src/repro/kernels/flash_decode.py:183", max_abs_err=err,
                ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"],
                bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=a["library_ms"],
                library="scaled_dot_product_attention(enable_gqa=True) on the "
                        "pre-gathered dense K/V view, gather not timed",
                shapes=per, float32_blocks_per_sm=f32_blocks,
                regs={f"{body} g={grp}": ops.decode_kernel_regs(kvb, grp, 128, True)
                      for kvb, body in ((1, "ring"), (0, "float32")) for grp in (4, 6)},
                tolerance="rtol 1e-4 atol 1e-4")


# ---------------------------------------------------------------------------
# phase 3c: dense dequant-matmul at Granite-3.0-2B's FFN shapes
# ---------------------------------------------------------------------------
# float32 sums over K <= 8192 taken in another order than torch.matmul's
DQ_TOL = dict(rtol=1e-4, atol=1e-4)
# bytes the timed launches of one shape cycle through (twice the 50 MB L2)
L2_CYCLE_BYTES = 100 * 2**20


def _dq_case(dev, g, m, k, n, *, bits=4, group=128, lead=(), x_dtype=torch.bfloat16,
             raw=False, offset=False, codes_offset=False):
    """A seeded weight quantized on the card (quantize_tree's default group
    128) and x of shape (*lead, m, k); `raw` replaces the codes by seeded
    random bytes (every two's-complement code, -8 and -128 included);
    `offset` puts x, still contiguous, one element into its storage (not
    16-byte aligned); `codes_offset` puts the codes 4 bytes into theirs."""
    from repro_torch.quant.quantize import QTensor, quantize
    w = torch.randn((k, n), generator=g, device=dev) * 0.02
    x = torch.randn((*lead, m, k), generator=g, device=dev).to(x_dtype)
    if offset:
        buf = torch.empty(x.numel() + 1, dtype=x_dtype, device=dev)
        buf[1:].copy_(x.reshape(-1))
        x = buf[1:].view(x.shape)
    q = quantize(w, bits=bits, group_size=group)
    if raw:
        data = torch.randint(-128, 128, tuple(q.data.shape), generator=g, device=dev,
                             dtype=torch.int8)
        q = QTensor(data, q.scale, bits, group, k)
    if codes_offset:
        buf = torch.empty(q.data.numel() + 4, dtype=torch.int8, device=dev)
        buf[4:].copy_(q.data.reshape(-1))
        q = QTensor(buf[4:].view(q.data.shape), q.scale, bits, group, k)
    return x, q


def _dq_check(name, x, q):
    """(max abs error, the kernel that launched): the kernel is read from the
    wrapper's per-kernel launch counts around the call."""
    return _dq_check_on(None, name, x, q)


def _dq_check_on(kernel, name, x, q):
    """`_dq_check` through the named kernel (``ops._dequant_matmul_on``), or
    through the wrapper's choice when `kernel` is None."""
    from repro_torch.kernels import ops, ref
    before = ops.dequant_mm_launches()
    got = ops.dequant_matmul(x, q) if kernel is None else ops._dequant_matmul_on(kernel, x, q)
    after = ops.dequant_mm_launches()
    ran = [k for k in after if after[k] != before.get(k, 0)]
    check(len(ran) == 1, f"{name}: launched {ran}, not one dequant-matmul kernel")
    want = ref.dequant_matmul_ref(x, q)
    torch.cuda.synchronize()
    check(got.shape == want.shape, f"{name}: shape {tuple(got.shape)} != {tuple(want.shape)}")
    return _close(f"{name} ({ran[0]})", got, want, **DQ_TOL), ran[0]


def _cycling(fns):
    """One callable that calls each of `fns` in turn."""
    it = itertools.cycle(fns)
    return lambda: next(it)()


def _copies(q, nbytes_each: int):
    """Copies of q (same codes, other addresses), enough that cycling
    through them moves over twice the card's 50 MB L2 cache: a decode step
    reads each layer's weights once, cold, and so does each timed launch."""
    from repro_torch.quant.quantize import QTensor
    n = max(2, -(-L2_CYCLE_BYTES // nbytes_each))
    return [q] + [QTensor(q.data.clone(), q.scale.clone(), q.bits, q.group_size, q.orig_k)
                  for _ in range(n - 1)]


def _dq_plan(kern, x, q):
    """(tile, splits or cluster size, blocks per SM, registers) of the
    kernel the wrapper launches for x @ q."""
    from repro_torch.kernels import ops
    blocks, regs = ops.dequant_mm_occupancy(kern, q.bits, int(x.dtype == torch.bfloat16),
                                            q.group_size)
    splits = ops._dequant_mm_splits_for(kern, x.reshape(-1, x.shape[-1]), q)
    rows = {"mma": ops.DEQUANT_MM_MMA_ROWS, "mmv": ops.DEQUANT_MM_MMV_ROWS,
            "gemv": ops.DEQUANT_MM_GEMV_ROWS}[kern]
    return f"{rows}x{ops.DEQUANT_MM_TILE_N}", splits, blocks, regs


def _dequant_matmul_row(dev, g) -> dict:
    """The kernels against their plain version at Granite's wi (2048 ->
    16384, SwiGLU) and wo (8192 -> 2048), 4-bit codes, group 128, bf16 x:
    decode M = 1-4 on the tensor-core decode kernel ("mmv") and chunked
    prefill M = 64, 256 (4 slots x 64 tokens) on the tensor-core prefill
    kernel ("mma").  Each shape is timed with its weight cold in L2, as a
    decode step finds it (launches cycle through copies of the weight); at
    the decode shapes the gemv kernel (``ops._dequant_matmul_on``) beside
    it in the same run, and two calls must give bit-identical outputs.
    Beside every shape torch.matmul on the pre-dequantized bf16 weight,
    the yardstick (it reads 4x the bytes); at the decode shapes also both
    kernels with one weight, warm in L2 after its first launch.  The decode
    kernel at M = 1 at every cluster size (wo 1-8, wi 1-2), checked and
    timed cold, beside the size the wrapper picks.  Then every compiled
    variant and the edges of the three kernels at small shapes, each
    printed with the kernel that ran."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.quantize import dequantize

    cfg = get_config(GRANITE)
    mats = {"wi": (cfg.d_model, 2 * cfg.d_ff), "wo": (cfg.d_ff, cfg.d_model)}
    per, err, same = {}, 0.0, []
    for name, (k, n) in mats.items():
        for m in (1, 2, 3, 4, 64, 256):
            x, q = _dq_case(dev, g, m, k, n)
            e, kern = _dq_check(f"dequant_matmul {name} M={m}", x, q)
            err = max(err, e)
            out = ops.dequant_matmul(x, q)
            again = ops.dequant_matmul(x, q)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"dequant_matmul {name} M={m}: two calls differ")
            same.append(f"{name} M={m}")
            qs = _copies(q, nbytes(q.data, q.scale))
            ms = graph_ms(_cycling([lambda c=c: ops.dequant_matmul(x, c) for c in qs]))
            call = cuda_ms(lambda: ops.dequant_matmul(x, q))
            plain = cuda_ms(lambda: ref.dequant_matmul_ref(x, q), warmup=1, iters=5)
            wb = dequantize(q, dtype=torch.bfloat16)
            wbs = [wb] + [wb.clone() for _ in range(-(-L2_CYCLE_BYTES // nbytes(wb)) - 1)]
            mm = graph_ms(_cycling([lambda w=w: torch.matmul(x, w) for w in wbs]))
            gemv = warm = gemv_warm = None
            if kern == "mmv":
                e2, _ = _dq_check_on("gemv", f"dequant_matmul {name} M={m}", x, q)
                err = max(err, e2)
                gemv = graph_ms(_cycling([lambda c=c: ops._dequant_matmul_on("gemv", x, c)
                                          for c in qs]))
                # one weight, warm in L2 after its first launch
                warm = graph_ms(lambda: ops.dequant_matmul(x, q))
                gemv_warm = graph_ms(lambda: ops._dequant_matmul_on("gemv", x, q))
            moved = nbytes(x, q.data, q.scale, out)
            peak = BF16_FLOPS if kern in ("mma", "mmv") else F32_FLOPS
            bms, by = bound(moved, 2 * m * k * n, peak)
            tile, splits, blocks, regs = _dq_plan(kern, x, q)
            tflops = 2 * m * k * n / ms / 1e9
            per[f"{name} M={m}"] = dict(
                m=m, k=k, n=n, bits=4, group=128, kernel=kern, tile=tile,
                **({"cluster": splits} if kern == "mmv" else {"splits": splits}),
                blocks_per_sm=blocks, regs=regs, ms=ms, call_ms=call, plain_ms=plain,
                bound_ms=bms, bound_by=by, gbps=moved / ms / 1e6, tflops=tflops,
                gemv_ms=gemv, matmul_bf16_ms=mm, l2_warm_ms=warm, gemv_l2_warm_ms=gemv_warm)
            split = f"cluster of {splits}" if kern == "mmv" else f"{splits} splits"
            vs_gemv = (f", gemv kernel {gemv:.4f} ms ({gemv / ms:.2f}x); L2 warm {warm:.4f} ms, "
                       f"gemv {gemv_warm:.4f} ms" if gemv else "")
            print(f"[kernels] dequant_matmul {name} M={m} K={k} N={n}: {kern} kernel, tile "
                  f"{tile}, {split}, {blocks} blocks/SM, {regs} registers: {ms:.4f} ms on the "
                  f"card, L2 cold ({moved / ms / 1e6:.0f} GB/s, {tflops:.1f} TFLOP/s; bound "
                  f"{bms:.4f} ms by {by}, {bms / ms:.0%} of it){vs_gemv}; {call:.4f} ms per "
                  f"call (plain {plain:.3f} ms per call; torch.matmul on the dequantized bf16 "
                  f"weight {mm:.4f} ms, {ms / mm:.2f}x)", flush=True)
            del x, q, qs, wb, wbs, out, again
        torch.cuda.empty_cache()
    print(f"[kernels] dequant_matmul mmv kernel, 4 bits: clusters the card runs at once with "
          f"one block per SM, by cluster size: {ops.dequant_mmv_fit(4)}", flush=True)
    sweep = {}
    for name, sizes in (("wo", range(1, 9)), ("wi", (1, 2))):
        k, n = mats[name]
        x, q = _dq_case(dev, g, 1, k, n)
        want = ref.dequant_matmul_ref(x, q)
        qs = _copies(q, nbytes(q.data, q.scale))
        sweep[name] = {}
        for c in sizes:
            got = ops._dequant_matmul_on("mmv", x, q, c)
            torch.cuda.synchronize()
            err = max(err, _close(f"dequant_matmul {name} M=1 cluster {c} (mmv)", got, want,
                                  **DQ_TOL))
            sweep[name][c] = graph_ms(_cycling(
                [lambda w=w, c=c: ops._dequant_matmul_on("mmv", x, w, c) for w in qs]))
        chosen = ops._dequant_mm_splits_for("mmv", x.reshape(-1, k), q)
        print(f"[kernels] dequant_matmul {name} M=1, mmv kernel by cluster size, ms on the card "
              f"(L2 cold): {' '.join(f'{c}: {t:.4f}' for c, t in sweep[name].items())}; the "
              f"wrapper picks {chosen}", flush=True)
        del x, q, qs, want, got

    ran = {"gemv": [], "mma": [], "mmv": []}
    for bits in (8, 4, 2):
        for x_dtype in (torch.bfloat16, torch.float32):
            for m in (3, 24):                               # decode and prefill
                x, q = _dq_case(dev, g, m, 512, 256, bits=bits, group=64, x_dtype=x_dtype)
                name = f"bits={bits} {str(x_dtype)[6:]} M={m}"
                e, kern = _dq_check(f"dequant_matmul {name}", x, q)
                err = max(err, e)
                ran[kern].append(name)
    # name: (case, the kernel it must take)
    cases = {"ragged M=5": (dict(m=5, k=2048, n=16384), "mma"),
             "M=16": (dict(m=16, k=1024, n=512), "mma"),
             "M=17": (dict(m=17, k=1024, n=512), "mma"),
             "M=63": (dict(m=63, k=1024, n=512), "mma"),
             "M=65": (dict(m=65, k=1024, n=512), "mma"),
             "M=256 N=640": (dict(m=256, k=1024, n=640), "mma"),
             "ragged N=100 group 32": (dict(m=24, k=256, n=100, group=32), "mma"),
             "ragged N=96": (dict(m=24, k=384, n=96), "mma"),
             "ragged M=7 N=100 group 32": (dict(m=7, k=256, n=100, group=32), "mma"),
             "group 16": (dict(m=40, k=512, n=256, group=16), "mma"),
             "group 16 bits 8 N=100": (dict(m=40, k=512, n=100, bits=8, group=16), "mma"),
             "group 32": (dict(m=40, k=512, n=256, group=32), "mma"),
             "group 64": (dict(m=40, k=512, n=256, group=64), "mma"),
             "group 256": (dict(m=40, k=1024, n=256, group=256), "mma"),
             "group 48": (dict(m=24, k=480, n=256, group=48), "mma"),
             "bits 8 M=80": (dict(m=80, k=2048, n=384, bits=8), "mma"),
             "bits 2 M=80": (dict(m=80, k=2048, n=384, bits=2), "mma"),
             "raw codes bits 8": (dict(m=24, k=512, n=256, bits=8, raw=True), "mma"),
             "raw codes bits 4": (dict(m=24, k=512, n=256, raw=True), "mma"),
             "raw codes bits 2": (dict(m=24, k=512, n=256, bits=2, raw=True), "mma"),
             "split K M=64 wo, bits 8": (dict(m=64, k=8192, n=2048, bits=8), "mma"),
             "leading dims (2, 3)": (dict(m=3, k=2048, n=256, lead=(2,)), "mma"),
             "leading dims (2, 40)": (dict(m=40, k=1024, n=256, lead=(2,)), "mma"),
             "bits 8 wo M=3": (dict(m=3, k=8192, n=2048, bits=8), "mmv"),
             "bits 2 wo M=2": (dict(m=2, k=8192, n=2048, bits=2), "mmv"),
             "bits 8 wi M=1": (dict(m=1, k=2048, n=16384, bits=8), "mmv"),
             "bits 2 wi M=4": (dict(m=4, k=2048, n=16384, bits=2), "mmv"),
             "group 16 M=4": (dict(m=4, k=512, n=256, group=16), "mmv"),
             "group 16 bits 8 M=3": (dict(m=3, k=512, n=256, bits=8, group=16), "mmv"),
             "group 32 M=1": (dict(m=1, k=512, n=256, group=32), "mmv"),
             "group 64 M=3": (dict(m=3, k=1024, n=384, group=64), "mmv"),
             "group 256 M=4": (dict(m=4, k=1024, n=256, group=256), "mmv"),
             "group 48 M=2": (dict(m=2, k=480, n=256, group=48), "mmv"),
             "ragged N=96 M=4": (dict(m=4, k=384, n=96), "mmv"),
             "ragged N=272 M=2": (dict(m=2, k=512, n=272), "mmv"),
             "raw codes bits 8 M=4": (dict(m=4, k=512, n=256, bits=8, raw=True), "mmv"),
             "raw codes bits 4 M=3": (dict(m=3, k=512, n=256, raw=True), "mmv"),
             "raw codes bits 2 M=1": (dict(m=1, k=512, n=256, bits=2, raw=True), "mmv"),
             "M=1 bits 8 wo": (dict(m=1, k=8192, n=2048, bits=8), "mmv"),
             "leading dims (2, 2)": (dict(m=2, k=2048, n=256, lead=(2,)), "mmv"),
             "leading dims (2, 2, 1)": (dict(m=1, k=1024, n=256, lead=(2, 2)), "mmv"),
             "K of a single group M=4": (dict(m=4, k=128, n=512), "mmv"),
             "K of a single group 256 M=2": (dict(m=2, k=256, n=1024, group=256), "mmv"),
             "10 groups over a cluster of 6": (dict(m=2, k=1280, n=2048), "mmv"),
             "32 groups over a cluster of 6": (dict(m=3, k=8192, n=2048, group=256), "mmv"),
             "3 groups over a cluster of 3": (dict(m=4, k=384, n=512), "mmv"),
             "group 8 M=24": (dict(m=24, k=256, n=128, group=8), "gemv"),
             "group 512 M=24": (dict(m=24, k=1024, n=128, group=512), "gemv"),
             "group 8 M=3": (dict(m=3, k=256, n=128, group=8), "gemv"),
             "group 512 M=1": (dict(m=1, k=1024, n=128, group=512), "gemv"),
             "f32 x M=64": (dict(m=64, k=1024, n=256, x_dtype=torch.float32), "gemv"),
             "f32 x M=4 wo": (dict(m=4, k=8192, n=2048, x_dtype=torch.float32), "gemv"),
             "bf16 x off 16-byte alignment M=24": (dict(m=24, k=512, n=256, offset=True),
                                                   "gemv"),
             "bf16 x off 16-byte alignment M=4": (dict(m=4, k=512, n=256, offset=True),
                                                  "gemv"),
             "ragged N=100 M=3 group 32": (dict(m=3, k=256, n=100, group=32), "gemv"),
             "ragged N=100 M=1 bits 2 group 16": (dict(m=1, k=256, n=100, bits=2, group=16),
                                                  "gemv"),
             "codes off 16-byte alignment M=2": (dict(m=2, k=512, n=256, codes_offset=True),
                                                 "gemv")}
    for name, (kw, want) in cases.items():
        x, q = _dq_case(dev, g, kw.pop("m"), kw.pop("k"), kw.pop("n"), **kw)
        e, kern = _dq_check(f"dequant_matmul {name}", x, q)
        check(kern == want, f"dequant_matmul {name}: took the {kern} kernel, not {want}")
        err = max(err, e)
        ran[kern].append(name)
        if kern == "mmv":
            a, b = ops.dequant_matmul(x, q), ops.dequant_matmul(x, q)
            torch.cuda.synchronize()
            check(torch.equal(a, b), f"dequant_matmul {name}: two calls differ")
            same.append(name)
    for kern, names in ran.items():
        print(f"[kernels] dequant_matmul, {kern} kernel: {len(names)} further variants agree "
              f"with the plain version: {'; '.join(names)}", flush=True)
    print(f"[kernels] dequant_matmul: two calls gave bit-identical outputs at {len(same)} "
          f"shapes: {'; '.join(same)}", flush=True)
    mixtral = _dq_mixtral_expert(dev, g)
    err = max(err, max(r["max_abs_err"] for r in mixtral.values()))
    a = per["wi M=4"]
    return dict(name="dequant_matmul", route="cuda",
                source="src/repro_torch/kernels/csrc/dequant_matmul.cu",
                replaces="src/repro/kernels/dequant_matmul.py:90", max_abs_err=err,
                ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"],
                bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=None,
                library="none: no single PyTorch call dequantizes and multiplies; the "
                        "yardstick is torch.matmul on the pre-dequantized bf16 weight (4x "
                        "the bytes), under shapes as matmul_bf16_ms",
                kernels={"mmv": "dequant_mmv_kernel: decode, M <= 4 rows of bf16 x (the "
                                "row's ms, at wi M=4)",
                         "mma": "dequant_mma_kernel: prefill, M > 4 rows of bf16 x",
                         "gemv": "dequant_mm_kernel: float32 x, unaligned x, other groups, "
                                 "decode at N % 16 != 0 or unaligned codes"},
                shapes=per, mixtral_expert_shapes=mixtral, cluster_sweep_ms=sweep,
                variants={k: len(v) for k, v in ran.items()},
                bit_identical=len(same), tolerance="rtol 1e-4 atol 1e-4")


def _dq_mixtral_expert(dev, g) -> dict:
    """The decode kernel at Mixtral-8x7B's expert shapes, as the per-expert
    engine path calls it for each product of a lo expert: wi (4096 ->
    28672, SwiGLU) and wo (14336 -> 4096), x (1, 1, K) bf16 (one row's
    hidden state), 4-bit codes and group 64 (``EngineConfig``'s), the
    weight a row of a two-slot pool (slot 1, its codes offset by K/2 * N
    bytes, as a pool view is).  Checked against the plain version at
    DQ_TOL, two calls bit-identical, timed cold in L2 (launches cycle
    through copies) beside its bound and torch.matmul on the dequantized
    bf16 weight."""
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.quantize import QTensor, dequantize, quantize

    cfg = mixtral_cut()
    d, f = cfg.d_model, cfg.moe.d_ff_expert
    out = {}
    for name, (k, n) in {"wi": (d, 2 * f), "wo": (f, d)}.items():
        q0 = quantize(torch.randn((k, n), generator=g, device=dev) * 0.02, bits=4,
                      group_size=64)
        pool_data = torch.stack([torch.zeros_like(q0.data), q0.data])
        pool_scale = torch.stack([torch.zeros_like(q0.scale), q0.scale])
        q = QTensor(pool_data[1], pool_scale[1], 4, 64, k)
        check(q.data.data_ptr() % 16 == 0, f"mixtral {name}: pool view codes unaligned")
        x = torch.randn((1, 1, k), generator=g, device=dev).to(torch.bfloat16)
        label = f"dequant_matmul mixtral expert {name} M=1"
        e, kern = _dq_check(label, x, q)
        check(kern == "mmv", f"{label}: took the {kern} kernel, not mmv")
        y = ops.dequant_matmul(x, q)
        again = ops.dequant_matmul(x, q)
        torch.cuda.synchronize()
        check(torch.equal(y, again), f"{label}: two calls differ")
        qs = _copies(q, nbytes(q.data, q.scale))
        ms = graph_ms(_cycling([lambda c=c: ops.dequant_matmul(x, c) for c in qs]))
        call = cuda_ms(lambda: ops.dequant_matmul(x, q))
        plain = cuda_ms(lambda: ref.dequant_matmul_ref(x, q), warmup=1, iters=3)
        wb = dequantize(q, dtype=torch.bfloat16)
        wbs = [wb] + [wb.clone() for _ in range(-(-L2_CYCLE_BYTES // nbytes(wb)) - 1)]
        mm = graph_ms(_cycling([lambda w=w: torch.matmul(x, w) for w in wbs]))
        moved = nbytes(x, q.data, q.scale, y)
        bms, by = bound(moved, 2 * k * n, BF16_FLOPS)
        tile, cluster, blocks, regs = _dq_plan(kern, x, q)
        out[name] = dict(m=1, k=k, n=n, bits=4, group=64, kernel=kern, tile=tile,
                         cluster=cluster, blocks_per_sm=blocks, regs=regs, ms=ms,
                         call_ms=call, plain_ms=plain, bound_ms=bms, bound_by=by,
                         gbps=moved / ms / 1e6, matmul_bf16_ms=mm, max_abs_err=e)
        print(f"[kernels] {label} K={k} N={n} (group 64, pool slot 1): mmv kernel, tile "
              f"{tile}, cluster of {cluster}, {blocks} blocks/SM, {regs} registers: "
              f"{ms:.4f} ms on the card, L2 cold ({moved / ms / 1e6:.0f} GB/s; bound "
              f"{bms:.4f} ms by {by}, {bms / ms:.0%} of it); {call:.4f} ms per call "
              f"(plain {plain:.3f} ms per call; torch.matmul on the dequantized bf16 weight "
              f"{mm:.4f} ms, {ms / mm:.2f}x); max abs err {e:.2e}", flush=True)
        del q0, pool_data, pool_scale, q, qs, x, y, again, wb, wbs
        torch.cuda.empty_cache()
    return out


def _dq_ffn(dev, g, arch: str, tag: str) -> dict:
    """The dense dequant-matmul kernels at `arch`'s FFN: wi d_model -> d_ff
    (2 d_ff when gated) and wo d_ff -> d_model, 4-bit codes, group 128,
    bf16 x; decode M = 1-4 and chunked prefill M = 64, 256 against the
    plain version, two calls bit-identical, timed with the weight cold in L2
    beside its bound and torch.matmul on the dequantized bf16 weight; each
    shape prints its kernel and plan (tile, K-split or cluster, blocks/SM,
    registers).  A MoE's shared experts, which run as one dense FFN, add
    their two matrices ("shared wi", "shared wo").  Nemotron-4-15B (squared
    ReLU): wi 6144 -> 24576, wo 24576 -> 6144, 192 groups of K; Gemma-2-27B
    (SwiGLU): wi 4608 -> 73728, wo 36864 -> 4608, 288 groups of K over 36
    column tiles; DeepSeek-V2-236B: the dense first layer's wi 5120 ->
    24576 and wo 12288 -> 5120, the 2 shared experts' wi 5120 -> 6144 and
    wo 3072 -> 5120; Jamba-v0.1-52B's dense FFN layers: wi 4096 -> 28672, wo
    14336 -> 4096."""
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops, ref
    from repro_torch.quant.quantize import dequantize

    cfg = get_config(arch)
    gate = 2 if cfg.ffn_activation == "swiglu" else 1
    mats = {"wi": (cfg.d_model, gate * cfg.d_ff), "wo": (cfg.d_ff, cfg.d_model)}
    if cfg.moe is not None and cfg.moe.num_shared_experts:
        fs = (cfg.moe.d_ff_shared or cfg.moe.d_ff_expert) * cfg.moe.num_shared_experts
        mats.update({"shared wi": (cfg.d_model, gate * fs), "shared wo": (fs, cfg.d_model)})
    per, err = {}, 0.0
    for name, (k, n) in mats.items():
        for m in (1, 2, 3, 4, 64, 256):
            x, q = _dq_case(dev, g, m, k, n)
            label = f"dequant_matmul {tag} {name} M={m}"
            e, kern = _dq_check(label, x, q)
            check(kern == ("mmv" if m <= 4 else "mma"), f"{label}: took the {kern} kernel")
            err = max(err, e)
            out, again = ops.dequant_matmul(x, q), ops.dequant_matmul(x, q)
            torch.cuda.synchronize()
            check(torch.equal(out, again), f"{label}: two calls differ")
            qs = _copies(q, nbytes(q.data, q.scale))
            ms = graph_ms(_cycling([lambda c=c: ops.dequant_matmul(x, c) for c in qs]))
            call = cuda_ms(lambda: ops.dequant_matmul(x, q))
            plain = cuda_ms(lambda: ref.dequant_matmul_ref(x, q), warmup=1, iters=3)
            wb = dequantize(q, dtype=torch.bfloat16)
            wbs = [wb] + [wb.clone() for _ in range(-(-L2_CYCLE_BYTES // nbytes(wb)) - 1)]
            mm = graph_ms(_cycling([lambda w=w: torch.matmul(x, w) for w in wbs]))
            moved = nbytes(x, q.data, q.scale, out)
            bms, by = bound(moved, 2 * m * k * n, BF16_FLOPS)
            tile, splits, blocks, regs = _dq_plan(kern, x, q)
            per[f"{name} M={m}"] = dict(
                m=m, k=k, n=n, bits=4, group=128, kernel=kern, tile=tile,
                **({"cluster": splits} if kern == "mmv" else {"splits": splits}),
                blocks_per_sm=blocks, regs=regs, ms=ms, call_ms=call, plain_ms=plain,
                bound_ms=bms, bound_by=by, gbps=moved / ms / 1e6, matmul_bf16_ms=mm,
                max_abs_err=e)
            split = f"cluster of {splits}" if kern == "mmv" else f"{splits} splits"
            print(f"[kernels] {label} K={k} N={n}: {kern} kernel, tile {tile}, {split}, "
                  f"{blocks} blocks/SM, {regs} registers: {ms:.4f} ms on the card, L2 cold "
                  f"({moved / ms / 1e6:.0f} GB/s; bound {bms:.4f} ms by {by}, {bms / ms:.0%} "
                  f"of it); {call:.4f} ms per call (plain {plain:.3f} ms per call; "
                  f"torch.matmul on the dequantized bf16 weight {mm:.4f} ms, {ms / mm:.2f}x); "
                  f"max abs err {e:.2e}", flush=True)
            del x, q, qs, wb, wbs, out, again
        torch.cuda.empty_cache()
    a = per["wo M=1"]
    return dict(name=f"dequant_matmul ({tag})", op="dequant_matmul",
                paths=(f"serve_{tag}_q4",), route="cuda",
                source="src/repro_torch/kernels/csrc/dequant_matmul.cu",
                replaces="src/repro/kernels/dequant_matmul.py:90", max_abs_err=err,
                ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"],
                bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=None,
                library="none: no single PyTorch call dequantizes and multiplies; the "
                        "yardstick is torch.matmul on the pre-dequantized bf16 weight, "
                        "under shapes as matmul_bf16_ms (the row's ms: wo M=1)",
                shapes=per, tolerance="rtol 1e-4 atol 1e-4")


# ---------------------------------------------------------------------------
# phase 3d: flash decode over a contiguous cache
# ---------------------------------------------------------------------------
FLASH_TOL = dict(rtol=1e-4, atol=1e-4)      # float32 sums in another order


def _flash_case(dev, g, b, s, hq, hkv, hd, lengths, dtype=torch.bfloat16):
    q = torch.randn((b, hq, hd), generator=g, device=dev).to(dtype)
    k = torch.randn((b, s, hkv, hd), generator=g, device=dev).to(dtype)
    v = torch.randn((b, s, hkv, hd), generator=g, device=dev).to(dtype)
    return q, k, v, torch.tensor(lengths, dtype=torch.int32, device=dev)


def _flash_plain(q, k, v, lengths):
    """What ops.flash_decode runs on the CPU: repeat the kv heads, then the
    masked float32 softmax."""
    from repro_torch.kernels import ref
    g = q.shape[1] // k.shape[2]
    return ref.flash_decode_ref(q, k.repeat_interleave(g, dim=2),
                                v.repeat_interleave(g, dim=2), lengths)


def _flash_check(name, args) -> float:
    from repro_torch.kernels import ops
    got = ops.flash_decode(*args)
    want = _flash_plain(*args)
    torch.cuda.synchronize()
    return _close(name, got, want, **FLASH_TOL)


def _flash_nan_check(dev, g) -> float:
    """Cache rows past each slot's length hold NaN (slots of length <= 0
    weigh every row and keep theirs): the kernel never reads them, so its
    output is finite and matches the plain version, which runs on a
    zero-filled copy when 0 x NaN makes its own output NaN."""
    from repro_torch.kernels import ops
    q, k, v, ln = _flash_case(dev, g, 5, 320, 32, 8, 128, [1, 63, 65, 300, 0])
    pos = torch.arange(k.shape[1], device=dev)[None, :]
    poison = (pos >= ln[:, None]) & (ln[:, None] > 0)
    k = k.masked_fill(poison[:, :, None, None], float("nan"))
    v = v.masked_fill(poison[:, :, None, None], float("nan"))
    got = ops.flash_decode(q, k, v, ln)
    want = _flash_plain(q, k, v, ln)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), "flash_decode: NaN past the lengths reached "
                                           "the output")
    note = "on the poisoned cache"
    if not bool(torch.isfinite(want).all()):
        want = _flash_plain(q, k.nan_to_num(0.0), v.nan_to_num(0.0), ln)
        note = "on a zero-filled copy (on the poisoned cache it gives NaN)"
    err = _close("flash_decode NaN past the lengths", got, want, **FLASH_TOL)
    print(f"[kernels] flash_decode NaN-poisoned cache ({int(poison.sum())} of "
          f"{poison.numel()} rows): finite, max abs err {err:.1e} against the plain "
          f"version {note}", flush=True)
    return err


def _flash_bytes(q, k, lengths, out) -> int:
    """K/V bytes of the rows each slot reads (min(length, S); all S for a
    length <= 0, whose weights are uniform), read once, plus q, lengths and
    the output."""
    _, s, hkv, hd = k.shape
    rows = sum(s if n <= 0 else min(n, s) for n in lengths.tolist())
    return 2 * rows * hkv * hd * k.element_size() + nbytes(q, lengths, out)


def _flash_shape(dev, g, label, b, s, lengths, hq, hkv, hd):
    """One timed shape of the contiguous kernel (bf16): checked against its
    plain version, two calls bit-identical, device ms from graph replays
    beside its bytes bound, the plain version and SDPA with enable_gqa on a
    (B, H, S, hd) view transposed beforehand (not timed); with the blocks
    per SM, splits and ring stages.  Returns (max abs error, numbers)."""
    from repro_torch.kernels import build, ops
    F = torch.nn.functional
    args = _flash_case(dev, g, b, s, hq, hkv, hd, lengths)
    q, k, v, ln = args
    err = _flash_check(label, args)
    out, again = ops.flash_decode(*args), ops.flash_decode(*args)
    torch.cuda.synchronize()
    check(torch.equal(out, again), f"{label}: two calls differ")
    moved = _flash_bytes(q, k, ln, out)
    rows = sum(min(n, s) for n in lengths)
    bms, by = bound(moved, 4 * hq * hd * rows, BF16_FLOPS)
    ms = graph_ms(lambda: ops.flash_decode(*args))
    call = cuda_ms(lambda: ops.flash_decode(*args))
    plain = cuda_ms(lambda: _flash_plain(*args), warmup=1, iters=5)
    kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
    mask = torch.arange(s, device=dev)[None, :] < ln[:, None].long()
    mask = None if bool(mask.all()) else mask[:, None, None, :]
    q4 = q[:, :, None, :]

    def sdpa():
        return F.scaled_dot_product_attention(q4, kt, vt, attn_mask=mask, enable_gqa=True)
    lib = graph_ms(sdpa)
    lib_err = float((sdpa()[:, :, 0].float() - out).abs().max())
    blocks = ops._blocks_per_sm("flash_decode",
                                build.library("flash_decode_contig").flash_decode_blocks_per_sm,
                                1, hq // hkv, hd)
    splits = ops.decode_splits(b, hkv, -(-s // ops.FLASH_DECODE_UNIT),
                               blocks * ops._sm_count(q.device))
    stages = ops.decode_stages(1, hd)
    print(f"[kernels] {label} B={b} S={s} Hq/Hkv {hq}/{hkv} hd={hd}: {ms:.4f} ms on the card "
          f"({moved / ms / 1e6:.0f} GB/s, bound {bms:.4f} ms), {call:.4f} ms per call (plain "
          f"{plain:.3f} ms per call; SDPA {lib:.4f} ms on the card, max |diff| {lib_err:.1e}); "
          f"{blocks} blocks/SM, {splits} splits, {stages} stages", flush=True)
    del args, q, k, v, ln, out, again, kt, vt
    torch.cuda.empty_cache()
    return err, dict(b=b, s=s, hd=hd, hq=hq, hkv=hkv, tokens=lengths, blocks_per_sm=blocks,
                     splits=splits, stages=stages, ms=ms, call_ms=call, plain_ms=plain,
                     bound_ms=bms, bound_by=by, library_ms=lib, library_max_abs_diff=lib_err,
                     gbps=moved / ms / 1e6)


def _flash_decode_row(dev, g) -> dict:
    """The contiguous kernel against its plain version at (a) Granite's
    serving shape (B 4, 57-112 of 128 rows, Hq 32 / Hkv 8 / hd 64), (b) 4 x
    4096 and (c) 1 x 32768 rows at hd 128 (the paged kernel's (b) and (c)),
    then the edge cases and every compiled variant.  Yardstick: SDPA with
    enable_gqa on a (B, H, S, hd) view transposed beforehand (not timed)."""
    from repro_torch.kernels import ops

    shapes = {
        "a": dict(b=4, s=128, hd=64, lengths=[70, 95, 112, 57]),
        "b": dict(b=4, s=4096, hd=128, lengths=[4096] * 4),
        "c": dict(b=1, s=32768, hd=128, lengths=[32768]),
    }
    per, err = {}, 0.0
    for key, sh in shapes.items():
        e, per[key] = _flash_shape(dev, g, f"flash_decode ({key})", sh["b"], sh["s"],
                                   sh["lengths"], 32, 8, sh["hd"])
        err = max(err, e)

    n_checked = 0
    for kv_dt in (torch.bfloat16, torch.float32):
        for grp in ops.FLASH_DECODE_GROUPS:
            for hd in ops.FLASH_DECODE_HEAD_DIMS:
                args = _flash_case(dev, g, 3, 300, 2 * grp, 2, hd, [0, 37, 300], dtype=kv_dt)
                err = max(err, _flash_check(f"flash_decode {kv_dt} g={grp} hd={hd}", args))
                n_checked += 1
    edge = {
        "length 0 (mean of V) and 1 in a 4096-row cache": (4, 4096, [0, 1, 4096, 2049]),
        "S = 300 off the 32-row tile, past-S and negative lengths": (4, 300, [300, 299, 1000, -3]),
    }
    for name, (b, s, lens) in edge.items():
        args = _flash_case(dev, g, b, s, 32, 8, 64, lens)
        err = max(err, _flash_check(f"flash_decode {name}", args))
        n_checked += 1
    args = _flash_case(dev, g, 4, 200, 32, 8, 128, [63, 64, 65, 129])
    err = max(err, _flash_check("flash_decode hd 128, lengths around the 64-token tile", args))
    err = max(err, _flash_nan_check(dev, g))
    n_checked += 2
    q, k, v, ln = _flash_case(dev, g, 2, 256, 8, 8, 128, [0, 200])
    got = ops.flash_decode(q, k, v, ln)
    torch.cuda.synchronize()
    err = max(err, _close("flash_decode length-0 row is the mean of V", got[0],
                          v[0].float().mean(0), **FLASH_TOL))
    err = max(err, _flash_check("flash_decode f32 q, bf16 K/V", (q.float(), k, v, ln)))
    n_checked += 2
    print(f"[kernels] flash_decode: {n_checked} further variants (bf16/f32 K/V, g "
          f"{ops.FLASH_DECODE_GROUPS}, hd {ops.FLASH_DECODE_HEAD_DIMS}, lengths 0/1/past "
          "S/negative and 63/64/65 around the 64-token tile, S off the tile, f32 q, NaN "
          "past the lengths) agree with the plain version", flush=True)
    a = per["a"]
    return dict(name="flash_decode", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_decode_contig.cu",
                replaces="src/repro/kernels/flash_decode.py:75", max_abs_err=err,
                ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"],
                bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=a["library_ms"],
                library="scaled_dot_product_attention(enable_gqa=True) on a (B, H, S, hd) "
                        "view transposed beforehand, not timed",
                shapes=per, tolerance="rtol 1e-4 atol 1e-4")


def _flash_decode_g6_row(dev, g) -> dict:
    """The contiguous kernel at g = 6 (48 query heads on 8 kv heads, hd
    128) against its plain version at (a) the Nemotron serve's shape (4
    slots of 32-80 of 128 rows), (b) 4 x 4096 and (c) 1 x 32768 rows,
    bit-identical over two calls, timed beside its bytes bound and SDPA;
    then length 0 (the mean of V) and 1 in a ragged batch, and float32
    K/V."""
    from repro_torch.kernels import ops

    hq, hkv, hd = G6_HEADS["hq"], G6_HEADS["hkv"], G6_HEADS["hd"]
    shapes = {
        "a": dict(b=4, s=128, lengths=[41, 64, 80, 33]),
        "b": dict(b=4, s=4096, lengths=[4096] * 4),
        "c": dict(b=1, s=32768, lengths=[32768]),
    }
    per, err, same = {}, 0.0, 0
    for key, sh in shapes.items():
        e, per[key] = _flash_shape(dev, g, f"flash_decode g=6 ({key})", sh["b"], sh["s"],
                                   sh["lengths"], hq, hkv, hd)
        err = max(err, e)
        same += 1
    for kv_dt in (torch.bfloat16, torch.float32):
        args = _flash_case(dev, g, 4, 700, hq, hkv, hd, [0, 1, 700, 129], dtype=kv_dt)
        name = f"flash_decode g=6 {str(kv_dt)[6:]} K/V, lengths 0/1/ragged"
        err = max(err, _flash_check(name, args))
        a, b = ops.flash_decode(*args), ops.flash_decode(*args)
        torch.cuda.synchronize()
        check(torch.equal(a, b), f"{name}: two calls differ")
        same += 1
        err = max(err, _close(f"{name}: length-0 row is the mean of V", a[0],
                              args[2][0].float().mean(0).repeat_interleave(hq // hkv, 0),
                              **FLASH_TOL))
    print(f"[kernels] flash_decode g=6: bf16 and float32 K/V with lengths 0/1/ragged agree "
          f"with the plain version; {same} cases bit-identical over two calls; pass-1 "
          f"kernels at hd 128: {_decode_regs(False)}", flush=True)
    a = per["a"]
    return dict(name="flash_decode (g=6)", op="flash_decode", paths=(), route="cuda",
                source="src/repro_torch/kernels/csrc/flash_decode_contig.cu",
                replaces="src/repro/kernels/flash_decode.py:75", max_abs_err=err,
                ms=a["ms"], call_ms=a["call_ms"], plain_ms=a["plain_ms"],
                bound_ms=a["bound_ms"], bound_by=a["bound_by"], library_ms=a["library_ms"],
                library="scaled_dot_product_attention(enable_gqa=True) on a (B, H, S, hd) "
                        "view transposed beforehand, not timed",
                shapes=per, tolerance="rtol 1e-4 atol 1e-4")


# ---------------------------------------------------------------------------
# phase 4: the serving path on full-width Mixtral-8x7B (depth cut)
# ---------------------------------------------------------------------------
OPS = ("gating_topk", "stacked_gating", "grouped_dequant_matmul",
       "grouped_dequant_combine")
PAGED_OPS = OPS + ("paged_flash_decode",)


class _FiniteLogits:
    """Backend wrapper asserting every step's and admission's logits are
    finite (the server itself only keeps the sampled tokens)."""

    def __init__(self, inner):
        self.inner = inner
        self.model = inner.model
        self.step_s = []                    # host wall of each decode step

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, tokens):
        t0 = time.perf_counter()
        lg = self.inner.step(tokens)        # logits on the host: the step is done
        self.step_s.append(time.perf_counter() - t0)
        check(bool(np.isfinite(lg).all()), "non-finite decode logits")
        return lg

    def join_step(self):
        done = self.inner.join_step()
        for lg in done.values():
            check(bool(np.isfinite(lg).all()), "non-finite prefill logits")
        return done


def mixtral_cut():
    from repro_torch.configs import get_config
    return dataclasses.replace(get_config(ARCH), num_layers=LAYERS).validate()


def _gating_path(counts, es, label, grouped) -> None:
    """Prints the engine's gating_s (host wall from each layer segment's
    replay, the router's gating_topk and the predictor's stacked gating its
    last kernels, to its routes and predictor probabilities on the host,
    waiting also for the layer before's grouped FFN still on the card), the
    real lo pairs each grouped launch carried and the distinct
    pool slots among them, and the real hi pairs; every grouped launch (`grouped`:
    ``ops.grouped_launches()`` of the run) must have gone to the
    tensor-core kernel."""
    calls = counts.get("gating_topk.cuda", 0)
    lo, sl, hi = es["lo_pairs_per_launch"], es["lo_slots_per_launch"], es["hi_pairs_per_launch"]
    for op in ("grouped_dequant_matmul", "grouped_dequant_combine"):
        check(grouped.get(f"{op}.mmv", 0) == counts.get(f"{op}.cuda", 0) > 0,
              f"{label}: {op} launches {grouped} did not all take the tensor-core kernel")
    print(f"[{label}] gating_s {es['gating_s']:.4f} s over {calls} gating_topk calls "
          f"({es['gating_s'] / max(calls, 1) * 1e3:.4f} ms per call, host wall of the layer "
          f"segment with the copy back); lo pairs per grouped launch: min {lo['min']}, median {lo['median']}, max "
          f"{lo['max']} over {lo['launches']} launches {lo['hist']}; distinct slots per launch: "
          f"min {sl['min']}, median {sl['median']}, max {sl['max']} {sl['hist']}; hi pairs per "
          f"grouped launch: min {hi['min']}, median {hi['median']}, max {hi['max']} "
          f"{hi['hist']}; grouped kernels {grouped}", flush=True)


def engine_steps(eng) -> list:
    """Names of the offload engine's captured steps (``core/engine.py``)."""
    return (["engine_embed", "engine_ffn", "engine_logits"]
            + [f"engine_layer{mi}" for mi in range(eng.num_moe_layers)])


def _ffn_captured(counts, label) -> dict:
    """Every MoE layer's grouped FFN of the run went through its captured
    step on the card: as many captures and replays as layer segments ran
    (one gating_topk launch each), none eager; the grouped kernels launched
    once per layer and step (grouped_matmul twice: wi, wo).  Returns the
    launches per MoE layer and step."""
    layer_steps = counts.get("gating_topk.cuda", 0)
    ffn = counts.get("engine_ffn.capture", 0) + counts.get("engine_ffn.graph", 0)
    check(layer_steps > 0 and ffn == layer_steps,
          f"{label}: {ffn} grouped-FFN calls for {layer_steps} MoE layer steps")
    check(counts.get("engine_ffn.eager", 0) == 0, f"{label}: the grouped FFN ran eagerly")
    per = {op: counts.get(f"{op}.cuda", 0) / layer_steps
           for op in ("grouped_matmul", "grouped_dequant_matmul", "grouped_dequant_combine")}
    check(per == {"grouped_matmul": 2, "grouped_dequant_matmul": 1,
                  "grouped_dequant_combine": 1},
          f"{label}: grouped launches per MoE layer step {per}")
    print(f"[{label}] grouped FFN: {ffn} MoE layer steps, "
          f"{counts.get('engine_ffn.capture', 0)} captures and "
          f"{counts.get('engine_ffn.graph', 0)} replays; per layer step {json.dumps(per)}",
          flush=True)
    return per


def _ffn_replay_check(eng, label) -> float:
    """The grouped FFN's graph replayed on a fixed input (hidden state and
    residual seeded; the pair table the last layer left on the card)
    against the same function called eagerly on it: the same kernels on the
    same inputs, so max |diff| must be 0."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=eng.device).manual_seed(SEED + 10)
    dt = eng.params["embed"].dtype
    d = eng.cfg.d_model
    hs = torch.randn((eng.batch, d), generator=g, device=eng.device).to(dt)
    x = torch.randn((eng.batch, 1, d), generator=g, device=eng.device).to(dt)
    before = ops.dispatch_counts()
    replay = eng._ffn_step(hs, x, key=eng._ffn_key()).clone()
    after = ops.dispatch_counts()
    check(after.get("engine_ffn.graph", 0) == before.get("engine_ffn.graph", 0) + 1
          and after.get("engine_ffn.capture", 0) == before.get("engine_ffn.capture", 0),
          f"{label}: the grouped FFN did not replay its graph")
    eager = eng._ffn(hs, x)
    diff = float((replay.float() - eager.float()).abs().max())
    check(diff == 0.0, f"{label}: grouped FFN replay vs eager max |diff| {diff}")
    print(f"[{label}] grouped FFN, replay vs eager on one input: max |diff| {diff}", flush=True)
    return diff


def _captured_path(counts, names, label) -> dict:
    """Every captured step in `names` replayed as a CUDA graph and never ran
    eagerly on the card; returns {name: [captures, replays]} and prints it."""
    out = {}
    for n in names:
        check(counts.get(f"{n}.graph", 0) > 0, f"{label}: {n} never replayed a graph")
        check(counts.get(f"{n}.eager", 0) == 0, f"{label}: {n} ran eagerly on the card")
        out[n] = [counts.get(f"{n}.capture", 0), counts[f"{n}.graph"]]
    print(f"[{label}] captured steps [captures, replays]: {json.dumps(out)}", flush=True)
    return out


def _segment_replay_check(eng, label) -> float:
    """MoE layer 0's captured segment replayed on a fixed input against the
    same segment called eagerly on it (after the serve: the replay writes
    this input's K/V at the last step's positions, and so does the eager
    call, identically).  The same kernels on the same inputs: expect 0;
    checked at PARITY_ATOL and equal routes.  The predictor probabilities
    the replay computed for every row must equal the predictor's one-row
    call on that row's float32 hidden state bit for bit."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=eng.device).manual_seed(SEED + 9)
    x = torch.randn((eng.batch, 1, eng.cfg.d_model), generator=g, device=eng.device)
    x = x.to(eng.params["embed"].dtype)
    before = ops.dispatch_counts()
    replay = [t.clone() for t in eng._layer_steps[0](x, key=eng._segment_key(eng.moe_layers[0]))]
    after = ops.dispatch_counts()
    check(after.get("engine_layer0.graph", 0) == before.get("engine_layer0.graph", 0) + 1
          and after.get("engine_layer0.capture", 0) == before.get("engine_layer0.capture", 0),
          f"{label}: the segment did not replay its graph")
    eager = eng._layer_segment(0, x)
    names = ("x", "hs", "vals", "idx", "probs")
    diff = {n: float((a.float() - b.float()).abs().max()) for n, a, b in zip(names, replay, eager)}
    check(torch.equal(replay[3], eager[3]), f"{label}: replayed routes {replay[3].tolist()} != "
                                            f"eager {eager[3].tolist()}")
    hs, probs = replay[1], replay[4]
    for r in range(eng.batch):
        one = eng.predictor.layer_probs(hs[r:r + 1].to(torch.float32), 0)[:, 0]
        check(torch.equal(probs[:, r], one),
              f"{label}: row {r}'s segment predictor probabilities differ from its one-row "
              f"call by {float((probs[:, r] - one).abs().max())}")
    worst = max(diff.values())
    check(worst <= PARITY_ATOL, f"{label}: segment replay vs eager max |diff| {diff}")
    print(f"[{label}] layer 0 segment, replay vs eager on one input: max |diff| {worst} "
          f"({json.dumps(diff)})", flush=True)
    return worst


def phase_serve(dev, model, params) -> dict:
    from repro_torch.core import EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.api import BackendConfig, make_backend
    from repro_torch.serving.batching import BatchingServer, Request

    cfg = model.cfg
    t0 = time.perf_counter()
    backend = make_backend(BackendConfig(kind="hobbit", engine=EngineConfig()),
                           model, params)
    eng = backend.engine
    print(f"[serve] engine up in {time.perf_counter() - t0:.1f} s: host storage "
          f"pinned, {eng.num_moe_layers * cfg.moe.num_experts} experts quantized "
          f"on the card, measured link {eng.scheduler.link_bps / 1e9:.1f} GB/s",
          flush=True)
    rng = np.random.default_rng(SEED)
    n_req, new_tokens, max_batch = 6, 16, SERVE_BATCH
    probe = _FiniteLogits(backend)
    srv = BatchingServer(probe, max_batch=max_batch, max_len=64 + new_tokens + 8)
    for i in range(n_req):
        plen = int(rng.integers(32, 65))
        srv.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
                           max_new_tokens=new_tokens))
    ops.reset_dispatch_counts()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.dispatch_counts()
    grouped = ops.grouped_launches()
    st = srv.stats()
    es = eng.stats()
    captured = _captured_path(counts, engine_steps(eng), "serve")
    ffn_per_layer = _ffn_captured(counts, "serve")
    seg_diff = _segment_replay_check(eng, "serve")
    ffn_diff = _ffn_replay_check(eng, "serve")
    srv.close()

    check(len(srv.completed) == n_req, f"{len(srv.completed)}/{n_req} requests done")
    for r in srv.completed:
        out = np.asarray(r.output)
        check(out.shape == (new_tokens,), f"request {r.rid}: {out.shape} tokens")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"request {r.rid}: token ids outside the vocabulary")
    for op in OPS:
        check(counts.get(f"{op}.cuda", 0) > 0, f"{op}: no CUDA launch on the serving path")
        check(counts.get(f"{op}.torch", 0) == 0, f"{op}: plain version ran on the card")
    check(es["loads_hi"] > 0 and es["loads_lo"] > 0,
          f"loads_hi={es['loads_hi']} loads_lo={es['loads_lo']}")
    _gating_path(counts, es, "serve", grouped)
    summary = {
        "requests": n_req, "new_tokens": new_tokens, "max_batch": max_batch,
        "wall_s": wall, "decode_tok_s": st["decode_tok_s"],
        "load_stall_s": es["load_stall_s"], "overlap_fraction": es["overlap_fraction"],
        "cache_hit_ratio": es["cache"]["hit_ratio"], "loads_hi": es["loads_hi"],
        "loads_lo": es["loads_lo"], "precision_downgrades": es["precision_downgrades"],
        "link_gbps": es["link_gbps"], "kernel_dispatch": counts,
        "mean_prefill_s": st["mean_prefill_s"], "mean_decode_s": st["mean_decode_s"],
        "gating_s": es["gating_s"], "lo_pairs_per_launch": es["lo_pairs_per_launch"],
        "lo_slots_per_launch": es["lo_slots_per_launch"],
        "hi_pairs_per_launch": es["hi_pairs_per_launch"], "grouped_kernels": grouped,
        "captured_steps": captured, "segment_replay_vs_eager": seg_diff,
        "ffn_replay_vs_eager": ffn_diff, "ffn_launches_per_layer_step": ffn_per_layer,
        "median_step_ms": statistics.median(probe.step_s) * 1e3,
    }
    print(f"[serve] {json.dumps(summary)}", flush=True)
    return summary


# ---------------------------------------------------------------------------
# phase 5: offload engine vs dense model, every expert resident at bf16
# ---------------------------------------------------------------------------
PARITY_ATOL = 0.1


def phase_parity(dev, cfg, params) -> None:
    """Unconstrained setting: hi pool >= layers x experts, thresholds (1, 1)
    (no lo, no skip), no prefetch, capacity_factor 8 (the dense dispatch
    drops nothing).  Both paths compute in bf16 with float32 accumulation
    but round in different places (the dense MoE combines in bf16, the
    engine in float32), so per-step logits (std ~1.3 here) must agree
    within atol PARITY_ATOL = 0.1; a wrong expert, weight or kernel moves
    them by O(1)."""
    from repro_torch.core import OffloadEngine
    from repro_torch.core.host_model import resident_config
    from repro_torch.models import build_model
    from repro_torch.serving.api import DenseBackend, HobbitBackend

    cfg8 = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg8)
    ecfg = resident_config(cfg8)
    dense = DenseBackend(model, params)
    hob = HobbitBackend(OffloadEngine(model, params, ecfg))
    rng = np.random.default_rng(SEED + 1)
    b, s, steps = 2, 32, 4
    prompts = rng.integers(0, cfg8.vocab_size, (b, s))
    teacher = rng.integers(0, cfg8.vocab_size, (steps, b))
    worst, same = 0.0, 0
    try:
        for be in (dense, hob):
            be.start_batch(b, s + steps + 4)
        pairs = [(dense.prefill(prompts), hob.prefill(prompts))]
        for t in range(steps):
            pairs.append((dense.step(teacher[t]), hob.step(teacher[t])))
        for i, (ld, lh) in enumerate(pairs):
            check(bool(np.isfinite(lh).all()), f"parity step {i}: non-finite logits")
            err = float(np.abs(ld - lh).max())
            worst = max(worst, err)
            same += int((ld.argmax(-1) == lh.argmax(-1)).sum())
            check(err <= PARITY_ATOL, f"parity step {i}: max |dense - hobbit| = "
                                      f"{err:.4f} > {PARITY_ATOL}")
        counts = hob.stats()["kernel_dispatch"]
        check(counts.get("gating_topk.cuda", 0) > 0, "parity: gating kernel not used")
    finally:
        hob.close()
    print(f"[parity] {len(pairs)} steps (prefill + {steps} decode) x {b} rows: max "
          f"|dense - hobbit| = {worst:.4f} <= {PARITY_ATOL}; greedy tokens equal in "
          f"{same}/{len(pairs) * b}", flush=True)


# ---------------------------------------------------------------------------
# phase 6: the paged KV serving path
# ---------------------------------------------------------------------------
SYSTEM_PROMPT = 48      # tokens; not a multiple of the 64-token page


class _PeakPages(_FiniteLogits):
    """Finite-logits wrapper that also keeps the page pool's peak occupancy
    (kv_page_fraction after each decode step)."""

    peak = 0.0

    def step(self, tokens):
        lg = super().step(tokens)
        self.peak = max(self.peak, self.inner.kv.page_fraction)
        return lg


def phase_serve_paged(dev, model, params) -> dict:
    """HobbitBackend with EngineConfig(paged_kv=True) at its defaults (64-
    token pages, 64-token prefill chunks, prefix sharing, the dense-
    equivalent pool) under BatchingServer(max_batch=4).  Request 0 carries
    the 48-token system prompt alone, so its page is a registered partial
    page; the others append a seeded 16-48-token body, alias that page and
    copy it on their first write.  admit_k=1 admits one request per
    scheduler iteration, so each prompt is in the trie before the next
    admission matches it (concurrent admissions register nothing for each
    other)."""
    from repro_torch.core import EngineConfig
    from repro_torch.kernels import ops
    from repro_torch.serving.api import BackendConfig, make_backend
    from repro_torch.serving.batching import BatchingServer, Request

    cfg = model.cfg
    t0 = time.perf_counter()
    backend = make_backend(BackendConfig(kind="hobbit", paged=True, engine=EngineConfig()),
                           model, params)
    eng = backend.engine
    ecfg = eng.ecfg
    print(f"[serve-paged] engine up in {time.perf_counter() - t0:.1f} s: page size "
          f"{ecfg.kv_page_size}, prefill chunk {ecfg.prefill_chunk}, prefix sharing "
          f"{ecfg.prefix_sharing}", flush=True)
    rng = np.random.default_rng(SEED + 2)
    sys_p = rng.integers(0, cfg.vocab_size, SYSTEM_PROMPT)
    n_req, new_tokens, max_batch = 8, 16, SERVE_BATCH
    probe = _PeakPages(backend)
    srv = BatchingServer(probe, max_batch=max_batch, admit_k=1,
                         max_len=SYSTEM_PROMPT + 48 + new_tokens + 8)
    for i in range(n_req):
        body = rng.integers(0, cfg.vocab_size, 0 if i == 0 else int(rng.integers(16, 49)))
        srv.submit(Request(rid=i, prompt=np.concatenate([sys_p, body]),
                           max_new_tokens=new_tokens))
    ops.reset_dispatch_counts()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.dispatch_counts()
    grouped = ops.grouped_launches()
    st = srv.stats()
    es = eng.stats()
    captured = _captured_path(counts, engine_steps(eng) + ["prefill_chunk"], "serve-paged")
    ffn_per_layer = _ffn_captured(counts, "serve-paged")
    ffn_diff = _ffn_replay_check(eng, "serve-paged")
    srv.close()

    check(len(srv.completed) == n_req, f"{len(srv.completed)}/{n_req} requests done")
    for r in srv.completed:
        out = np.asarray(r.output)
        check(out.shape == (new_tokens,), f"request {r.rid}: {out.shape} tokens")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"request {r.rid}: token ids outside the vocabulary")
    for op in PAGED_OPS:
        check(counts.get(f"{op}.cuda", 0) > 0,
              f"{op}: no CUDA launch on the paged serving path")
    bad = {k: v for k, v in counts.items() if k.endswith(".torch")}
    check(not bad, f"plain versions ran on the card: {bad}")
    _gating_path(counts, es, "serve-paged", grouped)
    check(es["prefix_hit_tokens"] > 0, "no prefix hit on a shared system prompt")
    check(es["cow_copies"] > 0, "no copy-on-write of the shared partial page")
    prompt_tokens = sum(len(r.prompt) for r in srv.completed)
    summary = {
        "requests": n_req, "new_tokens": new_tokens, "max_batch": max_batch,
        "wall_s": wall, "decode_tok_s": st["decode_tok_s"],
        "load_stall_s": es["load_stall_s"], "cache_hit_ratio": es["cache"]["hit_ratio"],
        "prefix_hit_tokens": es["prefix_hit_tokens"], "prompt_tokens": prompt_tokens,
        "prefix_hit_ratio": es["prefix_hit_tokens"] / prompt_tokens,
        "cow_copies": es["cow_copies"], "kv_pages_total": es["kv_pages_total"],
        "kv_page_fraction_peak": probe.peak,
        "mean_prefill_s": st["mean_prefill_s"], "mean_decode_s": st["mean_decode_s"],
        "gating_s": es["gating_s"], "lo_pairs_per_launch": es["lo_pairs_per_launch"],
        "lo_slots_per_launch": es["lo_slots_per_launch"],
        "hi_pairs_per_launch": es["hi_pairs_per_launch"], "grouped_kernels": grouped,
        "kernel_dispatch": counts, "captured_steps": captured,
        "ffn_replay_vs_eager": ffn_diff, "ffn_launches_per_layer_step": ffn_per_layer,
        "median_step_ms": statistics.median(probe.step_s) * 1e3,
    }
    print(f"[serve-paged] {st['decode_tok_s']:.1f} tok/s, load stall "
          f"{es['load_stall_s']:.3f} s, prefix hit ratio {summary['prefix_hit_ratio']:.3f} "
          f"({es['prefix_hit_tokens']} of {prompt_tokens} prompt tokens), "
          f"{es['cow_copies']} COW copies, kv_page_fraction {probe.peak:.3f} at its peak "
          f"of {es['kv_pages_total']} pages; {json.dumps(summary)}", flush=True)
    return summary


# ---------------------------------------------------------------------------
# phase 7: the engine on paged KV against the same engine on dense KV
# ---------------------------------------------------------------------------
def phase_paged_parity(dev, cfg, params) -> None:
    """The unconstrained engine of phase 5 on paged KV and on dense KV, the
    same prompts and teacher-forced tokens: per-step logits within
    PARITY_ATOL (attention runs in another kernel and another summation
    order; a wrong page, position or mask moves the logits by O(1))."""
    from repro_torch.core import OffloadEngine
    from repro_torch.core.host_model import resident_config
    from repro_torch.models import build_model
    from repro_torch.serving.api import HobbitBackend

    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg8)
    rng = np.random.default_rng(SEED + 3)
    b, s, steps = 2, 100, 4          # 100-token prompts span two 64-token pages
    prompts = rng.integers(0, cfg8.vocab_size, (b, s))
    teacher = rng.integers(0, cfg8.vocab_size, (steps, b))
    runs = {}
    for paged in (False, True):
        ecfg = dataclasses.replace(resident_config(cfg8), paged_kv=paged)
        hob = HobbitBackend(OffloadEngine(model, params, ecfg))
        try:
            hob.start_batch(b, s + steps + 4)
            lg = [hob.prefill(prompts)] + [hob.step(teacher[t]) for t in range(steps)]
            counts = hob.stats()["kernel_dispatch"]
        finally:
            hob.close()
        runs[paged] = lg
        gc.collect()
        torch.cuda.empty_cache()
    check(counts.get("paged_flash_decode.cuda", 0) > 0, "paged parity: kernel not used")
    worst, same = 0.0, 0
    for i, (ld, lp) in enumerate(zip(runs[False], runs[True])):
        check(bool(np.isfinite(lp).all()), f"paged parity step {i}: non-finite logits")
        err = float(np.abs(ld - lp).max())
        worst = max(worst, err)
        same += int((ld.argmax(-1) == lp.argmax(-1)).sum())
        check(err <= PARITY_ATOL, f"paged parity step {i}: max |dense KV - paged KV| = "
                                  f"{err:.4f} > {PARITY_ATOL}")
    print(f"[paged-parity] {steps + 1} steps (prefill + {steps} decode) x {b} rows: max "
          f"|dense KV - paged KV| = {worst:.4f} <= {PARITY_ATOL}; greedy tokens equal in "
          f"{same}/{(steps + 1) * b}", flush=True)


# ---------------------------------------------------------------------------
# phase 7b: the per-expert reference path against the grouped path
# ---------------------------------------------------------------------------
GROUPED_OPS = ("gating_topk", "grouped_matmul", "grouped_dequant_matmul",
               "grouped_dequant_combine")
# a teacher-forced NLL is a log-softmax at one index: it moves by at most
# twice the largest logit change, and logits agree within PARITY_ATOL
NLL_ATOL = 2 * PARITY_ATOL


def _free_engine() -> None:
    """Collect a closed engine's pinned host storage and device pools
    before the next engine is built."""
    gc.collect()
    torch.cuda.empty_cache()


def _per_expert_run(model, params, prompts, teacher, *, grouped, paged) -> dict:
    """One teacher-forced workload through HobbitBackend on the default
    constrained cache with synchronous loading: per step its logits, its
    trace rows (each MoE layer's routed experts and gates per active row)
    and the cumulative hi/lo loads; decode seconds, engine stats and the
    launches of the run."""
    from repro_torch.core import PREC_HI, PREC_LO, EngineConfig, OffloadEngine
    from repro_torch.kernels import ops
    from repro_torch.serving.api import HobbitBackend

    b, s = prompts.shape
    steps = teacher.shape[0]
    hob = HobbitBackend(OffloadEngine(model, params, EngineConfig(
        async_prefetch=False, grouped=grouped, paged_kv=paged)))
    eng = hob.engine
    try:
        hob.start_batch(b, s + steps + 4)
        ops.reset_dispatch_counts()
        lg = [hob.prefill(prompts)]
        per_step, decode_s = [], 0.0
        for t in range(steps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg.append(hob.step(teacher[t]))
            torch.cuda.synchronize()
            decode_s += time.perf_counter() - t0
            per_step.append(dict(
                routes=[[(list(map(int, e.experts)), np.asarray(e.gate_vals, np.float64))
                         for e in row] for row in eng.trace[t * b:(t + 1) * b]],
                loads=(eng.loader.n_loads[PREC_HI], eng.loader.n_loads[PREC_LO])))
        counts = ops.dispatch_counts()
        es = hob.stats()
        th = eng.loader.th
    finally:
        hob.close()
    del hob, eng
    _free_engine()
    return dict(logits=lg, per_step=per_step, th=th, decode_s=decode_s,
                decode_tok_s=b * steps / decode_s, kernel_dispatch=counts,
                loads_hi=es["loads_hi"], loads_lo=es["loads_lo"],
                union_reloads=es["union_reloads"], cache_hit_ratio=es["cache"]["hit_ratio"])


# two paths' routing probabilities within this of each other are a near tie:
# bf16 rounding of the hidden state moves them by ~1e-3 at most (the
# per-expert path rounds each lo expert's output to bf16 as the reference
# does, the grouped path combines in float32), a wrong route by O(0.1)
GATE_TIE = 0.01


def _tie_gap(entry_g, entry_r, th):
    """None when one layer's routing (experts in rank order, gates) and the
    precision decisions agree on both paths; else the largest probability
    gap the difference hinges on, to be held to GATE_TIE: the gates of the
    experts both picked, the last-rank gates where the picks differ, the
    gap between two ranks that swapped, and the normalised top gate's
    distance to the threshold a decision crossed."""
    from repro_torch.core.scoring import normalize_gates, precision_decisions
    (xg, gg), (xr, gr) = entry_g, entry_r
    dg, dr = precision_decisions(gg, th).tolist(), precision_decisions(gr, th).tolist()
    if xg == xr and dg == dr:
        return None
    pg, pr = dict(zip(xg, gg)), dict(zip(xr, gr))
    gaps = [abs(pg[e] - pr[e]) for e in set(xg) & set(xr)]
    if set(xg) != set(xr):
        gaps.append(abs(gg.min() - gr.min()))
    if xg != xr:
        gaps += [abs(gg[i] - gg[i + 1]) for i in range(len(xg) - 1) if xg[i] != xr[i]]
        gaps += [abs(gr[i] - gr[i + 1]) for i in range(len(xr) - 1) if xg[i] != xr[i]]
    if dg != dr:
        top = [float(normalize_gates(v).max()) for v in (gg, gr)]
        gaps.append(min(abs(v - t) for v in top for t in (th.t1, th.t2)))
    return max(gaps)


# The per-expert path with every step eager (commit e06ac32) in phase 7b, decode
# tok/s on dense and paged KV: two runs of that commit's phase_per_expert beside
# two of this one's in one call, NVIDIA H100 80GB HBM3 at 700.00 W (PERF.md)
EAGER_PER_EXPERT_TOK_S = {"dense": "23.27 / 25.11", "paged": "24.40 / 23.71"}


def phase_per_expert(dev, model, params) -> dict:
    """The per-expert reference path (``grouped=False``) against the grouped
    path, both loading synchronously (``async_prefetch=False``) on the
    default constrained cache (16 hi / 8 lo slots, so lo experts and
    reloads happen), on dense and on paged KV: batch 2, 32-token prompts,
    8 teacher-forced decode steps, compared step by step.  Each row's routed
    experts and precision decisions must be equal and its logits within
    PARITY_ATOL (both bf16, float32 sums in another order) until the row's
    routes part at a near tie (``_tie_gap`` within GATE_TIE), after which
    that row computes other experts and only finite logits are checked;
    the cumulative hi/lo loads must be equal until any row parts.  The
    per-expert path must launch the dense dequant-matmul kernel for its lo
    experts and no grouped or gating_topk kernel; no plain version may
    run.  Both paths' decode tok/s: the reference benchmark's grouped vs
    per-expert comparison."""
    cfg = model.cfg
    rng = np.random.default_rng(SEED + 4)
    b, s, steps = 2, 32, 8
    prompts = rng.integers(0, cfg.vocab_size, (b, s))
    teacher = rng.integers(0, cfg.vocab_size, (steps, b))
    out = {}
    for paged in (False, True):
        kv = "paged" if paged else "dense"
        runs = {grouped: _per_expert_run(model, params, prompts, teacher, grouped=grouped,
                                         paged=paged)
                for grouped in (True, False)}
        g, r = runs[True], runs[False]
        for name, run in (("grouped", g), ("per-expert", r)):
            bad = {k: v for k, v in run["kernel_dispatch"].items() if k.endswith(".torch")}
            check(not bad, f"per-expert ({kv} KV), {name} path: plain versions ran: {bad}")
            check(run["kernel_dispatch"].get("stacked_gating.cuda", 0) > 0,
                  f"per-expert ({kv} KV), {name} path: no predictor kernel launch")
            if paged:
                check(run["kernel_dispatch"].get("paged_flash_decode.cuda", 0) > 0,
                      f"per-expert ({kv} KV), {name} path: no paged flash-decode launch")
        check(r["kernel_dispatch"].get("dequant_matmul.cuda", 0) > 0,
              f"per-expert ({kv} KV): no dequant_matmul launch for the lo experts")
        # the per-expert path's device work replays graphs, never eagerly
        _captured_path(r["kernel_dispatch"], ["engine_embed", "engine_logits", "engine_hi",
                                              "engine_lo"]
                       + [f"engine_attn{mi}" for mi in range(cfg.num_layers)],
                       f"per-expert ({kv} KV)")
        for name, run in (("grouped", g), ("per-expert", r)):
            pf = {k: v for k, v in run["kernel_dispatch"].items() if k.startswith("prefill.")}
            check(pf == ({} if paged else {"prefill.eager": 1}),
                  f"per-expert ({kv} KV), {name} path: one-shot prefill {pf}")
        for op in GROUPED_OPS:
            check(r["kernel_dispatch"].get(f"{op}.cuda", 0) == 0,
                  f"per-expert ({kv} KV): {op} launched on the per-expert path")
            check(g["kernel_dispatch"].get(f"{op}.cuda", 0) > 0,
                  f"per-expert ({kv} KV): {op} not launched on the grouped path")
        check(r["loads_lo"] > 0, f"per-expert ({kv} KV): no lo load")
        # rows decode independently: each row is compared until its routes
        # part at a near tie; the loads (a union over rows) until any row parts
        parted, tie = [None] * b, 0.0
        worst, same, compared = 0.0, 0, 0
        for i, (lg, lr) in enumerate(zip(g["logits"], r["logits"])):
            check(bool(np.isfinite(lg).all() and np.isfinite(lr).all()),
                  f"per-expert ({kv} KV) step {i}: non-finite logits")
            if i > 0:                                     # the prefill routes nothing
                sg, sr = g["per_step"][i - 1], r["per_step"][i - 1]
                for row in range(b):
                    if parted[row] is not None:
                        continue
                    gaps = [x for x in (_tie_gap(eg, er, r["th"]) for eg, er in
                                        zip(sg["routes"][row], sr["routes"][row]))
                            if x is not None]
                    if gaps:
                        parted[row], tie = i, max(tie, max(gaps))
                        check(max(gaps) <= GATE_TIE,
                              f"per-expert ({kv} KV) step {i} row {row}: routes or decisions "
                              f"differ by a probability gap {max(gaps):.4f} > {GATE_TIE}")
                if all(p is None for p in parted):
                    check(sg["loads"] == sr["loads"], f"per-expert ({kv} KV) step {i}: "
                                                      f"hi/lo loads {sg['loads']} != {sr['loads']}")
            for row in range(b):
                if parted[row] is not None:
                    continue
                err = float(np.abs(lg[row] - lr[row]).max())
                worst = max(worst, err)
                same += int(lg[row].argmax() == lr[row].argmax())
                compared += 1
                check(err <= PARITY_ATOL, f"per-expert ({kv} KV) step {i} row {row}: max "
                                          f"|grouped - per-expert| = {err:.4f} > {PARITY_ATOL}")
        lo_calls = r["kernel_dispatch"]["dequant_matmul.cuda"]
        loads_until = min((p for p in parted if p is not None), default=steps + 1) - 1
        agree = ("routes, decisions and hi/lo loads equal in every step"
                 if all(p is None for p in parted) else
                 f"rows part at steps {parted} on near ties (largest gap {tie:.5f} <= "
                 f"{GATE_TIE}); hi/lo loads equal through step {loads_until}")
        print(f"[per-expert] {kv} KV, {b} rows x {steps} decode steps: {agree}; loads hi/lo "
              f"grouped {g['loads_hi']}/{g['loads_lo']}, per-expert {r['loads_hi']}/"
              f"{r['loads_lo']}; union reloads {g['union_reloads']} / {r['union_reloads']}; "
              f"max |grouped - per-expert| = {worst:.4f} <= {PARITY_ATOL} over {compared} "
              f"row-steps before the rows part, greedy equal in {same}/{compared}; decode "
              f"tok/s grouped {g['decode_tok_s']:.2f}, per-expert {r['decode_tok_s']:.2f} "
              f"({g['decode_tok_s'] / r['decode_tok_s']:.2f}x); per-expert dequant_matmul "
              f"launches {lo_calls}", flush=True)
        print(f"[per-expert] {kv} KV: per-expert decode tok/s {r['decode_tok_s']:.2f} with "
              f"its segments and experts replayed as graphs; the eager per-expert path (e06ac32): "
              f"{EAGER_PER_EXPERT_TOK_S[kv]}", flush=True)
        for name, run in (("grouped", g), ("per_expert", r)):
            out[f"{name}_{kv}"] = {k: v for k, v in run.items()
                                   if k not in ("logits", "per_step", "th")}
        out[f"compare_{kv}"] = dict(max_abs_diff=worst, row_steps_compared=compared,
                                    rows_parted_at=parted, loads_equal_through=loads_until,
                                    tie_gap=tie)
    print(f"[per-expert] {json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 7c: host compute mode against the device per-expert path
# ---------------------------------------------------------------------------
def phase_host_mode(dev, model, params) -> dict:
    """``score_nll`` through the engine over 6 tokens of one row, on the
    device per-expert path and on ``compute_mode="host"`` (each expert on
    the CPU in float32 from pinned host storage), default constrained
    cache, synchronous loading.  The NLLs must agree within NLL_ATOL (bf16
    rounding on the card: logits within PARITY_ATOL move a log-softmax by
    at most twice that).  Host mode launches no dequant-matmul kernel."""
    from repro_torch.core import EngineConfig, OffloadEngine
    from repro_torch.kernels import ops

    toks = [int(t) for t in np.random.default_rng(SEED + 5).integers(0, model.cfg.vocab_size, 6)]
    res = {}
    for mode in ("device", "host"):
        eng = OffloadEngine(model, params, EngineConfig(async_prefetch=False, grouped=False,
                                                        compute_mode=mode))
        try:
            ops.reset_dispatch_counts()
            t0 = time.perf_counter()
            nll = eng.score_nll(toks)
            torch.cuda.synchronize()
            sec = time.perf_counter() - t0
            counts = ops.dispatch_counts()
            es = eng.stats()
        finally:
            eng.close()
        del eng
        _free_engine()
        check(math.isfinite(nll), f"host-mode: {mode} NLL {nll}")
        bad = {k: v for k, v in counts.items() if k.endswith(".torch")}
        check(not bad, f"host-mode: plain versions ran on the {mode} path: {bad}")
        res[mode] = dict(nll=nll, seconds=sec, loads_hi=es["loads_hi"],
                         loads_lo=es["loads_lo"], kernel_dispatch=counts)
    check(res["device"]["kernel_dispatch"].get("dequant_matmul.cuda", 0) > 0,
          "host-mode: the device path launched no dequant_matmul")
    check(res["host"]["kernel_dispatch"].get("dequant_matmul.cuda", 0) == 0,
          "host-mode: the host path launched dequant_matmul")
    diff = abs(res["host"]["nll"] - res["device"]["nll"])
    check(diff <= NLL_ATOL, f"host-mode: |host - device| NLL = {diff:.4f} > {NLL_ATOL}")
    print(f"[host-mode] score_nll over {len(toks)} tokens: device {res['device']['nll']:.5f} "
          f"in {res['device']['seconds']:.2f} s, host {res['host']['nll']:.5f} in "
          f"{res['host']['seconds']:.2f} s; |host - device| = {diff:.5f} <= {NLL_ATOL}; "
          f"loads hi/lo device {res['device']['loads_hi']}/{res['device']['loads_lo']}, "
          f"host {res['host']['loads_hi']}/{res['host']['loads_lo']}", flush=True)
    res["host_vs_device"] = diff
    return res


# ---------------------------------------------------------------------------
# phase 7d: the single-sequence API
# ---------------------------------------------------------------------------
def phase_single_sequence(dev, cfg, params) -> dict:
    """On the unconstrained configuration of phase 5 (every expert resident
    at full precision, capacity_factor 8): ``engine.generate`` at batch 1
    (the prompt decoded token by token) against ``serving.api.generate``
    through HobbitBackend (the prompt prefilled) on the same prompt, and
    ``serving.api.score_nll`` through HobbitBackend against DenseBackend
    within NLL_ATOL.  The greedy tokens must be equal; where they part, the
    prefixes must be equal and the two tokens a near tie of the API path's
    logits there (their gap within 2 * PARITY_ATOL, bf16 rounding: both
    paths compute the same function in another order), after which the
    sequences legitimately differ."""
    from repro_torch.core import OffloadEngine
    from repro_torch.core.host_model import resident_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model
    from repro_torch.serving import api

    cfg8 = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=8.0))
    model = build_model(cfg8)
    ecfg = resident_config(cfg8)
    rng = np.random.default_rng(SEED + 6)
    prompt = rng.integers(0, cfg8.vocab_size, 16)
    seq = rng.integers(0, cfg8.vocab_size, 12)
    new = 8
    eng = OffloadEngine(model, params, ecfg)
    try:
        ops.reset_dispatch_counts()
        t0 = time.perf_counter()
        by_engine = eng.generate([int(t) for t in prompt], new)
        gen_s = time.perf_counter() - t0
        counts = ops.dispatch_counts()
        hob = api.HobbitBackend(eng)
        by_api = [int(t) for t in api.generate(hob, prompt[None], new).tokens[0, len(prompt):]]
        part = next((i for i in range(new) if by_engine[i] != by_api[i]), None)
        gap = None
        if part is not None:
            # the API path's logits where the two parted, on the shared prefix
            hob.start_batch(1, len(prompt) + new + 1)
            lg = hob.prefill(prompt[None])[0]
            for t in by_api[:part]:
                lg = hob.step(np.asarray([t]))[0]
            gap = float(abs(lg[by_api[part]] - lg[by_engine[part]]))
            check(gap <= 2 * PARITY_ATOL,
                  f"single-sequence: engine.generate {by_engine} != api.generate {by_api} "
                  f"from token {part}, logit gap {gap:.4f} > {2 * PARITY_ATOL}")
        nll_h = api.score_nll(hob, seq)
    finally:
        eng.close()
    del eng, hob
    _free_engine()
    nll_d = api.score_nll(api.DenseBackend(model, params), seq)
    _free_engine()
    bad = {k: v for k, v in counts.items() if k.endswith(".torch")}
    check(not bad, f"single-sequence: plain versions ran: {bad}")
    check(counts.get("gating_topk.cuda", 0) > 0, "single-sequence: gating kernel not used")
    diff = abs(nll_h - nll_d)
    check(math.isfinite(nll_h) and diff <= NLL_ATOL,
          f"single-sequence: |HobbitBackend - DenseBackend| NLL = {diff:.4f} > {NLL_ATOL}")
    print(f"[single-sequence] engine.generate ({new} tokens after a {len(prompt)}-token "
          f"prompt, {gen_s:.2f} s) {by_engine}; api.generate {by_api}: "
          + ("equal" if part is None else f"equal up to token {part}, where the API path's "
             f"logits gap is {gap:.4f} <= {2 * PARITY_ATOL} (a bf16 near tie)")
          + f"; api.score_nll over {len(seq)} tokens: HobbitBackend {nll_h:.5f}, DenseBackend "
          f"{nll_d:.5f}, |diff| = {diff:.5f} <= {NLL_ATOL}", flush=True)
    return dict(engine_tokens=by_engine, api_tokens=by_api, parted_at=part, logit_gap=gap,
                nll_hobbit=nll_h, nll_dense=nll_d, generate_s=gen_s, kernel_dispatch=counts)


# ---------------------------------------------------------------------------
# phase 7f: the simulator's host model measured on the card, and the
# simulator held against the engine it models
# ---------------------------------------------------------------------------
SIM_PROMPT, SIM_NEW = 48, 32        # the compared sequence
SIM_WARM = 16                       # prompt and new tokens of each warm-up
SIM_DEPTHS = (2, LAYERS)            # the resident step's cuts: its slope per layer
SIM_KEYS = ("tok_s", "load_stall_s", "overlap_fraction", "hit_ratio", "loads_hi",
            "loads_lo", "precision_downgrades", "upgrades")


def _resident_steps(model, params, prompt):
    """``host_model.resident_step`` of `model` cut to each of SIM_DEPTHS
    (the first layers of `params`), and a profiler window of 8 steps at
    the full cut; returns the steps, the hi expert's bytes and the window."""
    from repro_torch.core import PREC_HI, OffloadEngine
    from repro_torch.core import host_model as hm
    from repro_torch.models import build_model

    steps, window = [], None
    for depth in SIM_DEPTHS:
        cut = (model if depth == model.cfg.num_layers else
               build_model(dataclasses.replace(model.cfg, num_layers=depth).validate()))
        eng = OffloadEngine(cut, {**params, "layers": params["layers"][:depth]},
                            hm.resident_config(cut.cfg))
        try:
            steps.append(hm.resident_step(eng, prompt, SIM_WARM))
            hi_bytes = eng.expert_bytes[PREC_HI]
            if cut is model:
                eng.start_sequence(16)
                for _ in range(2):          # the steps captured again after start
                    eng.decode_token(1)
                window = _profile(lambda: eng.decode_token(1), 8)
        finally:
            eng.close()
        del eng
        _free_engine()
    return steps, hi_bytes, window


def _step_split(steps, window, layers) -> dict:
    """Where the replay steps' wall goes, in ms per step and per MoE layer:
    the load stall (the host waiting on a copy), the compute kernels'
    device time (`window`: the same token stream replayed under the
    profiler) and the rest, the device idle with no load awaited: host
    work.  Capture steps are left out (their count and seconds beside)."""
    replay = [st for st in steps if not st["captures"]]
    n = len(replay)
    wall = sum(st["s"] for st in replay) / n * 1e3
    stall = sum(st["stall_s"] for st in replay) / n * 1e3
    kern = window.get("kernel_ms_per_step")
    split = {"replay_steps": n, "wall_ms": wall, "stall_ms": stall, "kernel_ms": kern,
             "host_ms": None if kern is None else wall - stall - kern,
             "copy_device_ms": window.get("copy_ms_per_step"),
             "profiled_wall_ms": window["step_ms"],
             "capture_steps": len(steps) - n,
             "capture_s": sum(st["s"] for st in steps if st["captures"])}
    for k in ("wall_ms", "stall_ms", "kernel_ms", "host_ms"):
        if split[k] is not None:
            split[k.replace("_ms", "_ms_per_layer")] = split[k] / layers
    return split


def phase_simulator(dev, model, params, serve_link_gbps=None) -> dict:
    """``core.host_model`` on the card.  (1) The two constants of the host
    model on the unconstrained configuration of phase 7d (every expert
    resident at bf16, no prefetch): the pinned copy rate of one hi expert,
    and the slope of the median load-free, capture-free ``decode_token``
    wall over the MoE layers of the model cut to SIM_DEPTHS (the intercept,
    work done once a step, beside it), with the device time per layer of a
    profiler window and the committed ``H100_HOST``.  (2) The default
    ``EngineConfig()`` at batch 1: a warm-up ``engine.generate``, then a
    48-token prompt and 32 new tokens, each step timed; the engine's
    counters of that sequence against the simulator's on the same trace
    (warm-up trace first, through one simulator: the engine's cache keeps
    its residents across ``start_sequence``, the simulator's across
    ``run``), under ``H100_HOST``, under this run's constants and with the
    compute constant replaced by the replay steps' wall less stall per
    layer.  The engine's tok/s is given over every step and over the replay
    steps (``start_sequence`` drops the graphs, so the first step captures
    them again; the timeline has no capture).  The same token stream is
    then replayed under the profiler, and the replay steps' wall split into
    load stall, compute kernels and host work.  (3) The four systems'
    simulated table on that trace (cold; one copy engine in prediction
    order, as the reference's benchmark builds it) with hobbit on the serve
    configuration beside it.  Gated: the kernels launched, finite positive
    constants, the simulated tokens x layers equal to the trace's.  The gap
    is measured, not gated.  `serve_link_gbps`: the serve phase's engine's
    startup link measurement, printed beside."""
    from repro_torch.core import PREC_LO, EngineConfig, OffloadEngine, precision_decisions
    from repro_torch.core import host_model as hm
    from repro_torch.core.simulator import H100_HOST, OffloadSimulator, simulate_systems
    from repro_torch.kernels import ops

    card = card_line()
    v = model.cfg.vocab_size
    rng = np.random.default_rng(SEED + 11)

    res_steps, hi_bytes, window = _resident_steps(model, params, rng.integers(0, v, SIM_WARM))
    hw, meas = hm.measure_hardware(res_steps, hi_bytes, dev, name="h100_measured")
    layers = sum(model.cfg.layer_is_moe())
    fixed = meas["step_fixed_s"]
    check(all(math.isfinite(x) and x > 0 for x in (hw.link_gbps, hw.compute_s_per_layer)),
          f"simulator: measured constants {hw}")
    dev_ms = window.get("kernel_ms_per_step")
    print(f"[simulator] ({card}) link_gbps: {hw.link_gbps:.2f} GB/s measured (pinned "
          f"{hi_bytes / 1e6:.1f} MB hi expert copy, best of 3), preset "
          f"{H100_HOST.link_gbps:.2f}, measured / preset "
          f"{hw.link_gbps / H100_HOST.link_gbps:.3f}"
          + (f"; the serve engine's startup measurement (64 MiB) {serve_link_gbps:.2f} GB/s"
             if serve_link_gbps is not None else ""), flush=True)
    depths = ", ".join(
        f"{s['moe_layers']} layers {s['median_step_s'] * 1e3:.3f} ms ({s['load_steps']} load / "
        f"{s['capture_steps']} capture steps of {len(s['step_s'])} left out)" for s in res_steps)
    print(f"[simulator] ({card}) compute_s_per_layer: {hw.compute_s_per_layer * 1e3:.3f} "
          f"ms measured, the slope of the median resident decode_token wall over depth "
          f"({depths}); work done once a step (intercept) {fixed * 1e3:.3f} ms; preset "
          f"{H100_HOST.compute_s_per_layer * 1e3:.3f} ms, measured / preset "
          f"{hw.compute_s_per_layer / H100_HOST.compute_s_per_layer:.3f}; compute kernels' "
          f"device time per layer at {layers} layers (profiler, 8 steps): "
          + (f"{dev_ms / layers:.3f} ms, busy share {window['device_busy_share']:.3f}"
             if dev_ms is not None else "not measured"), flush=True)

    ecfg = EngineConfig()
    eng = OffloadEngine(model, params, ecfg)
    try:
        warm = rng.integers(0, v, SIM_WARM)
        eng.generate([int(t) for t in warm], SIM_WARM)
        warm_trace = list(eng.trace)
        before = eng.stats()
        prompt = [int(t) for t in rng.integers(0, v, SIM_PROMPT)]
        ops.reset_dispatch_counts()
        tokens, steps = hm.timed_generate(eng, prompt, SIM_NEW)
        counts = ops.dispatch_counts()
        stats = eng.stats()
        trace = list(eng.trace)
        sim_cfg = hm.sim_config(ecfg, eng.expert_bytes)
        th = eng.loader.th
        # the same token stream again: its capture step, then the replay
        # steps under the profiler
        stream = prompt + tokens
        eng.start_sequence(len(stream) + 1)
        eng.decode_token(stream[0])
        feed = iter(stream[1:])
        captures = sum(n for k, n in ops.dispatch_counts().items() if k.endswith(".capture"))
        serve_window = _profile(lambda: eng.decode_token(next(feed)), len(stream) - 1)
        serve_window["captures"] = sum(n for k, n in ops.dispatch_counts().items()
                                       if k.endswith(".capture")) - captures
    finally:
        eng.close()
    del eng
    _free_engine()
    walls = [st["s"] for st in steps]
    measured = hm.sequence_counters(before, stats, walls)

    bad = {k: n for k, n in counts.items() if k.endswith(".torch")}
    check(not bad, f"simulator: plain versions ran: {bad}")
    for op in ("gating_topk", "stacked_gating", "grouped_matmul"):
        check(counts.get(f"{op}.cuda", 0) > 0, f"simulator: no {op} launch")
    lo_pairs = sum(int((precision_decisions(np.asarray(e.gate_vals), th) == PREC_LO).sum())
                   for tok in trace for e in tok)
    check(lo_pairs > 0 and stats["loads_lo"] > 0,
          f"simulator: the sequence served {lo_pairs} lo pairs, the engine loaded "
          f"{stats['loads_lo']} lo experts")
    for op in ("grouped_dequant_matmul", "grouped_dequant_combine"):
        check(counts.get(f"{op}.cuda", 0) > 0, f"simulator: no {op} launch")

    split = _step_split(steps, serve_window, layers)
    res_kernel = None if dev_ms is None else dev_ms / layers
    upgrade_gb = measured["upgrades"] * hi_bytes / 1e9
    print(f"[simulator] ({card}) where a replay step's wall goes on the serve configuration "
          f"(ms per step; kernels from the same token stream replayed under the profiler, "
          f"{serve_window['captures']} captures in that window; host = wall - stall - "
          f"kernels, the device idle with no load awaited): {json.dumps(split)}; resident "
          f"compute kernels per layer {res_kernel}; upgrades {measured['upgrades']} = "
          f"{upgrade_gb:.2f} GB of hi copies, {upgrade_gb / hw.link_gbps:.3f} s at the "
          f"measured link", flush=True)

    # the replay steps' wall less their load stall, per MoE layer: what a
    # layer costs on the serve configuration (host work included) where
    # compute_s_per_layer is the resident step's slope; a third simulation
    # takes it, to see what is left of the gap with it
    busy_s = (split["wall_ms"] - split["stall_ms"]) / 1e3 / layers
    serve_hw = dataclasses.replace(hw, name="serve_wall", compute_s_per_layer=busy_s)
    traces = [warm_trace, trace]
    sims = {name: hm.simulate_sequences(traces, layers, m, sim_cfg)[1]
            for name, m in (("h100_host", H100_HOST), ("measured", hw),
                            ("serve_wall", serve_hw))}
    # the paper's table as the reference's benchmark builds it: one copy
    # engine, transfers in prediction order (under the budgeted issue the
    # baselines, whose caches have no lo pool, would downgrade a prefetch
    # into it: CacheStarvation), beside hobbit as the engine serves
    table = simulate_systems(trace, layers, H100_HOST,
                             dataclasses.replace(sim_cfg, streams=1, ordered=True))
    table["hobbit (serve config)"] = OffloadSimulator(
        "hobbit", layers, H100_HOST, sim_cfg).run(trace)
    check(len(trace) == SIM_PROMPT + SIM_NEW and all(len(t) == layers for t in trace),
          f"simulator: trace of {len(trace)} tokens x {[len(t) for t in trace][:4]} layers")
    for name, res in [*((k, s["result"]) for k, s in sims.items()), *table.items()]:
        check(len(res["per_token_s"]) == len(trace),
              f"simulator: {name} covered {len(res['per_token_s'])} of {len(trace)} tokens")
    replay = [w for w, st in zip(walls, steps) if not st["captures"]]
    rows = {"measured": {**{k: measured[k] for k in SIM_KEYS},
                         "tok_s_replay": len(replay) / sum(replay),
                         "median_step_ms": statistics.median(walls) * 1e3,
                         "wall_less_stall_ms_per_layer": busy_s * 1e3}}
    for name, s in sims.items():
        per_token = s["result"]["per_token_s"]
        rows[f"simulated ({name})"] = {
            **{k: s[k] for k in SIM_KEYS},
            "median_step_ms": statistics.median(per_token) * 1e3}
        if name != "serve_wall":        # its constant holds the fixed work already
            rows[f"simulated ({name})"]["tok_s_with_step_fixed"] = (
                len(per_token) / (sum(per_token) + len(per_token) * fixed))
    print(f"[simulator] ({card}) one batch-1 sequence on the serve configuration "
          f"(EngineConfig(): hi {ecfg.hi_slots}, lo {ecfg.lo_slots}, streams "
          f"{ecfg.streams}, budgeted issue, upgrade on), {SIM_PROMPT}-token prompt + "
          f"{SIM_NEW} new tokens after a {SIM_WARM} + {SIM_WARM} warm-up.  The engine's "
          f"cache keeps its residents across start_sequence (records and pins reset) "
          f"where a new simulator starts cold, so the warm-up's trace and this "
          f"sequence's go through one simulator, its cache kept across runs; engine's "
          f"wall (tok_s over every step, tok_s_replay without the {split['capture_steps']} "
          f"capture steps, {split['capture_s']:.3f} s) against the simulator's timeline "
          f"for this sequence, simulated under H100_HOST, this run's constants (each also "
          f"with the step's fixed work, {fixed * 1e3:.3f} ms, added per token) and "
          f"serve_wall (this run's link, compute = the replay steps' wall less stall per "
          f"layer): {json.dumps(rows)}", flush=True)
    base = table["dense_layerwise"]["tok_per_s"]
    simulated = {name: {"tok_s": r["tok_per_s"], "speedup": r["tok_per_s"] / base,
                        "load_stall_s": r["load_stall_s"],
                        "overlap_fraction": r["overlap_fraction"],
                        "hit_ratio": r["cache"]["hit_ratio"]} for name, r in table.items()}
    print(f"[simulator] ({card}) simulated, H100_HOST, the sequence's trace from a cold "
          f"cache, the four systems with one copy engine in prediction order and hobbit "
          f"on the serve configuration (speedup over dense_layerwise): "
          f"{json.dumps(simulated)}", flush=True)
    return {"hardware": dataclasses.asdict(hw), "preset": dataclasses.asdict(H100_HOST),
            "measure": meas, "resident_steps": res_steps, "profile": window,
            "engine": measured, "split": split, "serve_profile": serve_window,
            "rows": rows, "systems": simulated, "tokens": tokens, "kernel_dispatch": counts}


# ---------------------------------------------------------------------------
# phase 8: Granite-3.0-2B at full width and depth through DenseBackend
# ---------------------------------------------------------------------------
DENSE_OPS = ("paged_flash_decode",)
DENSE_Q_OPS = ("paged_flash_decode", "dequant_matmul")


def _ffn_path(path, leaf) -> bool:
    del leaf
    return "ffn" in path


def phase_serve_dense(dev, model, params, label: str, must_launch, *, jit: bool = True,
                      paged: bool = True) -> dict:
    """DenseBackend(paged=True) at its defaults (64-token pages, 64-token
    prefill chunks, prefix sharing, the dense-equivalent pool; the decode
    step captured) under BatchingServer(max_batch=4): 6 greedy requests,
    prompts of 32-64 seeded tokens (the same for every call), 16 new tokens
    each.  `jit` False runs the decode step eagerly; `paged` False serves
    on the dense KV layout.  A captured run's step must replay its graph
    and never run eagerly."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import BackendConfig, make_backend
    from repro_torch.serving.batching import BatchingServer, Request

    cfg = model.cfg
    backend = make_backend(BackendConfig(kind="dense", jit=jit, paged=paged), model, params)
    rng = np.random.default_rng(SEED + 4)
    n_req, new_tokens, max_batch = 6, 16, 4
    probe = _FiniteLogits(backend)
    srv = BatchingServer(probe, max_batch=max_batch, max_len=64 + new_tokens + 8)
    for i in range(n_req):
        plen = int(rng.integers(32, 65))
        srv.submit(Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, plen),
                           max_new_tokens=new_tokens))
    ops.reset_dispatch_counts()
    t0 = time.perf_counter()
    srv.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = ops.dispatch_counts()
    dq_kernels = ops.dequant_mm_launches()
    st = srv.stats()
    srv.close()

    check(len(srv.completed) == n_req, f"{label}: {len(srv.completed)}/{n_req} requests done")
    outputs = {}
    for r in srv.completed:
        out = np.asarray(r.output)
        check(out.shape == (new_tokens,), f"{label} request {r.rid}: {out.shape} tokens")
        check(bool(((out >= 0) & (out < cfg.vocab_size)).all()),
              f"{label} request {r.rid}: token ids outside the vocabulary")
        outputs[r.rid] = out
    for op in must_launch:
        check(counts.get(f"{op}.cuda", 0) > 0, f"{label}: {op} never launched")
    bad = {k: v for k, v in counts.items() if k.endswith(".torch")}
    check(not bad, f"{label}: plain versions ran on the card: {bad}")
    if "dequant_matmul" in must_launch:
        # decode on the tensor-core decode kernel, chunked prefill on the
        # tensor-core prefill kernel, nothing on the gemv kernel
        for kern in ("mmv", "mma"):
            check(dq_kernels.get(kern, 0) > 0, f"{label}: the {kern} dequant-matmul kernel "
                                               "never launched")
        check(dq_kernels.get("gemv", 0) == 0, f"{label}: {dq_kernels.get('gemv', 0)} "
                                                 "launches on the gemv dequant-matmul kernel")
    if jit:
        _captured_path(counts, ["serve_step"], label)
        if paged:       # the chunked admissions: captured per (pending rows, chunk)
            check(counts.get("prefill_chunk.capture", 0) > 0
                  and counts.get("prefill_chunk.eager", 0) == 0,
                  f"{label}: prefill chunks not captured: "
                  f"{ {k: v for k, v in counts.items() if k.startswith('prefill_chunk.')} }")
            print(f"[{label}] prefill chunks [captures, replays]: "
                  f"[{counts['prefill_chunk.capture']}, "
                  f"{counts.get('prefill_chunk.graph', 0)}]", flush=True)
    else:
        check(not any(k.startswith(("serve_step.", "prefill_chunk.", "prefill."))
                      for k in counts),
              f"{label}: the eager backend went through a captured step")
    summary = {
        "requests": n_req, "new_tokens": new_tokens, "max_batch": max_batch,
        "layers": cfg.num_layers, "jit": jit, "paged": paged, "wall_s": wall,
        "decode_tok_s": st["decode_tok_s"], "decode_steps": len(probe.step_s),
        "median_step_ms": statistics.median(probe.step_s) * 1e3,
        "mean_prefill_s": st["mean_prefill_s"], "mean_decode_s": st["mean_decode_s"],
        "p99_ttft_s": st["p99_ttft_s"],
        "kernel_dispatch": counts, "dequant_matmul_kernels": dq_kernels,
    }
    if jit and not paged:   # the one-shot prefill captures only shapes that come back
        summary["prefill_calls"] = {k: v for k, v in counts.items() if k.startswith("prefill.")}
        summary["prefill_graphs"] = backend._prefill.step.graphs
        summary["prefill_graph_memory"] = _pool_bytes(backend._prefill.step.pool)
    print(f"[{label}] {cfg.name}, {cfg.num_layers} layers, {'captured' if jit else 'eager'} "
          f"step, {'paged' if paged else 'dense'} KV: wall {wall:.2f} s, "
          f"{st['decode_tok_s']:.1f} decode tok/s, median step "
          f"{summary['median_step_ms']:.2f} ms; {json.dumps(summary)}", flush=True)
    summary["outputs"] = outputs
    return summary


def _decode_window(model, params, steps: int = 3, *, jit: bool = True,
                   paged: bool = True) -> dict:
    """Where a decode step's time goes: DenseBackend(paged=paged, jit=jit)
    with 4 slots holding 48-token prompts, `steps` steps under
    torch.profiler (two steps before them warm up and capture); the kernels'
    device time (the summed time of every kernel event) over the steps'
    wall time gives the device's busy share; the kernel launches per step,
    the top kernels by device time and launches beside it, and the decode dequant-matmul
    kernel's own (1.39 ms per step on the gemv kernel before it, PERF.md).
    Reports "not measured" when the profiler records no device time.  The
    steps' logits come back under "logits" (popped by the caller)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving.api import DenseBackend

    be = DenseBackend(model, params, jit=jit, paged=paged)
    be.start_batch(4, 48 + steps + 8)
    rng = np.random.default_rng(SEED + 7)
    be.prefill(rng.integers(0, model.cfg.vocab_size, (4, 48)))
    tokens = rng.integers(0, model.cfg.vocab_size, (steps + 2, 4))
    logits = [be.step(tokens[t]) for t in range(2)]     # warm (and capture)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for t in range(2, steps + 2):
            logits.append(be.step(tokens[t]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # kernel events only: the CPU-side ops and runtime calls that launched
    # them carry the same device time again
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:8]
    if busy_us <= 0:
        return {"step_ms": wall / steps * 1e3, "device_busy_share": "not measured",
                "logits": np.stack(logits)}
    mmv = [e for e in events if "dequant_mmv_kernel" in e.key]
    return {"step_ms": wall / steps * 1e3, "device_ms_per_step": busy_us / steps / 1e3,
            "device_busy_share": busy_us / 1e6 / wall, "logits": np.stack(logits),
            "kernels_per_step": sum(e.count for e in events) / steps,
            "mmv_ms_per_step": sum(e.self_device_time_total for e in mmv) / steps / 1e3,
            "mmv_launches_per_step": sum(e.count for e in mmv) / steps,
            "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / steps / 1e3
                                        for e in top},
            "top_kernels_launches_per_step": {e.key[:60]: e.count / steps for e in top},
            "rest_ms_per_step": (busy_us - sum(e.self_device_time_total for e in top))
            / steps / 1e3}


# ---------------------------------------------------------------------------
# phase 8b: the captured decode step against the eager one
# ---------------------------------------------------------------------------
def _kernel_counts(counts) -> dict:
    """Per-op kernel launches, without the captured steps' own counters."""
    return {k: v for k, v in counts.items()
            if not k.startswith(("serve_step.", "prefill_chunk.", "prefill."))}


def phase_serve_dense_jit(dev, model, params, captured: dict) -> dict:
    """The quantized Granite's serve of phase 8 (`captured`: its run, the
    decode step a replayed CUDA graph) against the same serve with
    DenseBackend(jit=False): identical greedy outputs and equal per-op
    launch counts (a replay adds the launches its capture recorded); one
    more captured serve on the dense KV layout (its tokens' agreement with
    the paged run printed: attention takes another kernel there); the
    profiler window both ways, whose steps' logits must be equal (the same
    kernels on the same inputs: expect 0, held at DENSE_PARITY_ATOL); and
    ``decode.generate`` captured against eager, tokens equal.  Prints both
    runs' decode tok/s and median step wall (no profiler), with the card."""
    from repro_torch.serving import decode

    eager = phase_serve_dense(dev, model, params, "serve-dense-q4-eager", DENSE_Q_OPS,
                              jit=False)
    for rid, out in captured["outputs"].items():
        check(np.array_equal(out, eager["outputs"][rid]),
              f"serve-dense-jit: request {rid}: captured {out.tolist()} != eager "
              f"{eager['outputs'][rid].tolist()}")
    kc, ke = _kernel_counts(captured["kernel_dispatch"]), _kernel_counts(eager["kernel_dispatch"])
    check(kc == ke, f"serve-dense-jit: launches captured {kc} != eager {ke}")
    check(captured["dequant_matmul_kernels"] == eager["dequant_matmul_kernels"],
          f"serve-dense-jit: dequant kernels {captured['dequant_matmul_kernels']} != "
          f"{eager['dequant_matmul_kernels']}")
    dense_kv = phase_serve_dense(dev, model, params, "serve-dense-q4-dense-kv",
                                 ("dequant_matmul",), paged=False)
    same_kv = float(np.mean([np.mean(dense_kv["outputs"][r] == captured["outputs"][r])
                             for r in captured["outputs"]]))

    windows, logits = {}, {}
    for jit in (True, False):
        windows[jit] = _decode_window(model, params, jit=jit)
        logits[jit] = windows[jit].pop("logits")
    step_diff = float(np.abs(logits[True] - logits[False]).max())
    check(step_diff <= DENSE_PARITY_ATOL,
          f"serve-dense-jit: captured vs eager step logits differ by {step_diff}")

    rng = np.random.default_rng(SEED + 8)
    prompts = rng.integers(0, model.cfg.vocab_size, (4, 32))
    gen = {jit: decode.generate(model, params, prompts, 8, jit=jit) for jit in (True, False)}
    check(np.array_equal(gen[True].tokens, gen[False].tokens),
          f"decode.generate: captured {gen[True].tokens[:, 32:].tolist()} != eager "
          f"{gen[False].tokens[:, 32:].tolist()}")

    card = card_line()
    out = {
        "card": card, "outputs_equal": True, "launches_equal": True,
        "step_logits_max_abs_diff": step_diff, "dense_kv_tokens_equal_paged": same_kv,
        "captured": {k: captured[k] for k in ("decode_tok_s", "median_step_ms", "wall_s")},
        "eager": {k: eager[k] for k in ("decode_tok_s", "median_step_ms", "wall_s")},
        "dense_kv_captured": {k: dense_kv[k] for k in ("decode_tok_s", "median_step_ms",
                                                       "wall_s")},
        "window_captured": windows[True], "window_eager": windows[False],
        "generate": {"tokens_equal": True,
                     "captured_decode_tok_s": gen[True].decode_tok_s,
                     "eager_decode_tok_s": gen[False].decode_tok_s},
    }
    print(f"[serve-dense-jit] {card}: greedy outputs identical and per-op launches equal "
          f"(captured vs eager); step logits max |diff| {step_diff}; decode tok/s captured "
          f"{captured['decode_tok_s']:.1f} / eager {eager['decode_tok_s']:.1f}, median step "
          f"{captured['median_step_ms']:.2f} / {eager['median_step_ms']:.2f} ms; dense KV "
          f"captured {dense_kv['decode_tok_s']:.1f} tok/s, tokens equal to the paged run's "
          f"in {same_kv:.3f} of positions; decode.generate captured = eager; "
          f"{json.dumps(out)}", flush=True)
    return out


# ---------------------------------------------------------------------------
# phase 8c: the captured one-shot dense-KV prefill (models.prefill.DenseKVPrefill)
# ---------------------------------------------------------------------------
PREFILL_REPS = 21           # eager, capture, then the median of 19 replays
PREFILL_B, PREFILL_S = 4, 64


def _pool_bytes(pool) -> dict:
    """Device memory held by the graphs of a ``capture.GraphPool``: the
    reserved bytes of the allocator's segments in its pool and the bytes
    allocated in them (the graphs' static outputs), from the allocator's
    snapshot; "not measured" when the snapshot names no pools."""
    if pool.handle is None:
        return {"reserved_bytes": 0, "allocated_bytes": 0}
    segs = torch.cuda.memory._snapshot()["segments"]
    if segs and "segment_pool_id" not in segs[0]:
        return {"reserved_bytes": "not measured", "allocated_bytes": "not measured"}
    mine = [g for g in segs if tuple(g["segment_pool_id"]) == tuple(pool.handle)]
    return {"reserved_bytes": sum(g["total_size"] for g in mine),
            "allocated_bytes": sum(g["allocated_size"] for g in mine)}


def _cache_copy(be) -> list:
    """A copy of a backend's dense decode cache (DenseBackend's, or the
    offload engine's behind HobbitBackend)."""
    cache = be.engine.kv_cache if hasattr(be, "engine") else be.cache
    return [{n: b.clone() for n, b in c.items()} for c in cache]


def _prefill_series(be, prompts, joins) -> dict:
    """`be` on dense KV: PREFILL_REPS full-batch prefills of `prompts`, each
    after a start_batch (the prefill's graphs outlive it), then
    PREFILL_REPS one-row joins of joins[i] into slot i % B; the host wall
    of each call (each ends in its logits' readback), the last prefill's
    and the last join's logits, the cache after each series, the launches."""
    from repro_torch.kernels import ops

    b, s = prompts.shape
    ops.reset_dispatch_counts()
    out = {"prefill_ms": [], "join_ms": []}
    for _ in range(PREFILL_REPS):
        be.start_batch(b, s + 16)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = be.prefill(prompts)
        out["prefill_ms"].append((time.perf_counter() - t0) * 1e3)
    out["prefill_logits"], out["prefill_cache"] = lg, _cache_copy(be)
    for i in range(PREFILL_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lg = be.join(i % b, joins[i])
        out["join_ms"].append((time.perf_counter() - t0) * 1e3)
    out["join_logits"], out["join_cache"] = lg, _cache_copy(be)
    out["kernel_dispatch"] = ops.dispatch_counts()
    out["dequant_matmul_kernels"] = ops.dequant_mm_launches()
    return out


def _max_diff(a, b) -> float:
    if isinstance(a, np.ndarray):
        return float(np.abs(a - b).max())
    return max(float((x[n].float() - y[n].float()).abs().max()) for x, y in zip(a, b)
               for n in x)


def _prefill_compare(label, got, want, pool, must_launch=()) -> dict:
    """A captured series (`got`) against the eager one (`want`): each of the
    two prompt shapes (the batch's and the join's) run eagerly on its first
    call, captured on its second, replayed on every later one; logits and
    caches equal (the same kernels on the same inputs: expect 0, held at
    DENSE_PARITY_ATOL); the eager run's launches (a replay adds what its
    capture recorded).  Prints eager ms (median of PREFILL_REPS - 1), the
    first call's (eager), the capture's, the replays' (median of
    PREFILL_REPS - 2) and the graphs' memory."""
    counts = got["kernel_dispatch"]
    check(counts.get("prefill.eager", 0) == 2 and counts.get("prefill.capture", 0) == 2
          and counts.get("prefill.graph", 0) == 2 * PREFILL_REPS - 4,
          f"{label}: prefill steps { {k: v for k, v in counts.items() if 'prefill' in k} }")
    diff = {k: _max_diff(got[k], want[k]) for k in
            ("prefill_logits", "prefill_cache", "join_logits", "join_cache")}
    check(max(diff.values()) <= DENSE_PARITY_ATOL, f"{label}: captured vs eager {diff}")
    kc, ke = _kernel_counts(counts), _kernel_counts(want["kernel_dispatch"])
    check(kc == ke, f"{label}: launches captured {kc} != eager {ke}")
    check(got["dequant_matmul_kernels"] == want["dequant_matmul_kernels"],
          f"{label}: dequant kernels {got['dequant_matmul_kernels']} != "
          f"{want['dequant_matmul_kernels']}")
    for op in must_launch:
        check(counts.get(f"{op}.cuda", 0) > 0, f"{label}: {op} never launched")
    if "dequant_matmul" in must_launch:     # M = 256 and 64 rows: the prefill kernel only
        dq = got["dequant_matmul_kernels"]
        check(dq.get("mma", 0) == counts["dequant_matmul.cuda"],
              f"{label}: dequant-matmul kernels {dq}, not all the tensor-core prefill kernel")
    bad = {k: v for k, v in counts.items() if k.endswith(".torch")}
    check(not bad, f"{label}: plain versions ran on the card: {bad}")
    med = statistics.median
    out = {"max_abs_diff": diff, "kernel_dispatch": counts,
           "dequant_matmul_kernels": got["dequant_matmul_kernels"], "graphs": 2,
           "graph_memory": _pool_bytes(pool)}
    for kind in ("prefill_ms", "join_ms"):
        out[kind] = {"eager": med(want[kind][1:]), "first_call": got[kind][0],
                     "capture": got[kind][1], "replay": med(got[kind][2:])}
    p, j = out["prefill_ms"], out["join_ms"]
    print(f"[{label}] {PREFILL_B} x {PREFILL_S} prefill ms eager {p['eager']:.2f} / first "
          f"call {p['first_call']:.2f} / capture {p['capture']:.2f} / replay "
          f"{p['replay']:.2f}; one-row join ms eager {j['eager']:.2f} / first call "
          f"{j['first_call']:.2f} / capture {j['capture']:.2f} / replay {j['replay']:.2f}; "
          f"captured = eager (max |diff| {max(diff.values())}), launches equal; graphs "
          f"hold {out['graph_memory']}", flush=True)
    return out


def _prefill_inputs(cfg):
    rng = np.random.default_rng(SEED + 41)
    return (rng.integers(0, cfg.vocab_size, (PREFILL_B, PREFILL_S)),
            rng.integers(0, cfg.vocab_size, (PREFILL_REPS, PREFILL_S)))


def phase_prefill_capture(dev, model, params, label: str, must_launch=()) -> dict:
    """DenseBackend on dense KV, captured (jit=True) and eager (jit=False), on
    the same series (``_prefill_series``): a 4 x 64 prefill PREFILL_REPS
    times across start_batch, then PREFILL_REPS one-row 64-token joins;
    compared by ``_prefill_compare``; then one prefill of each kind under
    torch.profiler (kernels and device ms per prefill, the busy share)."""
    from repro_torch.serving.api import DenseBackend

    prompts, joins = _prefill_inputs(model.cfg)
    runs = {jit: (DenseBackend(model, params, jit=jit)) for jit in (True, False)}
    series = {jit: _prefill_series(be, prompts, joins) for jit, be in runs.items()}
    out = _prefill_compare(label, series[True], series[False], runs[True]._prefill.step.pool,
                           must_launch)
    for jit, be in runs.items():
        be.start_batch(PREFILL_B, PREFILL_S + 16)
        out["profile_captured" if jit else "profile_eager"] = _profile(
            lambda be=be: be.prefill(prompts), 3)
    out["card"] = card_line()
    print(f"[{label}] {out['card']}; per prefill captured "
          f"{json.dumps(out['profile_captured'])}, eager {json.dumps(out['profile_eager'])}",
          flush=True)
    return out


def _family_prefill(label, model, params, prompt_len: int = PREFILL_S) -> dict:
    """One B = 1 prefill of a seeded prompt through DenseBackend on dense KV,
    four times captured (eager, a capture, then two replays, a start_batch
    before each) and four times eagerly: the replays' logits and cache
    equal the eager call's (expect 0, held at DENSE_PARITY_ATOL), the same
    launches; first-call, capture, replay and eager ms and the graph's
    memory printed."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import DenseBackend

    prompt = np.random.default_rng(SEED + 42).integers(0, model.cfg.vocab_size,
                                                       (1, prompt_len))
    runs = {}
    for jit in (True, False):
        be = DenseBackend(model, params, jit=jit)
        ms = []
        ops.reset_dispatch_counts()
        for _ in range(4):
            be.start_batch(1, prompt_len + 8)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg = be.prefill(prompt)
            ms.append((time.perf_counter() - t0) * 1e3)
        runs[jit] = dict(ms=ms, logits=lg, cache=_cache_copy(be),
                         counts=ops.dispatch_counts(),
                         memory=_pool_bytes(be._prefill.step.pool) if jit else None)
        del be
    c, e = runs[True], runs[False]
    pf = {k: v for k, v in c["counts"].items() if k.startswith("prefill.")}
    check(pf == {"prefill.eager": 1, "prefill.capture": 1, "prefill.graph": 2},
          f"{label}: prefill steps {pf}")
    check(_kernel_counts(c["counts"]) == _kernel_counts(e["counts"]),
          f"{label}: launches captured {c['counts']} != eager {e['counts']}")
    diff = max(_max_diff(c["logits"], e["logits"]), _max_diff(c["cache"], e["cache"]))
    check(diff <= DENSE_PARITY_ATOL, f"{label}: captured vs eager prefill max |diff| {diff}")
    out = {"prompt": [1, prompt_len], "max_abs_diff": diff, "first_call_ms": c["ms"][0],
           "capture_ms": c["ms"][1], "replay_ms": c["ms"][2:], "eager_ms": e["ms"][1:],
           "graph_memory": c["memory"]}
    print(f"[{label}] B = 1 x {prompt_len} prefill ms first call {c['ms'][0]:.2f}, capture "
          f"{c['ms'][1]:.2f}, replays {c['ms'][2]:.2f} / {c['ms'][3]:.2f}, eager "
          f"{e['ms'][1]:.2f} / {e['ms'][2]:.2f}; captured = eager (max |diff| {diff}); "
          f"graph holds {c['memory']}", flush=True)
    return out


def phase_engine_prefill(dev, model, params) -> dict:
    """The offload engine's dense-KV prefill_batch and join on the Mixtral cut
    (HobbitBackend, EngineConfig defaults), captured, against the same
    series through DenseBackend(jit=False) on the same weights (the eager
    split prefill: the same forward, the same cache layout)."""
    from repro_torch.core import EngineConfig, OffloadEngine
    from repro_torch.serving.api import DenseBackend, HobbitBackend

    prompts, joins = _prefill_inputs(model.cfg)
    hob = HobbitBackend(OffloadEngine(model, params, EngineConfig()))
    try:
        got = _prefill_series(hob, prompts, joins)
        pool = hob.engine._prefill.step.pool
        out = _prefill_compare("engine-prefill", got,
                               _prefill_series(DenseBackend(model, params, jit=False),
                                               prompts, joins), pool)
    finally:
        hob.close()
    del hob
    _free_engine()
    return out


def _tree_to(tree, device):
    """A parameter tree (dicts, lists, tensors, QTensors) on `device`."""
    from repro_torch.quant.quantize import QTensor
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    if isinstance(tree, QTensor):
        return dataclasses.replace(tree, data=tree.data.to(device),
                                   scale=tree.scale.to(device))
    return tree.to(device)


# ---------------------------------------------------------------------------
# phase 9: the quantized Granite on the card against the CPU
# ---------------------------------------------------------------------------
DENSE_PARITY_ATOL = 0.1


def _card_cpu_parity(label, model, params, must_launch, *, b, s, steps, seed,
                     paged: bool = True, gate: bool = True) -> dict:
    """`model` through DenseBackend(paged=paged) on the card (kernels) and on
    the CPU (plain versions) with the same weights: an s-token prefill and
    `steps` teacher-forced decode steps for b rows, per-step logits within
    DENSE_PARITY_ATOL (`gate` False: measured and printed only)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.api import DenseBackend

    cfg = model.cfg
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab_size, (b, s))
    teacher = rng.integers(0, cfg.vocab_size, (steps, b))
    runs, counts = {}, {}
    for where in ("cuda", "cpu"):
        p = params if where == "cuda" else _tree_to(params, "cpu")
        be = DenseBackend(model, p, paged=paged)
        be.start_batch(b, s + steps + 4)
        ops.reset_dispatch_counts()
        t0 = time.perf_counter()
        runs[where] = [be.prefill(prompts)] + [be.step(teacher[t]) for t in range(steps)]
        counts[where] = ops.dispatch_counts()
        print(f"[{label}] {where}: prefill + {steps} steps in "
              f"{time.perf_counter() - t0:.1f} s, launches {counts[where]}", flush=True)
        del be, p
        gc.collect()
    for op in must_launch:
        check(counts["cuda"].get(f"{op}.cuda", 0) > 0, f"{label}: {op} not launched")
    worst, same = 0.0, 0
    for i, (lc, lh) in enumerate(zip(runs["cuda"], runs["cpu"])):
        check(bool(np.isfinite(lc).all()), f"{label} step {i}: non-finite logits")
        e = float(np.abs(lc - lh).max())
        worst = max(worst, e)
        same += int((lc.argmax(-1) == lh.argmax(-1)).sum())
        check(e <= DENSE_PARITY_ATOL or not gate, f"{label} step {i}: max |card - CPU| = "
                                                  f"{e:.4f} > {DENSE_PARITY_ATOL}")
    spread = float(np.std(runs["cpu"][0]))
    bar = f"<= {DENSE_PARITY_ATOL}" if gate else "(measured, not gated)"
    print(f"[{label}] {cfg.name}, {cfg.num_layers} layers, {cfg.dtype}: {steps + 1} steps "
          f"(prefill + {steps} decode) x {b} rows: max |card - CPU| = {worst:.4g} {bar} "
          f"(logit std {spread:.3f}); greedy tokens equal in {same}/{(steps + 1) * b}",
          flush=True)
    return {"max_abs_diff": worst, "logit_std": spread, "argmax_equal": same,
            "compared": (steps + 1) * b, "dtype": cfg.dtype, "layers": cfg.num_layers,
            "gated": gate}


def phase_dense_parity(dev) -> dict:
    """Granite-3.0-2B at full width, depth cut to 4 layers, seeded bf16
    weights with 4-bit FFN weights (quantize_tree), through
    DenseBackend(paged=True) on the card (kernels) and on the CPU (plain
    versions): a 100-token prefill (two pages) and 4 teacher-forced decode
    steps for 2 rows.  Both sides compute in bf16 with float32 products and
    round in different places (cuBLAS and the CPU's GEMMs, the kernels' sum
    orders); per-step logits must agree within DENSE_PARITY_ATOL = 0.1, as
    in phases 5 and 7."""
    from repro_torch.models import build_model
    from repro_torch.quant.quantize import QTensor, quantize_tree

    cfg = dataclasses.replace(granite_full(), num_layers=4).validate()
    model = build_model(cfg)
    params = quantize_tree(model.init(SEED + 5, device=dev), bits=4, predicate=_ffn_path)
    check(all(isinstance(lp["ffn"][w], QTensor) for lp in params["layers"]
              for w in ("wi", "wo")), "dense parity: FFN weights not quantized")
    return _card_cpu_parity("dense-parity", model, params, DENSE_Q_OPS, b=2, s=100, steps=4,
                            seed=SEED + 6)


def granite_full():
    from repro_torch.configs import get_config
    return get_config(GRANITE)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi prints them."""
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]


def host_available_gb() -> float:
    """MemAvailable of the host, in GB."""
    with open("/proc/meminfo") as f:
        for line in f:
            if line.startswith("MemAvailable:"):
                return int(line.split()[1]) * 1024 / 1e9
    return float("nan")


# ---------------------------------------------------------------------------
# phase 10: Nemotron-4-15B at full width and depth through DenseBackend
# ---------------------------------------------------------------------------
def _logits_cast(model, params) -> dict:
    """Device ms of what ``Model.logits`` spends on the head (the untied
    ``lm_head``, or the tied embeddings' transpose): its float32 cast (reads
    the bf16 head, writes a float32 copy), the whole logits call at 4 rows,
    and the bf16 head's product alone beside them (CUDA events around 5
    calls each, one warm-up)."""
    from repro_torch.models import layers

    cfg = model.cfg
    w = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    g = torch.Generator(device=w.device).manual_seed(SEED + 14)
    x = torch.randn((4, 1, cfg.d_model), generator=g, device=w.device).to(w.dtype)
    h = layers.apply_norm(params["final_norm"], x, cfg)
    cast = cuda_ms(lambda: w.to(torch.float32), warmup=1, iters=5)
    logits = cuda_ms(lambda: model.logits(params, x), warmup=1, iters=5)
    head_bf16 = cuda_ms(lambda: h @ w, warmup=1, iters=5)
    cast_bound, _ = bound(3 * nbytes(w), 0)
    return {"cast_ms": cast, "cast_bound_ms": cast_bound, "logits_ms": logits,
            "head_bf16_matmul_ms": head_bf16, "head_gb": nbytes(w) / 1e9}


def phase_serve_full(dev, model, params, label: str, must_launch, *,
                     paged: bool = True) -> dict:
    """Phase 8's serve (DenseBackend(paged=paged), captured step,
    BatchingServer(max_batch=4), 6 greedy requests of 32-64 prompt tokens, 16
    new tokens each) on a model at full width and depth (Nemotron-4-15B on
    paged KV, Gemma-2-27B on dense KV with ring caches), with the device's
    peak memory over the serve (max_memory_allocated), then a 3-step
    profiler window (busy share, top kernels) and the logits' float32 head
    cast timed alone."""
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    run = phase_serve_dense(dev, model, params, label, must_launch, paged=paged)
    run["peak_allocated_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    run["peak_reserved_gb"] = torch.cuda.max_memory_reserved(dev) / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    window = _decode_window(model, params, paged=paged)
    window.pop("logits")
    gc.collect()
    torch.cuda.empty_cache()
    run["window"] = window
    run["logits_cast"] = _logits_cast(model, params)
    run["card"] = card_line()
    out = {k: run[k] for k in ("decode_tok_s", "median_step_ms", "wall_s", "peak_allocated_gb",
                               "peak_reserved_gb", "window", "logits_cast", "card")}
    print(f"[{label}] {run['card']}: {run['decode_tok_s']:.1f} decode tok/s, median step "
          f"{run['median_step_ms']:.2f} ms, peak allocated {run['peak_allocated_gb']:.1f} GB; "
          f"{json.dumps(out)}", flush=True)
    return run


def _quantize_ffn_in_place(params, predicate=None) -> None:
    """Each layer's FFN weights (those `predicate(path in the FFN, leaf)`
    takes; without one, every weight, checked) replaced by 4-bit QTensors
    (group 128), one layer at a time, so the bf16 weights are freed as they
    go; a layer without an FFN is skipped."""
    from repro_torch.quant.quantize import QTensor, quantize_tree
    for lp in params["layers"]:
        if "ffn" not in lp:
            continue
        lp["ffn"] = quantize_tree(lp["ffn"], bits=4, predicate=predicate)
        check(predicate is not None or all(isinstance(w, QTensor) for w in lp["ffn"].values()),
              "FFN weights not quantized")


# ---------------------------------------------------------------------------
# phase 10b: Nemotron-4-15B on the card against the CPU
# ---------------------------------------------------------------------------
NEMOTRON_PARITY_LAYERS = 2


def phase_nemotron_parity(dev) -> dict:
    """Nemotron-4-15B at full width, depth cut to 2 layers, seeded bf16
    weights (layernorm, squared ReLU, the untied 6144 x 256000 head),
    through DenseBackend(paged=True) on the card (paged flash decode at
    g = 6) and on the CPU (plain versions): an 80-token prefill (two pages)
    and 4 teacher-forced decode steps for 2 rows, per-step logits within
    DENSE_PARITY_ATOL, as phase 9.  About 8 GB of weights on the host; its
    free memory is printed first."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    print(f"[nemotron-parity] host memory available: {host_available_gb():.1f} GB",
          flush=True)
    cfg = dataclasses.replace(get_config(NEMOTRON),
                              num_layers=NEMOTRON_PARITY_LAYERS).validate()
    model = build_model(cfg)
    params = model.init(SEED + 9, device=dev)
    return _card_cpu_parity("nemotron-parity", model, params, DENSE_OPS, b=2, s=80, steps=4,
                            seed=SEED + 10)


# ---------------------------------------------------------------------------
# phase 11: InternVL2-26B with its vision-patch prefix
# ---------------------------------------------------------------------------
INTERNVL_LAYERS = 8


def _prefix_steps(model, params, batch, tokens, max_len, *, jit: bool):
    """Prefill `batch` (prefix + prompt) into a dense cache, then feed
    `tokens` (B, T) one step at a time, the step captured or eager, as
    ``decode.generate`` runs it; returns each step's logits on the host."""
    from repro_torch.capture import CapturedStep, addresses
    from repro_torch.device import to_device, to_host
    from repro_torch.serving import decode

    lg, cache, pos = decode.make_prefill_step(model, max_len)(params, batch)
    serve_step = decode.make_serve_step(model)

    def step(tok, p):
        return serve_step(params, cache, tok, p)[0]

    captured = CapturedStep(step, "serve_step") if jit else None
    key = addresses(c[n] for c in cache for n in ("k", "v"))
    out = [to_host(lg.float())[0]]
    dev = params["embed"].device
    for t in range(tokens.shape[1]):
        args = (to_device(tokens[:, t:t + 1], dev), to_device(pos, dev))
        lg = step(*args) if captured is None else captured(*args, key=key)
        out.append(to_host(lg.float())[0])
        pos = pos + 1
    return np.stack(out)


def phase_internvl2(dev) -> dict:
    """InternVL2-26B at full width, depth cut to 8 layers, seeded bf16
    weights and 256 seeded patch embeddings per row: ``decode.generate``
    with the prefix (extra={"prefix_embeds": ...}) captured against eager,
    greedy tokens equal; the same prefill and greedy tokens fed step by step
    through the captured and the eager step, every step's logits equal; then
    a text-only paged serve under BatchingServer, counting the g = 6
    flash-decode launches."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model
    from repro_torch.models.model import Batch
    from repro_torch.serving import decode

    cfg = dataclasses.replace(get_config(INTERNVL), num_layers=INTERNVL_LAYERS).validate()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED + 11, device=dev)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    rng = np.random.default_rng(SEED + 12)
    b, s, new = 2, 32, 8
    prompts = rng.integers(0, cfg.vocab_size, (b, s))
    g = torch.Generator(device=dev).manual_seed(SEED + 13)
    prefix = torch.randn((b, cfg.num_prefix_tokens, cfg.d_model), generator=g,
                         device=dev) * 0.5
    gen = {jit: decode.generate(model, params, prompts, new, jit=jit,
                                extra={"prefix_embeds": prefix}) for jit in (True, False)}
    check(np.array_equal(gen[True].tokens, gen[False].tokens),
          f"internvl2 decode.generate with the prefix: captured "
          f"{gen[True].tokens[:, s:].tolist()} != eager {gen[False].tokens[:, s:].tolist()}")
    batch = Batch(tokens=torch.as_tensor(prompts, device=dev),
                  loss_mask=torch.ones((b, s), device=dev), prefix_embeds=prefix)
    max_len = cfg.num_prefix_tokens + s + new + 1
    fed = gen[True].tokens[:, s:s + new - 1]
    logits = {jit: _prefix_steps(model, params, batch, fed, max_len, jit=jit)
              for jit in (True, False)}
    diff = float(np.abs(logits[True] - logits[False]).max())
    check(diff == 0.0, f"internvl2: captured and eager step logits differ by {diff}")
    check(bool(np.isfinite(logits[True]).all()), "internvl2: non-finite logits")
    greedy = np.argmax(logits[True], axis=-1).T                   # (B, new)
    check(np.array_equal(greedy, gen[True].tokens[:, s:]),
          "internvl2: the fed steps' greedy tokens differ from decode.generate's")
    print(f"[internvl2] {cfg.name} at full width, {cfg.num_layers} layers, bf16 weights "
          f"seeded in {seed_s:.1f} s; {cfg.num_prefix_tokens} patch embeddings + {s} prompt "
          f"tokens x {b} rows: decode.generate captured = eager ({new} tokens; "
          f"{gen[True].decode_tok_s:.1f} / {gen[False].decode_tok_s:.1f} decode tok/s), "
          f"{new} steps' logits captured = eager (max |diff| {diff})", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_serve_dense(dev, model, params, "serve-internvl2", DENSE_OPS)
    return {"seed_s": seed_s, "generate_tokens_equal": True, "step_logits_max_abs_diff": diff,
            "generate_decode_tok_s": {"captured": gen[True].decode_tok_s,
                                      "eager": gen[False].decode_tok_s},
            "serve": serve}


def phases_48_8(dev):
    """Phases 10, 10b and 11: Nemotron-4-15B at full width and depth served
    in bf16 and with 4-bit FFN weights (quantized in place, the bf16 FFN
    freed first), the 2-layer card-against-CPU parity, and InternVL2-26B.
    Returns the two Nemotron serves' and the InternVL2 phase's results."""
    from repro_torch.configs import get_config
    from repro_torch.models import build_model

    ncfg = get_config(NEMOTRON)
    nmodel = build_model(ncfg)
    t0 = time.perf_counter()
    nparams = nmodel.init(SEED, device=dev)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    print(f"[serve-nemotron] {ncfg.name} at full width and depth ({ncfg.num_layers} layers), "
          f"bf16 random weights (seed {SEED}) in {seed_s:.1f} s, "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card", flush=True)
    with phase("serve-nemotron"):
        nem = phase_serve_full(dev, nmodel, nparams, "serve-nemotron", DENSE_OPS)
    with phase("prefill-nemotron"):
        nem["prefill_capture"] = _family_prefill("prefill-nemotron", nmodel, nparams)
    t0 = time.perf_counter()
    _quantize_ffn_in_place(nparams)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve-nemotron-q4] FFN weights of {ncfg.num_layers} layers quantized to 4 bits "
          f"(group 128) on the card in {quant_s:.1f} s, bf16 FFN freed: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card", flush=True)
    with phase("serve-nemotron-q4"):
        nem_q = phase_serve_full(dev, nmodel, nparams, "serve-nemotron-q4", DENSE_Q_OPS)
    agree = float(np.mean([np.mean(nem["outputs"][r] == nem_q["outputs"][r])
                           for r in nem["outputs"]]))
    print(f"[serve-nemotron-q4] seed {seed_s:.1f} s, quantize {quant_s:.1f} s; greedy tokens "
          f"equal to the bf16 run's in {agree:.3f} of positions", flush=True)
    del nmodel, nparams
    gc.collect()
    torch.cuda.empty_cache()
    with phase("nemotron-parity"):
        phase_nemotron_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("internvl2"):
        ivl = phase_internvl2(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return nem, nem_q, ivl


# ---------------------------------------------------------------------------
# phases 12-12d: the windowed family on dense KV with ring caches
# ---------------------------------------------------------------------------
GEMMA2_PARITY_LAYERS = 2
GEMMA3_LAYERS = 12
LLAMA4_LAYERS = 8
RING_ATOL = DENSE_PARITY_ATOL
WINDOWED_Q_OPS = ("dequant_matmul",)


def _seeded(cfg, seed: int, dev, label: str):
    """(model, seeded parameters in the config's dtype on the card, seconds
    to seed them)."""
    from repro_torch.models import build_model
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(seed, device=dev)
    torch.cuda.synchronize()
    seed_s = time.perf_counter() - t0
    print(f"[{label}] {cfg.name} at full width, {cfg.num_layers} layers "
          f"({cfg.param_count() / 1e9:.2f} B parameters), {cfg.dtype} random weights (seed {seed}) "
          f"in {seed_s:.1f} s, {torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card",
          flush=True)
    return model, params, seed_s


@contextlib.contextmanager
def _recording_routes():
    """Collects the top-k expert ids (T, k) of every MoE router call made
    inside the block, in call order."""
    from repro_torch.models import moe
    seen, route = [], moe.route

    def recording(router_w, x_flat, mc):
        r = route(router_w, x_flat, mc)
        seen.append(r.top_idx)
        return r

    moe.route = recording
    try:
        yield seen
    finally:
        moe.route = route


def _ring_check(label, model, params, prompt_len: int, max_len: int, steps: int,
                seed: int, *, gate: bool = True, routes_at: Optional[int] = None,
                routes_over: Optional[float] = None, frames=None) -> dict:
    """A seeded prompt of `prompt_len` tokens prefilled into dense caches of
    max_len (windowed layers: rings of min(max_len, window) slots), then
    `steps` teacher-forced decode steps through a captured step
    (``decode.make_serve_step`` under ``CapturedStep``, as
    ``decode.generate`` runs it), crossing the ring's wrap or the chunk
    boundary; the prefill's and every step's logits against ``Model.forward``
    over the same tokens, greedy agreement printed.  `gate`: each position
    must agree within RING_ATOL (the float32 models); otherwise the gap is
    measured and printed only (a bf16 model: a one-row step's products round
    to bf16 otherwise than the forward's, and a top-1 MoE can route a token
    to another expert on that difference).  `routes_at`: a decoded position
    whose experts per MoE layer (the top-k in rank order) are printed for
    the step (the step again, eagerly, from a copy of the cache it started
    from) and for the forward; `routes_over`: the same at every decoded
    position whose gap exceeds it.  An MLA model's latent cache and an SSM
    layer's state pass through the same way; a Whisper model takes its
    audio `frames` (1, F, d_enc) in the prefill and in the forward."""
    from repro_torch.capture import CapturedStep, addresses
    from repro_torch.device import to_device, to_host
    from repro_torch.kernels import ops
    from repro_torch.models.model import Batch
    from repro_torch.serving import decode

    cfg = model.cfg
    dev = params["embed"].device
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, (1, prompt_len + steps))

    def batch(t):
        if frames is None:
            return to_device(t, dev)
        return Batch(tokens=to_device(t, dev), loss_mask=torch.ones(t.shape, device=dev),
                     audio_frames=to_device(frames, dev))

    t0 = time.perf_counter()
    lg, cache, pos = model.prefill(params, batch(toks[:, :prompt_len]), max_len)
    got = [to_host(lg)[0]]
    prefill_s = time.perf_counter() - t0
    serve_step = decode.make_serve_step(model)
    captured = CapturedStep(lambda tok, p: serve_step(params, cache, tok, p)[0], "serve_step")
    key = addresses(buf for c in cache for buf in c.values())
    before = {}         # position -> (a copy of the cache the step started from, token, pos)
    ops.reset_dispatch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        tok = to_device(toks[:, prompt_len + i:prompt_len + i + 1], dev)
        if prompt_len + i == routes_at or routes_over is not None:
            before[prompt_len + i] = ([{n: b.clone() for n, b in c.items()} for c in cache],
                                      tok, pos)
        got.append(to_host(captured(tok, to_device(pos, dev)))[0])
        pos = pos + 1
    decode_s = time.perf_counter() - t0
    _captured_path(ops.dispatch_counts(), ["serve_step"], label)
    rings = sorted({int(next(iter(c.values())).shape[1]) for c in cache if "h" not in c})
    del captured, cache
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    with _recording_routes() as seen:
        x, _, _ = model.forward(params, batch(toks))
    forward_routes = [t.tolist() for t in seen]
    del seen
    want = to_host(model.logits(params, x[:, prompt_len - 1:]))[0][0]   # (steps + 1, V)
    forward_s = time.perf_counter() - t0
    del x
    got = np.concatenate(got)                                           # (steps + 1, V)
    check(bool(np.isfinite(got).all()), f"{label}: non-finite logits")
    diffs = np.abs(got - want).max(axis=-1)
    same = int((got.argmax(-1) == want.argmax(-1)).sum())
    for i, e in enumerate(diffs):
        check(e <= RING_ATOL or not gate, f"{label}: logits at position {prompt_len - 1 + i} "
                                          f"differ from Model.forward by {e:.4f} > {RING_ATOL}")
    out = {"dtype": cfg.dtype, "gated": gate, "prompt_len": prompt_len, "max_len": max_len,
           "steps": steps, "max_abs_diff_by_position": diffs.tolist(),
           "positions": [prompt_len - 1, prompt_len + steps - 1], "cache_rows": rings,
           "max_abs_diff": float(diffs.max()), "logit_std": float(np.std(want)),
           "argmax_equal": same, "compared": steps + 1, "prefill_s": prefill_s,
           "decode_ms_per_step": decode_s / steps * 1e3, "forward_s": forward_s}
    wanted = ([routes_at] if routes_at is not None else
              [prompt_len - 1 + i for i, e in enumerate(diffs)
               if i > 0 and routes_over is not None and e > routes_over])
    routes = []
    for at in wanted:
        cache_copy, tok, p = before.pop(at)
        with _recording_routes() as seen:
            again = model.decode_step(params, cache_copy, tok, to_device(p, dev))
        step_routes = [t[0].tolist() for t in seen]
        fwd = [r[at] for r in forward_routes]
        flips = [i for i, (a, b) in enumerate(zip(step_routes, fwd)) if sorted(a) != sorted(b)]
        routes.append({"position": at, "step": step_routes, "forward": fwd,
                       "eager_step_vs_captured": float(np.abs(
                           to_host(again)[0] - got[at - prompt_len + 1]).max()),
                       "layers_differing": flips, "gap": float(diffs[at - prompt_len + 1])})
        print(f"[{label}] top-{cfg.moe.top_k} experts per MoE layer at position {at} "
              f"(gap {diffs[at - prompt_len + 1]:.4g}): step {step_routes}, forward {fwd}; "
              + (f"the expert sets differ in MoE layers {flips}" if flips
                 else "the same in every layer"), flush=True)
        del cache_copy, again
    del before
    if routes_at is not None or routes_over is not None:
        out["routes"] = routes
    bar = f"<= {RING_ATOL}" if gate else "(measured, not gated)"
    print(f"[{label}] {cfg.name}, {cfg.num_layers} layers, {cfg.dtype}: prefill {prompt_len} "
          f"tokens (cache rows {rings}), {steps} captured decode steps through positions "
          f"{prompt_len}-{prompt_len + steps - 1} against Model.forward over "
          f"{prompt_len + steps} tokens: max |diff| {diffs.max():.4g} {bar} (logit std "
          f"{out['logit_std']:.3f}), greedy equal {same}/{steps + 1}; {json.dumps(out)}",
          flush=True)
    return out


def phase_gemma2_parity(dev) -> dict:
    """Gemma-2-27B at full width, depth cut to 2 layers (one sliding-window,
    one global), seeded bf16 weights, through DenseBackend on dense KV with
    ring caches on the card and on the CPU: a 48-token prefill and 4
    teacher-forced decode steps for 2 rows, per-step logits within
    DENSE_PARITY_ATOL, as phases 9 and 10b.  About 4.6 GB of weights on the
    host."""
    from repro_torch.configs import get_config

    print(f"[gemma2-parity] host memory available: {host_available_gb():.1f} GB",
          flush=True)
    cfg = dataclasses.replace(get_config(GEMMA2), num_layers=GEMMA2_PARITY_LAYERS).validate()
    check(cfg.layer_kinds() == ("attn_local", "attn"), f"gemma2-parity: {cfg.layer_kinds()}")
    model, params, _ = _seeded(cfg, SEED + 15, dev, "gemma2-parity")
    return _card_cpu_parity("gemma2-parity", model, params, (), b=2, s=48, steps=4,
                            seed=SEED + 16, paged=False)


def phase_ring_gemma3(dev) -> dict:
    """Gemma-3-27B at full width (5376 wide, 32/16 heads of 128, qk-norm,
    window 1024), depth cut to 12 layers (two 5:1 blocks): the ring checked
    across its wrap (a 1020-token prompt, max_len 1100, decode through
    position 1029) and filled by a prompt longer than the window (1040
    tokens), each step against Model.forward within RING_ATOL in float32
    weights (25 GB; there decode equals the forward up to float32 sum order,
    so a misplaced key shows); then the bf16 model (13 GB): the same 1020-
    token run with its gap to the forward measured, and the short-prompt
    serve of phase 8 on dense KV."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(GEMMA3), num_layers=GEMMA3_LAYERS).validate()
    model, params, _ = _seeded(dataclasses.replace(cfg, dtype="float32"), SEED + 17, dev,
                               "ring-gemma3")
    runs = [_ring_check("ring-gemma3", model, params, n, 1100, 10, SEED + 18 + i)
            for i, n in enumerate((1020, 1040))]
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    model, params, seed_s = _seeded(cfg, SEED + 17, dev, "ring-gemma3")
    bf16 = _ring_check("ring-gemma3", model, params, 1020, 1100, 10, SEED + 18, gate=False)
    gc.collect()
    torch.cuda.empty_cache()
    serve = phase_serve_dense(dev, model, params, "serve-gemma3", (), paged=False)
    return {"seed_s": seed_s, "ring": runs, "ring_bf16": bf16, "serve": serve}


def _nodrop(cfg):
    """The model of `cfg` at capacity factor E / top_k, where no token can
    be dropped (a long forward at the published factor drops tokens a
    one-token step keeps; the weights are the same)."""
    from repro_torch.models import build_model
    return build_model(dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k)))


def _hobbit_refusal(label, model, params, must_contain: str) -> str:
    """HobbitBackend's refusal of `model`, which must contain `must_contain`."""
    from repro_torch.serving.api import BackendConfig, make_backend
    try:
        make_backend(BackendConfig(kind="hobbit"), model, params)
    except ValueError as e:
        refusal = str(e)
    else:
        fail(f"{label}: HobbitBackend took {model.cfg.name}")
    check(must_contain in refusal, f"{label}: refusal {refusal!r}")
    print(f"[{label}] HobbitBackend refuses it: {refusal}", flush=True)
    return refusal


LLAMA4_CHUNK_LAYERS = 4


def phase_llama4(dev) -> dict:
    """Llama-4-Scout-17B-16E at full width (5120 wide, 40/8 heads of 128, 16
    experts of d_ff 8192 at top-1 beside a shared expert, chunk 8192), depth
    cut to 8 layers (two 3 chunked : 1 global blocks, 37 GB of bf16): the
    serve of phase 8 on dense KV, HobbitBackend's refusal, and the chunk
    boundary (an 8188-token prompt, max_len 8200, 8 decode steps through
    position 8195) with its gap to Model.forward measured; then the chunk
    boundary held to Model.forward within RING_ATOL in float32 weights, at
    full width cut to 4 layers (one 3 : 1 block, 39 GB: 8 float32 layers
    would take 75 GB).  The chunk checks run at capacity factor E / top_k =
    16, where no token can be dropped (at the published 1.5 an 8196-token
    forward drops tokens a one-token step keeps; the weights are the
    same)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(LLAMA4), num_layers=LLAMA4_LAYERS).validate()
    model, params, seed_s = _seeded(cfg, SEED + 20, dev, "llama4-scout")
    serve = phase_serve_dense(dev, model, params, "serve-llama4", (), paged=False)
    serve["prefill_capture"] = _family_prefill("prefill-llama4", model, params)
    gc.collect()
    torch.cuda.empty_cache()
    refusal = _hobbit_refusal("llama4-scout", model, params,
                              "full-window 'attn' layers only")
    bf16 = _ring_check("chunk-llama4", _nodrop(cfg), params, 8188, 8200, 8, SEED + 21,
                       gate=False, routes_at=8193)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    f32 = dataclasses.replace(cfg, num_layers=LLAMA4_CHUNK_LAYERS, dtype="float32").validate()
    _, params, _ = _seeded(f32, SEED + 20, dev, "chunk-llama4")
    chunk = _ring_check("chunk-llama4", _nodrop(f32), params, 8188, 8200, 8, SEED + 21)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"seed_s": seed_s, "serve": serve, "chunk": chunk, "chunk_bf16": bf16,
            "hobbit_refusal": refusal}


# ---------------------------------------------------------------------------
# phases 13-13c: DeepSeek-V2-236B (MLA, a dense first layer, shared experts)
# ---------------------------------------------------------------------------
DEEPSEEK_LAYERS = 4
DEEPSEEK_PARITY_LAYERS = 2
DEEPSEEK_Q_OPS = ("dequant_matmul",)


def _dense_and_shared_ffn(path, leaf) -> bool:
    """The 2-D FFN leaves of a layer's FFN (the dense layer's, the shared
    experts'), not the routed experts or the router."""
    del leaf
    return "experts" not in path and "router" not in path


def _mla_cache_and_casts(model, params) -> dict:
    """The latent cache's bytes per token per layer (c_kv and k_rope), the
    bytes an uncompressed K (nope + rope wide) and V of every head would
    take, and the device
    ms per decode step of the absorbed decode's float32 casts of w_uk and
    w_uv in every layer (CUDA events around 5 calls, one warm-up), beside
    their bytes bound (bf16 read, float32 written)."""
    cfg = model.cfg
    dev = params["embed"].device
    cache = model.init_cache(1, 8, dev)[0]
    per_token = sum(t.element_size() * t.shape[-1] for t in cache.values())
    m = cfg.mla
    mats = [lp["attn"][w] for lp in params["layers"] for w in ("w_uk", "w_uv")]
    cast = cuda_ms(lambda: [w.to(torch.float32) for w in mats], warmup=1, iters=5)
    cast_bound, _ = bound(3 * nbytes(*mats), 0)
    kv = cfg.num_heads * (m.nope_head_dim + m.rope_head_dim + m.v_head_dim)
    return {"latent_bytes_per_token_layer": per_token,
            "kv_bytes_per_token_layer": kv * cache["c_kv"].element_size(),
            "w_uk_w_uv_cast_ms_per_step": cast, "cast_bound_ms": cast_bound,
            "cast_gb": nbytes(*mats) / 1e9}


def phase_deepseek(dev) -> dict:
    """DeepSeek-V2-236B at full width (5120 wide, 128 heads, MLA with a
    512-wide latent and 64-wide rope key, 160 experts of d_ff 1536 at top-6
    beside 2 shared experts, a dense first layer of d_ff 12288, vocab
    102400), depth cut from 60 to 4 layers (the dense layer and 3 MoE
    layers, 13.1 B parameters, 26.2 GB of seeded bf16): the serve of phase
    8 on dense KV (latent caches; no kernel on the bf16 path), with the
    latent cache's bytes per token and the absorbed decode's float32 casts
    timed; 13c's bf16 half (an 1100-token prompt decoded across
    ``mla_forward``'s 1024-query chunk, its gap to ``Model.forward``
    measured); then the dense and the shared FFN quantized in place to 4
    bits (serve-deepseek-q4: the dequant-matmul kernels, never their plain
    version), and HobbitBackend's refusal, which must name MLA."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=DEEPSEEK_LAYERS).validate()
    check(cfg.layer_is_moe() == (False, True, True, True), f"deepseek: {cfg.layer_is_moe()}")
    model, params, seed_s = _seeded(cfg, SEED + 23, dev, "serve-deepseek")
    with phase("serve-deepseek"):
        serve = phase_serve_full(dev, model, params, "serve-deepseek", (), paged=False)
        mla = _mla_cache_and_casts(model, params)
        serve["prefill_capture"] = _family_prefill("prefill-deepseek", model, params)
        check(mla["latent_bytes_per_token_layer"] == 1152,
              f"serve-deepseek: latent cache of {mla['latent_bytes_per_token_layer']} B "
              "per token and layer")
        print(f"[serve-deepseek] latent cache {mla['latent_bytes_per_token_layer']} B per "
              f"token per layer (K and V of 128 heads: {mla['kv_bytes_per_token_layer']} B, "
              f"{mla['kv_bytes_per_token_layer'] / mla['latent_bytes_per_token_layer']:.1f}x); "
              f"{json.dumps(mla)}", flush=True)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("mla-long-bf16"):
        long_bf16 = _ring_check("mla-long", _nodrop(cfg), params, 1100, 1152, 8,
                                SEED + 24, gate=False, routes_at=1100)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _quantize_ffn_in_place(params, _dense_and_shared_ffn)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    from repro_torch.quant.quantize import QTensor
    dense = [lp["ffn"].get("shared", lp["ffn"]) for lp in params["layers"]]
    check(all(isinstance(f[w], QTensor) for f in dense for w in ("wi", "wo")),
          "serve-deepseek-q4: a dense or shared FFN weight not quantized")
    check(not any(isinstance(lp["ffn"]["experts"]["wi"], QTensor)
                  for lp in params["layers"][1:]), "serve-deepseek-q4: experts quantized")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve-deepseek-q4] the dense layer's and the shared experts' FFN quantized to "
          f"4 bits (group 128) on the card in {quant_s:.1f} s: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card", flush=True)
    with phase("serve-deepseek-q4"):
        serve_q = phase_serve_full(dev, model, params, "serve-deepseek-q4", DEEPSEEK_Q_OPS,
                                   paged=False)
    agree = float(np.mean([np.mean(serve["outputs"][r] == serve_q["outputs"][r])
                           for r in serve["outputs"]]))
    print(f"[serve-deepseek-q4] seed {seed_s:.1f} s, quantize {quant_s:.1f} s; greedy "
          f"tokens equal to the bf16 run's in {agree:.3f} of positions", flush=True)
    refusal = _hobbit_refusal("serve-deepseek", model, params, "MLA attention")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"serve": serve, "serve_q4": serve_q, "mla": mla, "mla_long_bf16": long_bf16,
            "hobbit_refusal": refusal}


def phase_deepseek_parity(dev) -> dict:
    """DeepSeek at full width cut to 2 layers (the dense layer and a MoE
    layer), seeded bf16, through DenseBackend on dense KV on the card and on
    the CPU: a 48-token prefill and 4 teacher-forced decode steps for 2
    rows, per-step logits within DENSE_PARITY_ATOL, as phases 9, 10b and
    12b.  About 10 GB of weights on the host."""
    from repro_torch.configs import get_config

    print(f"[deepseek-parity] host memory available: {host_available_gb():.1f} GB",
          flush=True)
    cfg = dataclasses.replace(get_config(DEEPSEEK),
                              num_layers=DEEPSEEK_PARITY_LAYERS).validate()
    model, params, _ = _seeded(cfg, SEED + 25, dev, "deepseek-parity")
    out = _card_cpu_parity("deepseek-parity", model, params, (), b=2, s=48, steps=4,
                           seed=SEED + 26, paged=False)
    del model, params
    return out


def phase_mla_long(dev) -> dict:
    """13c, float32 half: DeepSeek at full width cut to 2 layers in float32
    weights (~20 GB) at capacity factor E / top_k (no drops): an 1100-token
    prompt prefilled into a latent cache of max_len 1152 (the forward runs
    its queries in a chunk of 1024 and a tail of 76), then 8 captured decode
    steps, each against ``Model.forward`` over the same tokens within
    RING_ATOL (in float32 the absorbed decode and the up-projecting forward
    agree to float32 rounding, so a misplaced latent row shows)."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(DEEPSEEK), num_layers=DEEPSEEK_PARITY_LAYERS,
                              dtype="float32").validate()
    model, params, _ = _seeded(cfg, SEED + 23, dev, "mla-long")
    out = _ring_check("mla-long", _nodrop(cfg), params, 1100, 1152, 8, SEED + 24)
    del model, params
    return out


def phases_deepseek(dev):
    """Phases 13-13c, each freeing its weights before the next."""
    ds = phase_deepseek(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("deepseek-parity"):
        ds["parity"] = phase_deepseek_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("mla-long"):
        ds["mla_long"] = phase_mla_long(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return ds


def phases_windowed(dev):
    """Phases 12-12d: Gemma-2-27B at full width and depth served on dense KV
    with ring caches in bf16 and with its FFN quantized in place to 4 bits;
    the 2-layer card-against-CPU parity; Gemma-3's ring across its wrap; and
    Llama-4-Scout's serve and chunk boundary.  Each frees its weights before
    the next.  Returns the two Gemma-2 serves' and the other phases' results."""
    from repro_torch.configs import get_config

    model, params, seed_s = _seeded(get_config(GEMMA2), SEED, dev, "serve-gemma2")
    with phase("serve-gemma2"):
        g2 = phase_serve_full(dev, model, params, "serve-gemma2", (), paged=False)
    with phase("prefill-gemma2"):
        g2["prefill_capture"] = _family_prefill("prefill-gemma2", model, params)
    t0 = time.perf_counter()
    _quantize_ffn_in_place(params)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve-gemma2-q4] FFN weights of {model.cfg.num_layers} layers quantized to 4 "
          f"bits (group 128) on the card in {quant_s:.1f} s, bf16 FFN freed: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card", flush=True)
    with phase("serve-gemma2-q4"):
        g2q = phase_serve_full(dev, model, params, "serve-gemma2-q4", WINDOWED_Q_OPS,
                               paged=False)
    agree = float(np.mean([np.mean(g2["outputs"][r] == g2q["outputs"][r])
                           for r in g2["outputs"]]))
    print(f"[serve-gemma2-q4] seed {seed_s:.1f} s, quantize {quant_s:.1f} s; greedy tokens "
          f"equal to the bf16 run's in {agree:.3f} of positions", flush=True)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("gemma2-parity"):
        phase_gemma2_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("ring-gemma3"):
        g3 = phase_ring_gemma3(dev)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("llama4-scout"):
        l4 = phase_llama4(dev)
    gc.collect()
    torch.cuda.empty_cache()
    return g2, g2q, g3, l4



# ---------------------------------------------------------------------------
# phases 14-14e: the state-space class (Mamba2-780m, Jamba-v0.1-52B)
# ---------------------------------------------------------------------------
MAMBA2_STATE_MB = 77.4          # 48 layers of h (48 x 64 x 128) and conv (3 x 3328), f32
MAMBA2_PARITY_LAYERS = 2
SSM_LONG_PROMPT = 600           # two 256-token SSD chunks and an 88-token padded tail
JAMBA_LAYERS = 16               # two 8-layer periods: the attention layer twice
JAMBA_LONG_LAYERS = 8
JAMBA_LONG_PROMPT = 300         # over the 256-token SSD chunk
JAMBA_Q_OPS = ("dequant_matmul",)
JAMBA_DQ_PER_STEP = 16          # wi and wo of the 8 dense FFN layers of 16


def _cache_bytes(model) -> dict:
    """The dense decode cache's bytes per slot: the SSM layers' states (the
    same at any length) and the attention layers' K/V per token."""
    cache = model.init_cache(1, 1, "meta")
    kinds = model.cfg.layer_kinds()
    return {"state_bytes_per_slot": sum(nbytes(*c.values()) for c, k in zip(cache, kinds)
                                        if k == "ssm"),
            "kv_bytes_per_token": sum(nbytes(*c.values()) for c, k in zip(cache, kinds)
                                      if k != "ssm"),
            "ssm_layers": kinds.count("ssm"), "attn_layers": len(kinds) - kinds.count("ssm")}


def _refusals(label, model, params, must_contain: str) -> dict:
    """DenseBackend(paged=True)'s refusal, which must name SSM layers, and
    HobbitBackend's, which must contain `must_contain`."""
    from repro_torch.serving.api import DenseBackend
    try:
        DenseBackend(model, params, paged=True)
    except ValueError as e:
        paged = str(e)
    else:
        fail(f"{label}: DenseBackend(paged=True) took {model.cfg.name}")
    check("SSM" in paged, f"{label}: paged refusal {paged!r}")
    print(f"[{label}] DenseBackend(paged=True) refuses it: {paged}", flush=True)
    return {"paged": paged, "hobbit": _hobbit_refusal(label, model, params, must_contain)}


def phases_mamba2(dev) -> dict:
    """14: Mamba2-780m as published (48 SSD layers, 1536 wide, 48 heads of 64,
    d_state 128, vocab 50280, no attention, no FFN; 0.78 B parameters, 1.56
    GB of seeded bf16) served as in phase 8 on the dense layout (its cache
    is the SSM states, 77.4 MB per slot at any length): decode tok/s,
    median step, peak memory, the graph replays, a profiler window and the
    head cast; the paged layout's and HobbitBackend's refusals.  14b: card
    against CPU, gated within DENSE_PARITY_ATOL in float32 weights at full
    depth and in bf16 at 2 layers; the full-depth bf16 gap is measured only
    (48 bf16 layers of seeded weights amplify the two sides' rounding
    differences to O(1): the bf16 model's own logits move by ~0.6 from the
    float32 model's of the same weights at 48 layers, ~0.05 at 2).  14c: a
    600-token prompt (two full 256-token chunks and an 88-token tail padded
    with dt = 0) then 8 captured steps against ``Model.forward``, measured
    in bf16, then gated within RING_ATOL in float32 weights (3.1 GB)."""
    from repro_torch.configs import get_config

    cfg = get_config(MAMBA2)
    model, params, seed_s = _seeded(cfg, SEED + 27, dev, "serve-mamba2")
    cache = _cache_bytes(model)
    check(round(cache["state_bytes_per_slot"] / 1e6, 1) == MAMBA2_STATE_MB
          and cache["kv_bytes_per_token"] == 0, f"serve-mamba2: cache {cache}")
    with phase("serve-mamba2"):
        serve = phase_serve_full(dev, model, params, "serve-mamba2", (), paged=False)
        serve["prefill_capture"] = _family_prefill("prefill-mamba2", model, params)
        replays = serve["kernel_dispatch"].get("serve_step.graph", 0)
        print(f"[serve-mamba2] state {cache['state_bytes_per_slot'] / 1e6:.1f} MB per slot "
              f"at any length ({cache['ssm_layers']} SSD layers, float32); {replays} decode "
              f"steps replayed one CUDA graph; {json.dumps(cache)}", flush=True)
        refusals = _refusals("serve-mamba2", model, params, "requires a MoE model; "
                             f"{cfg.name} has no FFN layers")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[mamba2-parity] host memory available: {host_available_gb():.1f} GB",
          flush=True)
    parity = {}
    with phase("mamba2-parity-bf16"):
        parity["bf16"] = _card_cpu_parity("mamba2-parity", model, params, (), b=2, s=48,
                                          steps=4, seed=SEED + 28, paged=False, gate=False)
        two = dataclasses.replace(cfg, num_layers=MAMBA2_PARITY_LAYERS).validate()
        m2, p2, _ = _seeded(two, SEED + 27, dev, "mamba2-parity")
        parity["bf16_2_layers"] = _card_cpu_parity("mamba2-parity", m2, p2, (), b=2, s=48,
                                                   steps=4, seed=SEED + 28, paged=False)
        del m2, p2
    gc.collect()
    torch.cuda.empty_cache()
    with phase("ssm-long-bf16"):
        long_bf16 = _ring_check("ssm-long", model, params, SSM_LONG_PROMPT,
                                SSM_LONG_PROMPT + 16, 8, SEED + 29, gate=False)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("ssm-long"):
        model, params, _ = _seeded(dataclasses.replace(cfg, dtype="float32"), SEED + 27, dev,
                                   "ssm-long")
        long = _ring_check("ssm-long", model, params, SSM_LONG_PROMPT, SSM_LONG_PROMPT + 16,
                           8, SEED + 29)
    with phase("mamba2-parity"):
        parity["float32"] = _card_cpu_parity("mamba2-parity", model, params, (), b=2, s=48,
                                             steps=4, seed=SEED + 28, paged=False)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    return {"seed_s": seed_s, "cache": cache, "serve": serve, "graph_replays": replays,
            "refusals": refusals, "parity": parity, "ssm_long": long,
            "ssm_long_bf16": long_bf16}


def phases_jamba(dev) -> dict:
    """14d: Jamba-v0.1-52B at full width (4096 wide, 32/8 heads of 128 in
    the attention layers, no positional encoding, 16 experts of d_ff 14336
    at top-2 in every other layer, dense FFN of d_ff 14336 in the others,
    SSD layers of d_state 16, vocab 65536) cut from 32 to 16 layers (two
    periods; 25.7 B parameters, 51.5 GB of seeded bf16): the serve of phase
    8 on the dense layout (SSM states and two layers' K/V), the bf16 gap of
    a 300-token prompt to ``Model.forward`` (capacity factor E / top_k: no
    drops) with each MoE layer's top-2 experts wherever it exceeds
    RING_ATOL, then the dense FFN quantized in place to 4 bits
    (serve-jamba-q4: 16 ``dequant_matmul`` launches per decode step, never
    the plain version), and the refusals (HobbitBackend's names the ssm
    layers).  14e: the smallest Jamba, one 8-layer period in float32
    weights (52.0 GB), the 300-token prompt and 6 captured steps held to
    ``Model.forward`` within RING_ATOL."""
    from repro_torch.configs import get_config
    from repro_torch.quant.quantize import QTensor

    cfg = dataclasses.replace(get_config(JAMBA), num_layers=JAMBA_LAYERS).validate()
    check(cfg.layer_kinds().count("attn") == 2 and sum(cfg.layer_is_moe()) == 8,
          f"jamba: {cfg.layer_kinds()} {cfg.layer_is_moe()}")
    model, params, seed_s = _seeded(cfg, SEED + 30, dev, "serve-jamba")
    cache = _cache_bytes(model)
    print(f"[serve-jamba] cache per slot: {cache['state_bytes_per_slot'] / 1e6:.2f} MB of "
          f"SSM state ({cache['ssm_layers']} layers) + {cache['kv_bytes_per_token']} B of K/V "
          f"per token ({cache['attn_layers']} layers)", flush=True)
    with phase("serve-jamba"):
        serve = phase_serve_full(dev, model, params, "serve-jamba", (), paged=False)
        serve["prefill_capture"] = _family_prefill("prefill-jamba", model, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("jamba-long-bf16"):
        long_bf16 = _ring_check("jamba-long", _nodrop(cfg), params, JAMBA_LONG_PROMPT,
                                JAMBA_LONG_PROMPT + 16, 6, SEED + 31, gate=False,
                                routes_over=RING_ATOL)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    _quantize_ffn_in_place(params, _dense_and_shared_ffn)
    torch.cuda.synchronize()
    quant_s = time.perf_counter() - t0
    for lp, moe in zip(params["layers"], cfg.layer_is_moe()):
        check(moe or all(isinstance(lp["ffn"][w], QTensor) for w in ("wi", "wo")),
              "serve-jamba-q4: a dense FFN weight not quantized")
        check(not moe or not isinstance(lp["ffn"]["experts"]["wi"], QTensor),
              "serve-jamba-q4: experts quantized")
    gc.collect()
    torch.cuda.empty_cache()
    print(f"[serve-jamba-q4] the dense FFN of {cfg.num_layers - sum(cfg.layer_is_moe())} "
          f"layers quantized to 4 bits (group 128) on the card in {quant_s:.1f} s: "
          f"{torch.cuda.memory_allocated(dev) / 1e9:.1f} GB on the card", flush=True)
    with phase("serve-jamba-q4"):
        serve_q = phase_serve_full(dev, model, params, "serve-jamba-q4", JAMBA_Q_OPS,
                                   paged=False)
        counts = serve_q["kernel_dispatch"]
        mmv, steps = serve_q["dequant_matmul_kernels"].get("mmv", 0), serve_q["decode_steps"]
        check(mmv == JAMBA_DQ_PER_STEP * steps,
              f"serve-jamba-q4: {mmv} decode dequant-matmul launches in {steps} steps")
        per_step = serve_q["window"].get("mmv_launches_per_step")
        check(per_step in (None, JAMBA_DQ_PER_STEP),
              f"serve-jamba-q4: {per_step} dequant_mmv_kernel launches per profiled step")
        print(f"[serve-jamba-q4] dequant_matmul.cuda {counts.get('dequant_matmul.cuda', 0)} "
              f"({mmv} in {steps} decode steps, {mmv // max(steps, 1)} per step; the rest in "
              f"the prefills), .torch {counts.get('dequant_matmul.torch', 0)}", flush=True)
    agree = float(np.mean([np.mean(serve["outputs"][r] == serve_q["outputs"][r])
                           for r in serve["outputs"]]))
    print(f"[serve-jamba-q4] seed {seed_s:.1f} s, quantize {quant_s:.1f} s; greedy tokens "
          f"equal to the bf16 run's in {agree:.3f} of positions", flush=True)
    refusals = _refusals("serve-jamba", model, params, "ssm layers")
    del model, params
    gc.collect()
    torch.cuda.empty_cache()
    with phase("jamba-long"):
        f32 = dataclasses.replace(get_config(JAMBA), num_layers=JAMBA_LONG_LAYERS,
                                  dtype="float32").validate()
        _, params, _ = _seeded(f32, SEED + 30, dev, "jamba-long")
        long = _ring_check("jamba-long", _nodrop(f32), params, JAMBA_LONG_PROMPT,
                           JAMBA_LONG_PROMPT + 16, 6, SEED + 31)
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return {"seed_s": seed_s, "cache": cache, "serve": serve, "serve_q4": serve_q,
            "quantize_s": quant_s, "refusals": refusals, "jamba_long": long,
            "jamba_long_bf16": long_bf16}


# ---------------------------------------------------------------------------
# phases 15-15c: Whisper-tiny (the encoder and cross-attention)
# ---------------------------------------------------------------------------
WHISPER_BATCH = 4
WHISPER_PROMPT = 4
WHISPER_NEW = 64
WHISPER_CROSS_BYTES = 9_216_000     # 4 layers x (k, v) x 1500 frames x 384 x 2 B per slot
WHISPER_LONG_PROMPT = 16
WHISPER_LONG_STEPS = 48


def _whisper_inputs(cfg, b: int, s: int, seed: int):
    """(prompts (b, s), frames (b, 1500, 384) float32 x 0.02): the stubbed
    conv frontend's output, seeded as tests/test_arch_smoke.py seeds it."""
    rng = np.random.default_rng(seed)
    frames = (rng.normal(size=(b, cfg.encoder.seq_len, cfg.encoder.d_model)) * 0.02
              ).astype(np.float32)
    return rng.integers(0, cfg.vocab_size, (b, s)), frames


def _profile(fn, steps: int) -> dict:
    """`fn()` called `steps` times under torch.profiler: kernel launches and
    device ms per call (all, the kernels alone, the copies and memsets
    alone), the busy share (device time over wall) and the top kernels;
    "not measured" when the profiler records no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_us = sum(e.self_device_time_total for e in events)
    if busy_us <= 0:
        return {"step_ms": wall / steps * 1e3, "device_busy_share": "not measured"}
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    copy_us = sum(e.self_device_time_total for e in events
                  if e.key.startswith(("Memcpy", "Memset")))
    return {"step_ms": wall / steps * 1e3, "device_ms_per_step": busy_us / steps / 1e3,
            "kernel_ms_per_step": (busy_us - copy_us) / steps / 1e3,
            "copy_ms_per_step": copy_us / steps / 1e3,
            "device_busy_share": busy_us / 1e6 / wall,
            "kernels_per_step": sum(e.count for e in events) / steps,
            "top_kernels_ms_per_step": {e.key[:60]: e.self_device_time_total / steps / 1e3
                                        for e in top}}


def phase_serve_whisper(dev, model, params) -> dict:
    """15: whisper-tiny as published through ``decode.generate(jit=True)``:
    4 rows of seeded frames and 4-token prompts, 64 new tokens, every
    decode step after the first a replay of one CUDA graph (the cross K/V
    buffers in the cache, under the capture key).  Then the same steps
    timed one by one (median step wall and decode tok/s, with the greedy
    tokens equal to generate's), the encoder and the prefill timed alone,
    3 replays under the profiler, the peak device memory and the cross
    K/V bytes per slot."""
    from repro_torch.capture import CapturedStep, addresses
    from repro_torch.device import to_device, to_host
    from repro_torch.kernels import ops
    from repro_torch.models.model import Batch
    from repro_torch.serving import decode

    cfg = model.cfg
    prompts, frames = _whisper_inputs(cfg, WHISPER_BATCH, WHISPER_PROMPT, SEED + 33)
    cache = model.init_cache(1, cfg.max_seq_len, "meta")
    cross = sum(nbytes(c["cross_k"], c["cross_v"]) for c in cache)
    check(cross == WHISPER_CROSS_BYTES, f"serve-whisper: cross K/V {cross} B per slot")
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    ops.reset_dispatch_counts()
    gen = decode.generate(model, params, prompts, WHISPER_NEW,
                          extra={"audio_frames": frames}, jit=True)
    counts = ops.dispatch_counts()
    steps = WHISPER_NEW - 1
    check(counts.get("serve_step.capture", 0) == 1 and counts.get("serve_step.graph", 0)
          == steps - 1 and counts.get("serve_step.eager", 0) == 0,
          f"serve-whisper: decode steps {_kernel_counts(counts)} / {counts}")
    check(bool(((gen.tokens >= 0) & (gen.tokens < cfg.vocab_size)).all()),
          "serve-whisper: token out of the vocabulary")
    peak = torch.cuda.max_memory_allocated(dev) / 1e9

    # the same decode, each step timed (host sync and greedy pick included)
    batch = Batch(tokens=to_device(prompts.astype(np.int32), dev),
                  loss_mask=torch.ones(prompts.shape, device=dev),
                  audio_frames=to_device(frames, dev))
    max_len = WHISPER_PROMPT + WHISPER_NEW + 1
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    lg, kv, pos = model.prefill(params, batch, max_len)
    (lg,) = to_host(lg)
    prefill_s = time.perf_counter() - t0
    serve_step = decode.make_serve_step(model)
    captured = CapturedStep(lambda tok, p: serve_step(params, kv, tok, p)[0], "serve_step")
    key = addresses(b for c in kv for b in c.values())
    tok, out, walls = lg.argmax(-1).astype(np.int32), [], []
    for i in range(steps):
        out.append(tok)
        t0 = time.perf_counter()
        (lg,) = to_host(captured(to_device(tok[:, None], dev), to_device(pos, dev), key=key))
        tok = lg.argmax(-1).astype(np.int32)
        walls.append(time.perf_counter() - t0)
        pos = pos + 1
    out.append(tok)
    check(np.array_equal(np.stack(out, 1), gen.tokens[:, WHISPER_PROMPT:]),
          "serve-whisper: the timed steps' tokens differ from decode.generate's")
    median = statistics.median(walls[1:]) * 1e3
    x = to_device(np.zeros((WHISPER_BATCH, 1), np.int32), dev)
    p = to_device(pos, dev)
    window = _profile(lambda: captured(x, p, key=key), 3)
    encoder_ms = cuda_ms(lambda: model.encode(params, batch.audio_frames), warmup=1, iters=5)
    prefill_ms = cuda_ms(lambda: model.prefill(params, batch, max_len), warmup=1, iters=3)
    del captured, kv
    run = {"card": card_line(), "decode_tok_s": gen.decode_tok_s,
           "median_step_ms": median, "decode_tok_s_timed": WHISPER_BATCH / (median / 1e3),
           "prefill_s_first": prefill_s, "encoder_ms": encoder_ms, "prefill_ms": prefill_ms,
           "peak_allocated_gb": peak, "cross_kv_bytes_per_slot": cross,
           "steps": steps, "captures": 1, "replays": counts["serve_step.graph"],
           "window": window, "kernel_dispatch": counts}
    print(f"[serve-whisper] {run['card']}: {cfg.name} as published ({cfg.param_count() / 1e6:.1f} "
          f"M parameters, bf16), {WHISPER_BATCH} rows x {WHISPER_NEW} new tokens: "
          f"decode.generate {gen.decode_tok_s:.1f} tok/s; median step {median:.3f} ms "
          f"({run['decode_tok_s_timed']:.1f} tok/s); encoder {encoder_ms:.3f} ms, prefill "
          f"{prefill_ms:.3f} ms per call; {steps - 1} of {steps} decode steps replayed one "
          f"graph; peak {peak:.2f} GB; cross K/V {cross} B per slot; "
          f"{json.dumps({k: v for k, v in run.items() if k != 'kernel_dispatch'})}", flush=True)
    return run


def _whisper_card_cpu(label, model, params, *, gate: bool = True) -> dict:
    """`model` on the card and on the CPU with the same weights and frames:
    prefill of 8-token prompts for 2 rows, then 8 teacher-forced decode
    steps; each step's logits within PARITY_ATOL (`gate` False: measured)."""
    from repro_torch.device import to_device, to_host
    from repro_torch.models.model import Batch

    cfg = model.cfg
    prompts, frames = _whisper_inputs(cfg, 2, 8, SEED + 34)
    teacher = np.random.default_rng(SEED + 35).integers(0, cfg.vocab_size, (8, 2))
    runs = {}
    for where in ("cuda", "cpu"):
        p = params if where == "cuda" else _tree_to(params, "cpu")
        d = torch.device(where, 0) if where == "cuda" else torch.device("cpu")
        batch = Batch(tokens=to_device(prompts.astype(np.int32), d),
                      loss_mask=torch.ones(prompts.shape, device=d),
                      audio_frames=to_device(frames, d))
        t0 = time.perf_counter()
        lg, cache, pos = model.prefill(p, batch, 24)
        got = [to_host(lg)[0]]
        for t in range(8):
            got.append(to_host(model.decode_step(p, cache, to_device(teacher[t][:, None], d),
                                                 to_device(pos, d)))[0])
            pos = pos + 1
        runs[where] = np.stack(got)
        print(f"[{label}] {where}: prefill + 8 steps in {time.perf_counter() - t0:.1f} s",
              flush=True)
        del p, cache
    check(bool(np.isfinite(runs["cuda"]).all()), f"{label}: non-finite logits")
    diffs = np.abs(runs["cuda"] - runs["cpu"]).max(axis=(1, 2))
    same = int((runs["cuda"].argmax(-1) == runs["cpu"].argmax(-1)).sum())
    for i, e in enumerate(diffs):
        check(e <= PARITY_ATOL or not gate, f"{label} step {i}: max |card - CPU| = {e:.4g} > "
                                            f"{PARITY_ATOL}")
    out = {"dtype": cfg.dtype, "max_abs_diff": float(diffs.max()),
           "max_abs_diff_by_step": diffs.tolist(), "logit_std": float(runs["cpu"].std()),
           "argmax_equal": same, "compared": runs["cpu"].shape[0] * 2, "gated": gate}
    print(f"[{label}] {cfg.name} {cfg.dtype}: max |card - CPU| {diffs.max():.4g} "
          f"{'<= ' + str(PARITY_ATOL) if gate else '(measured)'}; greedy equal "
          f"{same}/{out['compared']}; {json.dumps(out)}", flush=True)
    return out


def phases_whisper(dev) -> dict:
    """15: serve-whisper (``phase_serve_whisper``) on whisper-tiny as
    published (arXiv:2212.04356: 4 encoder + 4 decoder layers, 384 wide, 6
    heads of 64, vocab 51865; ~36.4 M parameters, ~73 MB of seeded bf16; no
    cut; the reference decodes it on the dense cache's plain attention and
    its cross-attention is plain ``mha``: no kernel on its path).  15b: card
    against CPU at full width on the same weights and frames, gated at
    PARITY_ATOL in float32 and in bf16.  15c: a 16-token prompt then 48
    captured steps against ``Model.forward`` in float32, gated at
    RING_ATOL, each position's gap printed."""
    from repro_torch.configs import get_config

    cfg = get_config(WHISPER)
    model, params, seed_s = _seeded(cfg, SEED + 32, dev, "serve-whisper")
    with phase("serve-whisper"):
        serve = phase_serve_whisper(dev, model, params)
    parity = {}
    with phase("whisper-parity"):
        parity["bf16"] = _whisper_card_cpu("whisper-parity", model, params)
        f32, p32, _ = _seeded(dataclasses.replace(cfg, dtype="float32"), SEED + 32, dev,
                              "whisper-parity")
        parity["float32"] = _whisper_card_cpu("whisper-parity", f32, p32)
    with phase("whisper-long"):
        _, frames = _whisper_inputs(cfg, 1, 1, SEED + 36)
        long = _ring_check("whisper-long", f32, p32, WHISPER_LONG_PROMPT,
                           WHISPER_LONG_PROMPT + WHISPER_LONG_STEPS + 1, WHISPER_LONG_STEPS,
                           SEED + 37, frames=frames)
    del model, params, f32, p32
    gc.collect()
    torch.cuda.empty_cache()
    return {"seed_s": seed_s, "serve": serve, "parity": parity, "whisper_long": long}


# ---------------------------------------------------------------------------
# phases 16-16b: training (Model.loss, AdamW, the train loop, checkpoints)
# ---------------------------------------------------------------------------
TRAIN_LAYERS = 2            # 3.03 B parameters; 4 layers would need ~73 GB before activations
TRAIN_STEPS = 6
TRAIN_BATCH = 4
TRAIN_SEQ = 512
TRAIN_PARITY_STEPS = 10
TRAIN_PARITY_ATOL = 1e-3
MIXTRAL_SMOKE_CKPT = os.path.join(ROOT, "results", "bench_models_l8", "mixtral-smoke")


def _timed_updates():
    """Patches ``optimizer.apply_updates`` (as the train step calls it) to
    record CUDA events around each call; returns the list of (start, end)
    pairs and the function that restores it."""
    from repro_torch.training import optimizer

    marks, orig = [], optimizer.apply_updates

    def timed(*a, **kw):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*a, **kw)
        end.record()
        marks.append((start, end))
        return out

    optimizer.apply_updates = timed
    return marks, lambda: setattr(optimizer, "apply_updates", orig)


def phase_train_mixtral(dev) -> dict:
    """16: Mixtral-8x7B at its published width (4096 wide, 32/8 heads, 8
    experts at top-2, d_ff 14336) cut from 32 to 2 layers (3.03 B
    parameters: 6.1 GB of seeded bf16, 6.1 GB of bf16 gradients, 24.3 GB
    of float32 moments), ``make_train_step(remat=True)`` on batches of 4 x
    512 tokens from the port's data pipeline, 6 steps: each step's wall
    split into forward + backward and the optimizer (CUDA events around
    ``apply_updates``), tokens/s, the model-FLOPs share of the bf16 dense
    peak (6 x active parameters x tokens per step over the wall and 989
    TFLOP/s), peak memory.  Gated: the loss finite at every step,
    ``opt.step == 6``, the parameters changed."""
    from repro_torch.configs import get_config
    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.kernels import ops
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import TrainState, make_train_step
    from repro_torch.weights import tree_leaves

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS).validate()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    model, params, seed_s = _seeded(cfg, SEED + 38, dev, "train-mixtral")
    probe = [t.flatten()[:4096].clone() for t in tree_leaves(params)]
    state = TrainState(params, init_opt_state(params))
    print(f"[train-mixtral] parameters {nbytes(*tree_leaves(params)) / 1e9:.2f} GB, moments "
          f"{nbytes(*tree_leaves(state.opt.mu), *tree_leaves(state.opt.nu)) / 1e9:.2f} GB "
          f"(float32) on the card", flush=True)
    it = batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                            batch_size=TRAIN_BATCH, seed=SEED), device=dev)
    step = make_train_step(model, OptimizerConfig(lr=1e-4, warmup_steps=2,
                                                  total_steps=TRAIN_STEPS), remat=True)
    marks, restore = _timed_updates()
    ops.reset_dispatch_counts()
    walls, losses = [], []
    try:
        for _ in range(TRAIN_STEPS):
            batch = next(it)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, met = step(state, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            losses.append(float(met["loss"]))
    finally:
        restore()
    opt_ms = [a.elapsed_time(b) for a, b in marks]
    check(all(np.isfinite(losses)), f"train-mixtral: losses {losses}")
    check(state.opt.step == TRAIN_STEPS, f"train-mixtral: opt.step {state.opt.step}")
    changed = sum(not torch.equal(a, b.flatten()[:4096])
                  for a, b in zip(probe, tree_leaves(state.params)))
    check(changed > 0.9 * len(probe), f"train-mixtral: {changed} of {len(probe)} leaves moved")
    tokens = TRAIN_BATCH * TRAIN_SEQ
    wall = statistics.median(walls[1:])
    opt = statistics.median(opt_ms[1:])
    flops = 6 * cfg.active_param_count() * tokens
    out = {"card": card_line(), "layers": cfg.num_layers, "params": cfg.param_count(),
           "active_params": cfg.active_param_count(), "tokens_per_step": tokens,
           "losses": losses, "step_ms": [w * 1e3 for w in walls], "optimizer_ms": opt_ms,
           "median_step_ms": wall * 1e3, "median_optimizer_ms": opt,
           "median_fwd_bwd_ms": wall * 1e3 - opt, "optimizer_share": opt / (wall * 1e3),
           "tokens_per_s": tokens / wall, "model_flops_per_step": flops,
           "mfu_bf16_dense": flops / wall / BF16_FLOPS, "leaves_moved": changed,
           "peak_allocated_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
           "peak_reserved_gb": torch.cuda.max_memory_reserved(dev) / 1e9,
           "kernel_dispatch": ops.dispatch_counts(), "seed_s": seed_s}
    print(f"[train-mixtral] {out['card']}: {cfg.name} at full width, {cfg.num_layers} layers, "
          f"bf16, float32 moments, remat, {TRAIN_BATCH} x {TRAIN_SEQ} tokens: median step "
          f"{wall * 1e3:.1f} ms = forward + backward {wall * 1e3 - opt:.1f} + optimizer "
          f"{opt:.1f} ({100 * out['optimizer_share']:.0f}%); {out['tokens_per_s']:.0f} tokens/s; "
          f"model FLOPs (6 x {cfg.active_param_count() / 1e9:.2f} B active x {tokens} tokens = "
          f"{flops / 1e12:.1f} TFLOP) {100 * out['mfu_bf16_dense']:.1f}% of the 989 TFLOP/s "
          f"bf16 dense peak; peak {out['peak_allocated_gb']:.1f} GB; losses {losses}; "
          f"{json.dumps(out)}", flush=True)
    del state, params, model, probe
    gc.collect()
    torch.cuda.empty_cache()
    return out


def mixtral_smoke():
    """benchmarks/common.py's "mixtral-smoke" config (8 layers, 128 wide, 8
    experts at top-2, router aux weight 0.02, float32), built from the
    port's configs: the model of results/bench_models_l8/mixtral-smoke."""
    from repro_torch.configs import get_config, smoke_variant
    cfg = smoke_variant(get_config(ARCH), layers=8, d_model=128, vocab=512)
    moe = dataclasses.replace(cfg.moe, num_experts=8, top_k=2, router_aux_weight=0.02)
    return dataclasses.replace(cfg, name="mixtral-smoke", dtype="float32", moe=moe).validate()


def phase_train_parity(dev) -> dict:
    """16b: the port restores the repository's float32 mixtral-smoke
    checkpoint (step 300) on the card and on the CPU and trains 10 steps on
    each from the same batches (16 x 64 tokens): every step's loss within
    TRAIN_PARITY_ATOL (gated).  The card's parameters, saved with the
    port's ``save`` (the reference's format) and restored on the CPU, are
    bit-identical to the card's."""
    import tempfile

    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.models import build_model
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import TrainState, train
    from repro_torch.weights import tree_leaves

    cfg = mixtral_smoke()
    model = build_model(cfg)
    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=16, seed=SEED)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_PARITY_STEPS)
    curves, states = {}, {}
    for where in ("cuda", "cpu"):
        d = dev if where == "cuda" else torch.device("cpu")
        params, step = ckpt.restore(MIXTRAL_SMOKE_CKPT, model.init(SEED, device=d), cfg=cfg)
        check(step == 300, f"train-parity: restored step {step}")
        t0 = time.perf_counter()
        states[where], hist = train(model, ocfg, batches(dc, device=d), TRAIN_PARITY_STEPS,
                                    log_every=1, state=TrainState(params,
                                                                  init_opt_state(params)),
                                    device=d, log=lambda *_: None)
        curves[where] = [h["loss"] for h in hist]
        print(f"[train-parity] {where}: {TRAIN_PARITY_STEPS} steps in "
              f"{time.perf_counter() - t0:.1f} s, losses {curves[where]}", flush=True)
    gaps = np.abs(np.array(curves["cuda"]) - np.array(curves["cpu"]))
    check(bool(np.isfinite(curves["cuda"]).all()), "train-parity: non-finite loss on the card")
    for i, e in enumerate(gaps):
        check(e <= TRAIN_PARITY_ATOL, f"train-parity step {i}: |card - CPU| loss {e:.3g} > "
                                      f"{TRAIN_PARITY_ATOL}")
    with tempfile.TemporaryDirectory() as tmp:
        ckpt.save(tmp, states["cuda"].params, step=310, cfg=cfg)
        back, _ = ckpt.restore(tmp, states["cpu"].params, cfg=cfg)
    same = all(torch.equal(a, b.cpu()) for a, b in zip(tree_leaves(back),
                                                       tree_leaves(states["cuda"].params)))
    check(same, "train-parity: the card's checkpoint restored on the CPU differs")
    out = {"card": card_line(), "losses_card": curves["cuda"], "losses_cpu": curves["cpu"],
           "max_abs_loss_gap": float(gaps.max()), "loss_gap_by_step": gaps.tolist(),
           "checkpoint_bit_identical": same}
    print(f"[train-parity] {cfg.name} from step 300, {TRAIN_PARITY_STEPS} steps: max |card - "
          f"CPU| loss {gaps.max():.3g} <= {TRAIN_PARITY_ATOL}; the card's checkpoint restored "
          f"on the CPU bit-identical; {json.dumps(out)}", flush=True)
    return out


def phases_train(dev) -> dict:
    with phase("train-mixtral"):
        run = phase_train_mixtral(dev)
    with phase("train-parity"):
        parity = phase_train_parity(dev)
    return {"train": run, "parity": parity}


# ---------------------------------------------------------------------------
# phases 17-17c: the sharding module group (no kernel on these paths)
# ---------------------------------------------------------------------------

ANALYSIS_BYTES_RTOL = 0.01      # analysed bytes against the card run's
ANALYSIS_PEAK_RTOL = 0.15       # the analysis's peak against max_memory_allocated
DECODE_BATCH, DECODE_MAX_LEN, DECODE_POS = 4, 4096, 1024
NCCL_MESH_ATOL = 1e-6


def _train_args(cfg, model, device, fake: bool):
    """Phase 16's step: seeded parameters, float32 moments, a batch of
    TRAIN_BATCH x TRAIN_SEQ tokens (zeros and ones under a fake mode)."""
    from repro_torch.models.model import Batch
    from repro_torch.training.optimizer import OptimizerConfig, init_opt_state
    from repro_torch.training.train_loop import TrainState, make_train_step

    params = model.init(SEED + 38, device=device)
    state = TrainState(params, init_opt_state(params))
    if fake:
        tokens = torch.zeros((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.int32, device=device)
    else:
        g = torch.Generator(device=device).manual_seed(SEED)
        tokens = torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ), generator=g,
                               device=device, dtype=torch.int32)
    batch = Batch(tokens, torch.ones((TRAIN_BATCH, TRAIN_SEQ), dtype=torch.float32,
                                     device=device))
    step = make_train_step(model, OptimizerConfig(lr=1e-4, warmup_steps=2,
                                                  total_steps=TRAIN_STEPS), remat=True)
    return step, (state, batch)


def _decode_args(cfg, model, device, fake: bool):
    """The bf16 Granite decode step on dense KV: batch DECODE_BATCH, a
    DECODE_MAX_LEN cache, every row at position DECODE_POS."""
    from repro_torch.serving.decode import make_serve_step

    params = model.init(SEED, device=device)
    cache = model.init_cache(DECODE_BATCH, DECODE_MAX_LEN, device)
    tokens = torch.zeros((DECODE_BATCH, 1), dtype=torch.int32, device=device)
    pos = torch.full((DECODE_BATCH,), DECODE_POS, dtype=torch.long, device=device)
    step = make_serve_step(model)

    @torch.no_grad()
    def run(*a):
        return step(*a)
    return run, (params, cache, tokens, pos)


def _analysis_vs_card(label, cfg, build, dev, *, iters: int) -> dict:
    """The op analysis of one step twice: on fake CPU tensors (what the dry
    run sees at a (1, 1) mesh: one GPU holds every shard, so the sharded
    program is the plain one) and on the card.  Gated: FLOPs equal, bytes
    within ANALYSIS_BYTES_RTOL, the analysed peak within ANALYSIS_PEAK_RTOL
    of max_memory_allocated over the analysed step (less what the card held
    before the step's arguments).  Printed: the roofline step from the
    H100 datasheet constants, the measured median step and their ratio."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import analyze
    from repro_torch.launch.roofline import Roofline
    from repro_torch.models import build_model

    model = build_model(cfg)
    t0 = time.perf_counter()
    with FakeTensorMode():
        fn, args = build(cfg, model, "cpu", True)
        _, fake = analyze(fn, *args)
    fake_s = time.perf_counter() - t0
    del fn, args
    gc.collect()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    fn, args = build(cfg, model, dev, False)
    fn(*args)                                       # warm-up (cuBLAS, allocator)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    _, real = analyze(fn, *args)
    torch.cuda.synchronize()
    peak_real = torch.cuda.max_memory_allocated(dev) - base
    walls = []
    for _ in range(iters):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t1)
    step_ms = statistics.median(walls) * 1e3
    rl = Roofline(cfg.name, label, "1x1", fake["flops"], fake["bytes"], 0.0)
    out = {"card": card_line(), "flops_fake": fake["flops"], "flops_card": real["flops"],
           "bytes_fake": fake["bytes"], "bytes_card": real["bytes"],
           "bytes_rel_gap": abs(fake["bytes"] - real["bytes"]) / real["bytes"],
           "peak_fake_gb": fake["peak_bytes"] / 1e9, "peak_card_gb": peak_real / 1e9,
           "peak_rel_gap": abs(fake["peak_bytes"] - peak_real) / peak_real,
           "ops_fake": fake["ops"], "ops_card": real["ops"],
           "roofline": rl.asdict(), "roofline_ms": rl.step_s * 1e3,
           "measured_median_ms": step_ms, "roofline_over_measured": rl.step_s * 1e3 / step_ms,
           "fake_trace_s": fake_s}
    check(fake["flops"] == real["flops"],
          f"{label}: analysed FLOPs {fake['flops']:.6e} != card run's {real['flops']:.6e}")
    check(out["bytes_rel_gap"] <= ANALYSIS_BYTES_RTOL,
          f"{label}: analysed bytes {fake['bytes']:.6e} vs card run's {real['bytes']:.6e}")
    check(out["peak_rel_gap"] <= ANALYSIS_PEAK_RTOL,
          f"{label}: analysed peak {out['peak_fake_gb']:.2f} GB vs max_memory_allocated "
          f"{out['peak_card_gb']:.2f} GB")
    print(f"[roofline-check] {label} on {out['card']}: FLOPs {fake['flops']:.4e} (fake) = "
          f"{real['flops']:.4e} (card); bytes {fake['bytes']:.4e} vs {real['bytes']:.4e} "
          f"({100 * out['bytes_rel_gap']:.3f}%); peak {out['peak_fake_gb']:.2f} GB analysed vs "
          f"{out['peak_card_gb']:.2f} GB max_memory_allocated ({100 * out['peak_rel_gap']:.1f}%); "
          f"roofline step (H100 SXM5 datasheet constants) {out['roofline_ms']:.3f} ms "
          f"({rl.bottleneck}-bound: compute {rl.compute_s * 1e3:.3f} ms, memory "
          f"{rl.memory_s * 1e3:.3f} ms), measured median {step_ms:.3f} ms, ratio "
          f"{out['roofline_over_measured']:.3f}; {json.dumps(out)}", flush=True)
    del fn, args, model
    gc.collect()
    torch.cuda.empty_cache()
    return out


def phase_roofline_check(dev) -> dict:
    """17: the op analysis (``launch.op_analysis``) against the card on two
    kernel-free steps the card already runs: train-mixtral (phase 16's
    step) and the bf16 Granite-3.0-2B decode step on dense KV at batch 4."""
    from repro_torch.configs import get_config

    cfg = dataclasses.replace(get_config(ARCH), num_layers=TRAIN_LAYERS).validate()
    train = _analysis_vs_card("train-mixtral", cfg, _train_args, dev, iters=4)
    decode = _analysis_vs_card("decode-granite", granite_full(), _decode_args, dev, iters=20)
    return {"train_mixtral": train, "decode_granite": decode}


def phase_nccl_mesh(dev) -> dict:
    """17b: NCCL at world size 1 (a FileStore in a temporary directory, no
    network), ``make_production_mesh``'s code path at shape (1, 1) on cuda,
    and mixtral-smoke's checkpoint (step 300) trained one step with DTensor
    parameters, moments and batch laid out by the rule table, against the
    unsharded step on the same inputs: the loss and every parameter within
    NCCL_MESH_ATOL in float32 (gated).  Returns the kernel launches of the
    sharded step (none: the path reaches no kernel)."""
    import tempfile

    import torch.distributed as dist

    from repro_torch.data.pipeline import DataConfig, batches
    from repro_torch.kernels import ops
    from repro_torch.launch import sharding as sh
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import build_model
    from repro_torch.models.model import Batch
    from repro_torch.training import checkpoint as ckpt
    from repro_torch.training.optimizer import OptimizerConfig, OptState, init_opt_state
    from repro_torch.training.train_loop import TrainState, make_train_step
    from repro_torch.weights import tree_leaves, tree_map

    cfg = mixtral_smoke()
    model = build_model(cfg)
    ocfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=TRAIN_PARITY_STEPS)
    params, step = ckpt.restore(MIXTRAL_SMOKE_CKPT, model.init(SEED, device=dev), cfg=cfg)
    check(step == 300, f"nccl-mesh: restored step {step}")
    batch = next(batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, batch_size=16,
                                    seed=SEED), device=dev))
    plain = tree_map(lambda t: t.clone(), params)
    s_ref, m_ref = make_train_step(model, ocfg, remat=True)(
        TrainState(plain, init_opt_state(plain)), batch)
    with tempfile.TemporaryDirectory() as tmp:
        store = dist.FileStore(os.path.join(tmp, "store"), 1)
        dist.init_process_group("nccl", store=store, rank=0, world_size=1, device_id=dev)
        try:
            mesh = make_production_mesh(shape=(1, 1))
            specs = sh.param_shardings(mesh, params)
            opt = init_opt_state(params)
            state = TrainState(sh.distribute_tree(mesh, params, specs),
                               OptState(opt.step, sh.distribute_tree(mesh, opt.mu, specs),
                                        sh.distribute_tree(mesh, opt.nu, specs)))
            dbatch = Batch(*(None if f is None else sh.distribute(mesh, f, ("data",))
                             for f in batch))
            ops.reset_dispatch_counts()
            t0 = time.perf_counter()
            s_sp, m_sp = make_train_step(model, ocfg, remat=True, mesh=mesh)(state, dbatch)
            torch.cuda.synchronize()
            step_s = time.perf_counter() - t0
            counts = ops.dispatch_counts()
            loss_sp = float(m_sp["loss"].full_tensor())
            sp = [t.full_tensor() for t in tree_leaves(s_sp.params)]
        finally:
            dist.destroy_process_group()
    ref = tree_leaves(s_ref.params)
    loss_gap = abs(float(m_ref["loss"]) - loss_sp)
    param_gap = max(float((a - b).abs().max()) for a, b in zip(ref, sp))
    check(loss_gap <= NCCL_MESH_ATOL, f"nccl-mesh: |loss gap| {loss_gap:.3g}")
    check(param_gap <= NCCL_MESH_ATOL, f"nccl-mesh: max |param gap| {param_gap:.3g}")
    out = {"card": card_line(), "loss_unsharded": float(m_ref["loss"]), "loss_sharded": loss_sp,
           "loss_gap": loss_gap, "max_param_gap": param_gap, "leaves": len(ref),
           "sharded_step_s": step_s, "kernel_dispatch": counts}
    print(f"[nccl-mesh] {cfg.name} from step 300 on a (1, 1) NCCL mesh: loss {loss_sp:.7f} "
          f"sharded vs {float(m_ref['loss']):.7f} unsharded (gap {loss_gap:.3g}), max |param "
          f"gap| {param_gap:.3g} over {len(ref)} leaves (<= {NCCL_MESH_ATOL}); "
          f"{json.dumps(out)}", flush=True)
    return out


def phase_dryrun() -> dict:
    """17c: ``dryrun.run_one`` for Mixtral-8x7B x train_4k and x decode_32k
    on the (32, 8) production mesh (fake process group, fake tensors; an
    analysis from H100 SXM5 datasheet constants): both records ok."""
    from repro_torch.launch import dryrun

    out = {}
    for shape in ("train_4k", "decode_32k"):
        t0 = time.perf_counter()
        rec = dryrun.run_one(ARCH, shape)
        if rec["status"] != "ok":
            print(rec.get("traceback", ""), flush=True)
        rec.pop("traceback", None)
        rec["wall_s"] = time.perf_counter() - t0
        check(rec["status"] == "ok", f"dryrun {ARCH} x {shape}: {rec.get('error')}")
        print(f"[dryrun] {ARCH} x {shape} @ {rec['mesh']} in {rec['wall_s']:.1f} s; "
              f"{json.dumps(rec)}", flush=True)
        out[shape] = rec
    return out


def phases_sharding(dev) -> dict:
    with phase("roofline-check"):
        roof = phase_roofline_check(dev)
    with phase("nccl-mesh"):
        nccl = phase_nccl_mesh(dev)
    with phase("dryrun"):
        dry = phase_dryrun()
    return {"roofline": roof, "nccl": nccl, "dryrun": dry}


def main() -> None:
    with phase("device"):
        phase_device()
    dev = torch.device("cuda", 0)
    with phase("build"):
        phase_build()
    with phase("kernels"):
        rows = phase_kernels(dev)
    rows += phase_kernels_dense(dev)

    from repro_torch.models import build_model
    cfg = mixtral_cut()
    model = build_model(cfg)
    t0 = time.perf_counter()
    params = model.init(SEED, device=dev)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name} at full width, {cfg.num_layers} layers, bf16 random "
          f"weights (seed {SEED}) in {time.perf_counter() - t0:.1f} s", flush=True)
    with phase("serve"):
        serve = phase_serve(dev, model, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("parity"):
        phase_parity(dev, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("serve-paged"):
        paged = phase_serve_paged(dev, model, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("paged-parity"):
        phase_paged_parity(dev, cfg, params)
    gc.collect()
    torch.cuda.empty_cache()
    with phase("per-expert"):
        per_expert = phase_per_expert(dev, model, params)
    with phase("host-mode"):
        host_mode = phase_host_mode(dev, model, params)
    with phase("single-sequence"):
        single = phase_single_sequence(dev, cfg, params)
    with phase("simulator"):
        simulator = phase_simulator(dev, model, params, serve["link_gbps"])
    with phase("engine-prefill"):
        engine_prefill = phase_engine_prefill(dev, model, params)
    del model, params
    gc.collect()
    torch.cuda.empty_cache()

    from repro_torch.quant.quantize import quantize_tree
    gcfg = granite_full()
    gmodel = build_model(gcfg)
    t0 = time.perf_counter()
    gparams = gmodel.init(SEED, device=dev)
    torch.cuda.synchronize()
    print(f"[serve-dense] {gcfg.name} at full width and depth ({gcfg.num_layers} layers), "
          f"bf16 random weights (seed {SEED}) in {time.perf_counter() - t0:.1f} s", flush=True)
    with phase("serve-dense"):
        dense = phase_serve_dense(dev, gmodel, gparams, "serve-dense", DENSE_OPS)
    t0 = time.perf_counter()
    qparams = quantize_tree(gparams, bits=4, predicate=_ffn_path)
    torch.cuda.synchronize()
    print(f"[serve-dense-q4] FFN weights of {gcfg.num_layers} layers quantized to 4 bits "
          f"(group 128) on the card in {time.perf_counter() - t0:.1f} s", flush=True)
    with phase("serve-dense-q4"):
        dense_q = phase_serve_dense(dev, gmodel, qparams, "serve-dense-q4", DENSE_Q_OPS)
    agree = float(np.mean([np.mean(dense["outputs"][r] == dense_q["outputs"][r])
                           for r in dense["outputs"]]))
    print(f"[serve-dense-q4] greedy tokens equal to the bf16 run's in {agree:.3f} of "
          "positions (4-bit FFN weights change the function)", flush=True)
    with phase("serve-dense-jit"):
        phase_serve_dense_jit(dev, gmodel, qparams, dense_q)
    with phase("prefill-capture"):
        prefill = {"bf16": phase_prefill_capture(dev, gmodel, gparams, "prefill-capture"),
                   "q4": phase_prefill_capture(dev, gmodel, qparams, "prefill-capture-q4",
                                               ("dequant_matmul",))}
    del gmodel, gparams, qparams
    gc.collect()
    torch.cuda.empty_cache()
    with phase("dense-parity"):
        phase_dense_parity(dev)
    gc.collect()
    torch.cuda.empty_cache()

    nem, nem_q, ivl = phases_48_8(dev)
    g2, g2q, g3, l4 = phases_windowed(dev)
    ds = phases_deepseek(dev)
    mb = phases_mamba2(dev)
    jb = phases_jamba(dev)
    wh = phases_whisper(dev)
    tr = phases_train(dev)
    shd = phases_sharding(dev)

    # launches: each kernel's from its main path (the grouped and gating
    # kernels' from the dense-KV serve, the paged flash decode's from the
    # paged serve (g = 4) and the Nemotron serve (g = 6), the
    # dequant-matmul's from the quantized Granite, Nemotron, Gemma-2,
    # DeepSeek and Jamba serves; no serving path runs the contiguous flash
    # decode);
    # every path beside them
    main_path = {"paged_flash_decode": "serve_paged", "dequant_matmul": "serve_dense_q4",
                 "flash_decode": None, "paged_flash_decode (g=6)": "serve_nemotron",
                 "dequant_matmul (nemotron)": "serve_nemotron_q4", "flash_decode (g=6)": None,
                 "dequant_matmul (gemma2)": "serve_gemma2_q4",
                 "dequant_matmul (deepseek)": "serve_deepseek_q4",
                 "dequant_matmul (jamba)": "serve_jamba_q4"}
    paths = {"serve": serve, "serve_paged": paged, "serve_dense": dense,
             "serve_dense_q4": dense_q, "per_expert": per_expert["per_expert_dense"],
             "per_expert_paged": per_expert["per_expert_paged"],
             "grouped_sync": per_expert["grouped_dense"],
             "grouped_sync_paged": per_expert["grouped_paged"],
             "host_mode": host_mode["host"], "single_sequence": single,
             "simulator": simulator,
             "serve_nemotron": nem, "serve_nemotron_q4": nem_q,
             "serve_internvl2": ivl["serve"], "serve_gemma2": g2, "serve_gemma2_q4": g2q,
             "serve_gemma3": g3["serve"], "serve_llama4": l4["serve"],
             "serve_deepseek": ds["serve"], "serve_deepseek_q4": ds["serve_q4"],
             "serve_mamba2": mb["serve"], "serve_jamba": jb["serve"],
             "serve_jamba_q4": jb["serve_q4"], "serve_whisper": wh["serve"],
             "train_mixtral": tr["train"], "train_sharded": shd["nccl"],
             "prefill_capture": prefill["bf16"], "prefill_capture_q4": prefill["q4"],
             "engine_prefill": engine_prefill}
    for r in rows:
        key = f"{r.get('op', r['name'])}.cuda"
        by_path = {name: run["kernel_dispatch"].get(key, 0) for name, run in paths.items()
                   if name in r.get("paths", paths)}
        path = main_path.get(r["name"], "serve")
        r["launches"] = by_path[path] if path else 0
        r["launches_by_path"] = by_path

    print(json.dumps({"kernels": rows}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
