"""Serving launcher of the PyTorch port over the unified `InferenceBackend`.

The flags mirror ``python -m repro.launch.serve``, plus ``--device``
(default ``cuda``; ``--device cpu`` runs on the CPU, for tests and smoke
configs):

  # HOBBIT offload on the card, full-width Mixtral-8x7B cut to 4 layers
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --layers 4 --backend hobbit --serve-requests 6 --max-batch 4

  # the smoke config on the CPU
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --smoke --device cpu --backend hobbit --prompt-len 8 --new-tokens 8

  # paged KV with prefix sharing: a shared system prompt aliased across slots
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mixtral-8x7b \\
      --layers 4 --backend hobbit --paged-kv --shared-prefix 48 \\
      --serve-requests 8 --max-batch 4

  # the dense Granite-3.0-2B, full depth, resident weights on paged KV
  PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b \\
      --backend dense --paged-kv --serve-requests 6 --max-batch 4

  # the 48/8-head dense family: Nemotron-4-15B (full depth, ~31 GB of
  # bf16) and InternVL2-26B's backbone (text-only requests)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch nemotron-4-15b \\
      --backend dense --paged-kv --serve-requests 6 --max-batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch internvl2-26b \\
      --layers 8 --backend dense --paged-kv --serve-requests 6 --max-batch 4

  # the windowed family on dense KV with ring caches (--paged-kv refused):
  # Gemma-2-27B (full depth, ~54 GB of bf16), Gemma-3-27B and
  # Llama-4-Scout-17B-16E cut in depth (--backend hobbit refuses Llama-4's
  # chunked layers and shared expert)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \\
      --backend dense --serve-requests 6 --max-batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-27b \\
      --layers 12 --backend dense --serve-requests 6 --max-batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch llama4-scout-17b-a16e \\
      --layers 8 --backend dense --serve-requests 6 --max-batch 4

  # DeepSeek-V2-236B (MLA over a latent cache, a dense first layer, 160
  # experts at top-6 beside 2 shared experts) cut from 60 to 4 layers on
  # dense KV (--paged-kv and --backend hobbit refused)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-v2-236b \\
      --layers 4 --backend dense --serve-requests 6 --max-batch 4

  # the state-space class on dense KV (--paged-kv and --backend hobbit
  # refused): Mamba2-780m at full depth (48 SSD layers, a 77.4 MB state per
  # slot at any length), Jamba-v0.1-52B cut from 32 to 16 layers (two
  # periods of 7 SSD layers and one attention layer, 16 experts at top-2 in
  # every other layer; ~51 GB of bf16)
  PYTHONPATH=src python -m repro_torch.launch.serve --arch mamba2-780m \\
      --backend dense --serve-requests 6 --max-batch 4
  PYTHONPATH=src python -m repro_torch.launch.serve --arch jamba-v0.1-52b \\
      --layers 16 --backend dense --serve-requests 6 --max-batch 4

``--arch whisper-tiny`` exits with a message: an encoder-decoder model is
served through ``serving.decode.generate`` with its audio frames, not
through a backend (chip_smoke.py phase 15 runs it so).

Prints one JSON report; with ``--paged-kv`` it carries the page pool's
counters under ``"kv"``.  With ``--backend hobbit`` it adds the simulated
decode tok/s of the four offloading systems on the engine's own routing
trace under the ``--hw`` host model: ``h100_host`` by default (the card's
own, ``core.simulator.H100_HOST``), where the reference defaults to the
paper's ``rtx4090``.  ``h100_host``'s compute constant is the resident
step's, without the serve path's host work, so its figures bound the
engine's tok/s from above.
"""

import argparse
import dataclasses
import json

import numpy as np

from repro_torch.configs import get_config, smoke_variant
from repro_torch.core import EngineConfig, OffloadEngine, Thresholds
from repro_torch.core.simulator import HARDWARE, HobbitSimConfig, simulate_systems
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.kernels import ops as kops
from repro_torch.quant.quantize import expert_nbytes
from repro_torch.serving.api import BackendConfig, generate, make_backend, refuse_encoder
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.serving.workload import DEFAULT_AGING_S
from repro_torch.weights import from_jax_params, load_checkpoint


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Serve a model through the unified InferenceBackend "
                    "API of the PyTorch port: --backend dense keeps all weights "
                    "resident; --backend hobbit decodes a MoE model through the "
                    "mixed-precision expert-offloading engine.")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the model runs (default: the CUDA card)")
    ap.add_argument("--smoke", action="store_true",
                    help="the reduced float32 smoke variant of --arch")
    ap.add_argument("--layers", type=int, default=0,
                    help="cut the depth to N layers at full width (0: the "
                         "published depth)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights (without --ckpt-dir)")
    ap.add_argument("--backend", choices=["dense", "hobbit"], default=None,
                    help="inference backend behind the serving API "
                         "(default: dense)")
    ap.add_argument("--mode", choices=["resident", "hobbit"], default=None,
                    help="DEPRECATED alias for --backend (resident -> dense)")
    ap.add_argument("--ckpt-dir", type=str, default=None,
                    help="a JAX-package checkpoint (npz + json) to serve")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--batch", type=int, default=1,
                    help="batch size for single-shot generation")
    ap.add_argument("--serve-requests", type=int, default=0,
                    help="if > 0, run N mixed-length requests through the "
                         "continuous-batching scheduler")
    ap.add_argument("--max-batch", type=int, default=4,
                    help="scheduler slots for --serve-requests")
    ap.add_argument("--jit", action=argparse.BooleanOptionalAction, default=True,
                    help="--backend dense: capture the decode step as a CUDA "
                         "graph on the card (--no-jit: the eager path); the "
                         "offload engine always captures its layer segments")
    ap.add_argument("--paged-kv", action="store_true",
                    help="paged KV cache: slots draw pages from a shared pool "
                         "instead of each allocating max_len up front")
    ap.add_argument("--page-size", type=int, default=64,
                    help="tokens per KV page (--paged-kv)")
    ap.add_argument("--kv-pages", type=int, default=None,
                    help="KV pool size in pages (--paged-kv; default: the dense "
                         "equivalent, batch * ceil(max_len/page))")
    ap.add_argument("--prefill-chunk", type=int, default=64,
                    help="tokens per chunked-prefill call (--paged-kv)")
    ap.add_argument("--prefix-sharing", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="radix prefix cache over the page pool (--paged-kv): "
                         "admissions alias resident prompt-prefix pages, "
                         "copy-on-write on divergence")
    ap.add_argument("--admit-k", type=int, default=4,
                    help="max requests prefilling concurrently (--serve-requests)")
    ap.add_argument("--sched", choices=["slo", "fifo"], default="slo",
                    help="scheduler admission policy (--serve-requests)")
    ap.add_argument("--aging-s", type=float, default=DEFAULT_AGING_S)
    ap.add_argument("--preempt-margin", type=float, default=1.0)
    ap.add_argument("--priority-every", type=int, default=0,
                    help="mark every Nth request priority 2 with a 2 s TTFT SLO")
    ap.add_argument("--shared-prefix", type=int, default=0,
                    help="prepend a common N-token prefix to every prompt")
    ap.add_argument("--hi-slots", type=int, default=16)
    ap.add_argument("--lo-slots", type=int, default=8)
    ap.add_argument("--t1", type=float, default=0.6)
    ap.add_argument("--t2", type=float, default=0.9)
    ap.add_argument("--streams", type=int, default=2)
    ap.add_argument("--ordered", action="store_true")
    ap.add_argument("--upgrade", action=argparse.BooleanOptionalAction, default=True)
    ap.add_argument("--link-gbps", type=float, default=None,
                    help="modeled H2D link GB/s (emulated); default measures "
                         "the pinned host -> device rate")
    ap.add_argument("--async-prefetch", action=argparse.BooleanOptionalAction,
                    default=True, help="stage prefetch copies in the background")
    ap.add_argument("--hw", choices=list(HARDWARE), default="h100_host",
                    help="hardware cost model for the simulated latency report "
                         "(default: h100_host, measured on the card the port "
                         "runs on from the resident step, so its tok/s are "
                         "upper bounds: the serve path's host work is not in "
                         "it; the reference defaults to rtx4090)")
    args = ap.parse_args(argv)

    kind = args.backend or {"resident": "dense", "hobbit": "hobbit",
                            None: "dense"}[args.mode]
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = dataclasses.replace(smoke_variant(cfg), dtype="float32")
    elif args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers).validate()
    try:
        refuse_encoder(cfg)
    except ValueError as e:     # Whisper: served by decode.generate with audio frames
        raise SystemExit(f"--arch {args.arch}: {e}") from None
    if kind == "hobbit" and cfg.moe is None:
        raise SystemExit(f"--backend hobbit requires a MoE arch; {cfg.name} is dense "
                         "(use --backend dense)")
    model = build_model(cfg)
    if args.ckpt_dir:
        params = from_jax_params(cfg, load_checkpoint(args.ckpt_dir), device=dev)
    else:
        params = model.init(args.seed, device=dev)

    ecfg = EngineConfig(
        hi_slots=args.hi_slots, lo_slots=args.lo_slots,
        thresholds=Thresholds(args.t1, args.t2), streams=args.streams,
        ordered=args.ordered, upgrade=args.upgrade, link_gbps=args.link_gbps,
        async_prefetch=args.async_prefetch)
    try:
        backend = make_backend(BackendConfig(
            kind=kind, jit=args.jit, paged=args.paged_kv, page_size=args.page_size,
            kv_pages=args.kv_pages, prefill_chunk=args.prefill_chunk,
            prefix_sharing=args.prefix_sharing,
            engine=ecfg if kind == "hobbit" else None), model, params)
    except ValueError as e:     # --paged-kv on ring caches, a model the engine refuses
        raise SystemExit(f"--backend {kind}: {e}") from None

    rng = np.random.default_rng(0)
    report = {"backend": kind, "paged_kv": args.paged_kv, "device": str(dev)}
    try:
        if args.serve_requests > 0:
            srv = BatchingServer(backend, max_batch=args.max_batch,
                                 max_len=(args.shared_prefix + args.prompt_len * 2
                                          + args.new_tokens + 8),
                                 admit_k=args.admit_k, policy=args.sched,
                                 aging_s=args.aging_s,
                                 preempt_margin=args.preempt_margin)
            common = rng.integers(0, cfg.vocab_size, args.shared_prefix)
            for i in range(args.serve_requests):
                plen = args.prompt_len * (1 + i % 2)
                prompt = np.concatenate(
                    [common, rng.integers(0, cfg.vocab_size, plen)])
                urgent = args.priority_every and i % args.priority_every == 0
                srv.submit(Request(
                    rid=i, prompt=prompt,
                    max_new_tokens=args.new_tokens // (1 + i % 2),
                    priority=2 if urgent else 0,
                    ttft_slo_s=2.0 if urgent else None))
            srv.run()
            report["serving"] = srv.stats()
            report["scheduler"] = {"policy": args.sched,
                                   "preemptions": srv.preemptions}
        else:
            prompts = rng.integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
            res = generate(backend, prompts, args.new_tokens)
            report.update({"prefill_s": res.prefill_s, "decode_s": res.decode_s,
                           "decode_tok_s": res.decode_tok_s,
                           "tokens": res.tokens[0, -8:].tolist()})

        if kind == "hobbit":
            eng: OffloadEngine = backend.engine
            stats = eng.stats()
            hw = HARDWARE[args.hw]
            base = get_config(args.arch)  # full-scale dims for the latency model
            sim_cfg = HobbitSimConfig(
                thresholds=Thresholds(args.t1, args.t2),
                hi_slots=args.hi_slots, lo_slots=args.lo_slots,
                hi_bytes=expert_nbytes(base.d_model, base.moe.d_ff_expert, 16),
                lo_bytes=expert_nbytes(base.d_model, base.moe.d_ff_expert, 4))
            sim = simulate_systems(eng.trace, eng.num_moe_layers, hw, sim_cfg)
            report.update({
                "cache_hit_ratio": round(stats["cache"]["hit_ratio"], 3),
                "loads": {"hi": stats["loads_hi"], "lo": stats["loads_lo"],
                          "skips": stats["skips"]},
                "pred_accuracy": stats["pred_accuracy"],
                "load_stall_s": round(stats["load_stall_s"], 4),
                "overlap_fraction": round(stats["overlap_fraction"], 3),
                "gating_s": round(stats["gating_s"], 4),
                "streams": stats["streams"],
                "per_stream_bytes": stats["per_stream_bytes"],
                "issue_reorders": stats["issue_reorders"],
                "precision_downgrades": stats["precision_downgrades"],
                "upgrades": stats["upgrades"],
                "upgrade_bytes": stats["upgrade_bytes"],
                "served_lo_expert_steps": stats["served_lo_expert_steps"],
                "link_utilization": round(stats["link_utilization"], 3),
                "link_gbps": round(stats["link_gbps"], 3),
                "kernel_dispatch": stats["kernel_dispatch"],
                "simulated_decode_tok_s": {k: round(v["tok_per_s"], 2)
                                           for k, v in sim.items()},
                "simulated_overlap_fraction": {k: round(v["overlap_fraction"], 3)
                                               for k, v in sim.items()},
                "hw_profile": hw.name,
            })
        else:
            report["kernel_dispatch"] = kops.dispatch_counts()
        if args.paged_kv:
            bst = backend.stats()
            report["kv"] = {k: bst[k] for k in (
                "kv_pages_used", "kv_pages_total", "kv_page_fraction", "kv_page_size",
                "prefix_hit_tokens", "cow_copies", "aliased_page_fraction")}
    finally:
        backend.close()         # release staging threads before reporting
    print(json.dumps(report))


if __name__ == "__main__":
    main()
