"""Dry run of the production mesh: trace every (arch x input shape) step at
full width over 256 (or 512) H100s on one host, with fake tensors, and emit
a JSON record per pair with per-GPU FLOPs, bytes, collective bytes, peak
memory and a roofline from the H100 SXM5 datasheet constants -- the port of
the JAX package's ``launch/dryrun.py``.

Where the reference lowers and compiles on 512 placeholder host devices,
the port starts PyTorch's fake process group at the mesh's world size,
builds the ``DeviceMesh`` and runs the step once under ``FakeTensorMode``
(fake CPU tensors: nothing touches a device) inside
``op_analysis.OpAnalysis``.  A CPU mesh would turn DTensor's shard-to-shard
all_to_all into an all_gather (gloo has none); the dry run keeps the
all_to_all an NCCL mesh runs.  Every number is an analysis, not a
measurement.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] --out results.jsonl
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import time
import traceback

from repro_torch.configs import (ARCHS, ASSIGNED_ARCHS, INPUT_SHAPES, get_config,
                                 shape_supported)
from repro_torch.launch.mesh import (make_production_mesh, num_chips, production_shape,
                                     start_fake_process_group)
from repro_torch.launch.roofline import Roofline, collective_bytes, model_flops


def _local_bytes(tree) -> int:
    """Bytes of this rank's shards of every tensor in `tree`."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    from repro_torch.quant.quantize import QTensor

    n = 0
    for x in tree_flatten(tree, is_leaf=lambda v: isinstance(v, QTensor))[0]:
        for t in (x.astuple() if isinstance(x, QTensor) else (x,)):
            if isinstance(t, DTensor):
                t = t.to_local()
            if isinstance(t, torch.Tensor):
                n += t.numel() * t.element_size()
    return n


def _storages(tree) -> set:
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    out = set()
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            out.add(id(t.untyped_storage()))
    return out


@contextlib.contextmanager
def fake_mesh_patches():
    """Two corrections to DTensor for a fake run on a CPU mesh:
      * shard-to-shard redistribution takes DTensor's all_to_all op, as on
        an NCCL mesh, where a CPU mesh falls back to all_gather + chunk;
      * a strided shard's size and offset arithmetic (index math on small
        host tensors, read back with .tolist()) runs outside the fake mode,
        where it would be data-dependent."""
    import torch
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import placement_types as pt

    def all_to_all(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)

    def real(fn):
        memo = {}

        def wrapped(self, *a, **k):
            # the same (placement, size, chunks, rank) recurs at every layer
            key = (repr(self), a, tuple(sorted(k.items())))
            if key not in memo:
                with unset_fake_temporarily():
                    memo[key] = fn(self, *a, **k)
            size, offsets = memo[key]
            return size, (list(offsets) if isinstance(offsets, list) else offsets)
        return wrapped

    # (owner, attribute, replacement) for what this PyTorch version has
    patches = []
    if hasattr(pt, "shard_dim_alltoall") and hasattr(torch.ops._dtensor, "shard_dim_alltoall"):
        patches.append((pt, "shard_dim_alltoall", all_to_all))
    strided = getattr(pt, "_StridedShard", None)
    for name in ("local_shard_size_and_offset", "_local_shard_size_and_offset"):
        if strided is not None and hasattr(strided, name):
            patches.append((strided, name, real(getattr(strided, name))))
    saved = [(owner, name, getattr(owner, name)) for owner, name, _ in patches]
    for owner, name, new in patches:
        setattr(owner, name, new)
    try:
        yield
    finally:
        for owner, name, old in saved:
            setattr(owner, name, old)


def run_one(arch: str, shape_name: str, *, multi_pod: bool = False,
            verbose: bool = True, expert_bits: int = 0) -> dict:
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.op_analysis import OpAnalysis
    from repro_torch.launch.specs import input_specs

    cfg = get_config(arch)
    if expert_bits and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_precision=f"int{expert_bits}"))
    dims, _ = production_shape(multi_pod)
    mesh_name = "x".join(str(s) for s in dims)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
           "multi_pod": multi_pod, "status": "skip"}
    if not shape_supported(arch, shape_name):
        rec["reason"] = "long-context skip (the reference's LONG_CONTEXT_SKIPS)"
        return rec
    t0 = time.time()
    try:
        start_fake_process_group(math.prod(dims))
        mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
        with FakeTensorMode(allow_non_fake_inputs=True), fake_mesh_patches():
            step_fn, args, _, donate = input_specs(cfg, shape_name, mesh)
            t_build = time.time() - t0
            ana = OpAnalysis(mesh)
            ana.track(args)
            arg_bytes = _local_bytes(args)
            donated = _storages([args[i] for i in donate])
            with ana:
                out = step_fn(*args)
            t_lower = time.time() - t0 - t_build
            out_bytes = _local_bytes(out)
            alias = sum(_local_bytes(t) for t in _leaves(out)
                        if _storages(t) & donated)
        res = ana.result()
        coll = collective_bytes(res)
        peak = res["peak_bytes"]
        shape = INPUT_SHAPES[shape_name]
        n_tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
        rec.update({
            "status": "ok",
            "build_s": round(t_build, 1),
            "lower_s": round(t_lower, 1),
            "flops_per_chip": float(res["flops"]),
            "bytes_per_chip": float(res["bytes"]),
            "collectives": coll,
            "collective_axes": res["axis_bytes"],
            "memory": {
                "argument_bytes": arg_bytes,
                "output_bytes": out_bytes,
                "temp_bytes": max(peak - arg_bytes - out_bytes + alias, 0),
                "alias_bytes": alias,
                "peak_bytes_per_chip": peak,
            },
            "n_tokens": n_tokens,
            "model_flops": model_flops(cfg, shape, n_tokens),
            "chips": num_chips(mesh),
            "ops": res["ops"],
        })
        rl = Roofline(arch, shape_name, mesh_name, rec["flops_per_chip"],
                      rec["bytes_per_chip"], coll["total"],
                      nvlink_bytes_per_chip=res["axis_bytes"].get("model", 0.0))
        rec["roofline"] = rl.asdict()
        if verbose:
            print(f"[{arch} x {shape_name} @ {mesh_name}] OK "
                  f"build={t_build:.1f}s trace={t_lower:.1f}s")
            print(f"  memory: {json.dumps(rec['memory'])}")
            print(f"  per GPU: flops={rec['flops_per_chip']:.3e} "
                  f"bytes={rec['bytes_per_chip']:.3e}")
            print(f"  collectives: {json.dumps(coll)} by axis {json.dumps(res['axis_bytes'])}")
            print(f"  roofline (H100 SXM5 datasheet): compute={rl.compute_s:.4e}s "
                  f"memory={rl.memory_s:.4e}s collective={rl.collective_s:.4e}s "
                  f"-> {rl.bottleneck}-bound")
        del out, args
    except Exception as e:  # noqa
        rec["status"] = "fail"
        rec["error"] = f"{type(e).__name__}: {e}"[:2000]
        rec["traceback"] = traceback.format_exc()[-3000:]
        if verbose:
            print(f"[{arch} x {shape_name} @ {mesh_name}] FAIL {rec['error'][:500]}")
    finally:
        torch.distributed.destroy_process_group()
    return rec


def _leaves(tree):
    from torch.utils._pytree import tree_flatten
    return tree_flatten(tree)[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None,
                    choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--all", action="store_true",
                    help="run every assigned (arch x shape) pair")
    ap.add_argument("--include-paper-archs", action="store_true",
                    help="also dry-run mixtral-8x7b / phi-moe")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--expert-bits", type=int, default=0, choices=[0, 4, 8],
                    help="quantized resident experts (decode)")
    ap.add_argument("--out", type=str, default=None, help="append JSONL here")
    args = ap.parse_args(argv)

    if args.all:
        archs = list(ASSIGNED_ARCHS)
        if args.include_paper_archs:
            archs += [a for a in ARCHS if a not in archs]
        pairs = [(a, s) for a in archs for s in INPUT_SHAPES]
    else:
        assert args.arch and args.shape, "--arch and --shape (or --all)"
        pairs = [(args.arch, args.shape)]

    n_fail = 0
    for arch, shape in pairs:
        rec = run_one(arch, shape, multi_pod=args.multi_pod,
                      expert_bits=args.expert_bits)
        if args.expert_bits:
            rec["expert_bits"] = args.expert_bits
        n_fail += rec["status"] == "fail"
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    sys.exit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
