"""One run of one cell: the configuration's block, weights, backend,
warm-up and window in one ``BatchingServer.run()``, then the metrics, the
correctness check and the result line's fields."""

from __future__ import annotations

import gc
import importlib.util
from types import ModuleType
from typing import Callable, Optional

import numpy as np
import torch

from benchlib import check, devtrace, paths, spec as specs, traffic
from benchlib.loop import ClosedLoop, Probe, now, time_sampling

DEFAULT_BLOCK = "moe_gqa"


def _load(kind: str, name: str, path) -> ModuleType:
    spec = importlib.util.spec_from_file_location(f"bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reader(name: str, bench):
    return _load("metric", name, paths.metric_file(name, bench)).read


def load_block(cfg: dict, bench=paths.BENCH) -> ModuleType:
    """The configuration's block (``bench/blocks/<block>.py``; interface in
    ``bench/blocks/__init__.py``), from the benchmark directory `bench`."""
    name = cfg.get("block", DEFAULT_BLOCK)
    return _load("block", name, paths.block_file(name, bench))


def load_reference(block: ModuleType, bench=paths.BENCH) -> ModuleType:
    """The block's plain reference (``bench/reference/<REFERENCE>.py``)."""
    return _load("reference", block.REFERENCE, paths.reference_file(block.REFERENCE, bench))


def read_metrics(rec, metrics, bench=paths.BENCH) -> dict:
    """Each metric's reader on the record; a metric with nothing to read
    (None) is left out."""
    out = {}
    for m in metrics:
        v = _reader(m["name"], bench)(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def run_cell(manifest: paths.Manifest, cell_name: str, seed: int, seconds: float, trace: bool,
             *, t_start: float, device: str = "cuda", control: bool = False,
             config: Optional[dict] = None, mix: Optional[dict] = None,
             wrap_backend: Optional[Callable] = None, bench=paths.BENCH) -> dict:
    """Run `cell_name` once; returns the result line's fields and the
    readings of the check.  `config`, `mix` and `wrap_backend` stand in
    for the cell's own only in the CPU tests."""
    from repro_torch.models.model import Model
    from repro_torch.serving.api import BackendConfig, make_backend
    from repro_torch.serving.batching import BatchingServer

    cell = manifest.cell(cell_name)
    cfg = config or manifest.config_file(cell)
    mix = mix or manifest.traffic_file(cell)
    traffic.check_mix(mix)
    block = load_block(cfg, bench)
    spec = block.plain_spec(cfg)
    eng = cfg["engine"]
    dev = torch.device(device)

    model = Model(block.port_config(cfg))
    weights = block.make_weights(spec, seed, dev)
    backend = make_backend(BackendConfig(
        kind="hobbit", paged=eng["paged_kv"], page_size=eng["kv_page_size"],
        prefill_chunk=eng["prefill_chunk"], engine=specs.engine_config(cfg)), model, weights)
    if wrap_backend is not None:
        backend = wrap_backend(backend)

    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    chunk = eng["prefill_chunk"]
    wave = traffic.warmup_wave(mix, spec["vocab_size"], chunk, rng)
    stream = traffic.jobs(mix, spec["vocab_size"], rng)
    tracer = devtrace.Tracer(mix["trace_start_frac"] * seconds, mix["trace_s"]) if trace else None
    loop = ClosedLoop(None, mix, stream, seconds=seconds, chunk=chunk, spec=spec,
                      block=block, t_start=t_start, tracer=tracer)
    probe = Probe(backend, loop)
    srv = None
    try:
        srv = BatchingServer(probe, max_batch=mix["max_batch"],
                             max_len=traffic.max_len(mix, chunk, eng["kv_page_size"]),
                             temperature=mix["temperature"], admit_k=mix["admit_k"],
                             policy="fifo")
        loop.server = srv
        time_sampling(srv, loop.rec)
        loop.start(wave)
        srv.run()
        if dev.type == "cuda":
            torch.cuda.synchronize()
        t_end = now()
        peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
        outputs = {r.rid: np.asarray(r.output) for r in srv.completed}
        prompts = {r.rid: np.asarray(r.prompt) for r in srv.completed}
    finally:
        if srv is not None:
            srv.close()
        else:
            getattr(backend, "close", lambda: None)()
    loop.server = None                  # drop the engine before the reference runs
    rec = loop.rec
    if tracer is not None:
        rec.excluded = tracer.excluded
        rec.trace = tracer.data()
    del srv, probe, backend
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    kind = "per_layer" if trace else "end_to_end"
    metrics = read_metrics(rec, manifest.metrics(cell_name, kind), bench)
    attempted = sorted(rid for rid in rec.submits if rid not in rec.warm
                       and rid in outputs and rec.submits[rid] <= rec.w1
                       and (rec.stamps[rid][-1] if rec.stamps[rid] else t_end) >= rec.w0)
    failed = [rid for rid in attempted if rid in rec.failed or len(outputs[rid]) == 0]
    rids = check.sample(rec, outputs, mix["check_requests"], seed)
    t_check = now()
    reading = check.readings(weights, spec, prompts, outputs, rec.logits, rids,
                             reference=load_reference(block, bench), control=control)
    reading["check_s"] = now() - t_check
    limits = paths.limits_file(cell_name, bench)
    ok, compared = check.verdict(reading, limits, len(failed))
    if control:                         # the control in the program's place decides
        reading["program"] = {"correct": ok, "check": compared}
        ok, compared = check.control_verdict(reading, limits)
    res = {"correct": ok, "attempted": len(attempted), "failed": len(failed),
           "metrics": metrics, "peak": int(peak), "reading": reading, "check": compared,
           "window_s": rec.w1 - rec.w0, "setup_s": rec.w0 - t_start,
           "rec": rec, "sample": rids,
           "window_counters": {k: rec.stats_before(rec.w1)[1][k] - rec.stats_before(rec.w0)[1][k]
                               for k in rec.stats[0][1]}}
    if trace and rec.trace is not None:
        res["busy_s"] = rec.trace.busy_s()
        res["trace_window_s"] = rec.trace.window_s
        res["breakdown"] = devtrace.breakdown(rec)
    return res
