"""The port's BatchingServer against the JAX reference server on the trained
mixtral-smoke checkpoint, and the port's serve launcher end to end.

Both servers run the same seeded workload through HobbitBackend with
``EngineConfig(async_prefetch=False)``; urgent requests arrive mid-decode so
the SLO scheduler preempts (pause -> snapshot -> resume).  The scheduler
reads the wall clock, so the order requests run in may differ between the
servers, but each request's greedy tokens must be identical.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from benchmarks.common import CACHE_DIR, bench_config
from repro.core import EngineConfig as RefEngineConfig
from repro.core import OffloadEngine as RefEngine
from repro.models import build_model as build_ref
from repro.serving.api import HobbitBackend as RefHobbit
from repro.serving.batching import BatchingServer as RefServer
from repro.serving.batching import Request as RefRequest
from repro.training import checkpoint as ckpt
from repro_torch.core import EngineConfig, OffloadEngine
from repro_torch.models import build_model
from repro_torch.serving.api import HobbitBackend
from repro_torch.serving.batching import BatchingServer, Request
from repro_torch.serving.workload import RequestClass, WorkloadConfig, generate_workload
from repro_torch.weights import from_jax_params, load_checkpoint

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


class _Injecting:
    """Backend wrapper that submits urgent requests to the server after the
    `after`-th decode step (traffic arriving while every slot is busy)."""

    def __init__(self, inner, after, make_reqs):
        self.inner = inner
        self.model = inner.model
        self.after = after
        self.make_reqs = make_reqs
        self.server = None
        self._steps = 0

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def step(self, tokens):
        self._steps += 1
        if self._steps == self.after:
            for r in self.make_reqs():
                self.server.submit(r)
        return self.inner.step(tokens)


def _workload(vocab):
    cfg = WorkloadConfig(classes=(RequestClass("batch", prompt_tokens=(6, 14),
                                               new_tokens=(5, 10)),),
                         num_requests=6, vocab=vocab, seed=3)
    trace = generate_workload(cfg)
    return trace[:4], trace[4:]


def _serve(server_cls, request_cls, backend, vocab):
    first, urgent = _workload(vocab)
    inj = _Injecting(backend, after=3, make_reqs=lambda: [
        request_cls(rid=w.rid, prompt=w.prompt, max_new_tokens=w.max_new_tokens,
                    priority=2, ttft_slo_s=10.0) for w in urgent])
    srv = server_cls(inj, max_batch=2, max_len=40, preempt_margin=0.5)
    inj.server = srv
    for w in first:
        srv.submit(request_cls(rid=w.rid, prompt=w.prompt,
                               max_new_tokens=w.max_new_tokens))
    try:
        srv.run()
        return {r.rid: np.asarray(r.output) for r in srv.completed}, srv.preemptions
    finally:
        srv.close()


def test_batching_server_tokens_match_reference_with_preemption():
    kind = "mixtral-smoke"
    cfg = bench_config(kind)
    ref = build_ref(cfg)
    params, _ = ckpt.restore(f"{CACHE_DIR}/{kind}", ref.init(jax.random.PRNGKey(0)))
    port = build_model(cfg)
    tparams = from_jax_params(cfg, load_checkpoint(f"{CACHE_DIR}/{kind}"), device="cpu")
    kw = dict(hi_slots=16, lo_slots=8, async_prefetch=False)
    out_r, pre_r = _serve(RefServer, RefRequest,
                          RefHobbit(RefEngine(ref, params, RefEngineConfig(**kw))),
                          cfg.vocab_size)
    out_t, pre_t = _serve(BatchingServer, Request,
                          HobbitBackend(OffloadEngine(port, tparams, EngineConfig(**kw))),
                          cfg.vocab_size)
    assert pre_t >= 1 and pre_r >= 1
    assert sorted(out_t) == sorted(out_r) == list(range(6))
    for rid in out_r:
        np.testing.assert_array_equal(out_t[rid], out_r[rid])


def _serve_cli(*args):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", "mixtral-8x7b",
         "--smoke", "--device", "cpu", *args],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)


@pytest.mark.parametrize("mode", [["--serve-requests", "4", "--max-batch", "2",
                                   "--priority-every", "2"], []], ids=["server", "generate"])
def test_serve_launcher_prints_report_on_cpu(mode):
    res = _serve_cli("--backend", "hobbit", "--prompt-len", "6", "--new-tokens", "5",
                     *mode)
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["backend"] == "hobbit" and report["device"] == "cpu"
    assert report["loads"]["hi"] > 0
    counts = report["kernel_dispatch"]
    assert counts.get("gating_topk.torch", 0) > 0
    assert not any(k.endswith(".cuda") for k in counts)
    if mode:
        assert report["serving"]["requests"] == 4


def test_serve_launcher_paged_kv_raises():
    """The name dates from when --paged-kv raised NotImplementedError.  The
    flag now serves through the page pool and reports its counters; a
    shared prefix longer than a page is aliased across requests."""
    res = _serve_cli("--backend", "hobbit", "--paged-kv", "--serve-requests", "3",
                     "--max-batch", "2", "--admit-k", "1", "--page-size", "4",
                     "--shared-prefix", "9", "--prompt-len", "5", "--new-tokens", "4")
    assert res.returncode == 0, res.stderr[-2000:]
    report = json.loads(res.stdout.strip().splitlines()[-1])
    assert report["paged_kv"] and report["serving"]["requests"] == 3
    kv = report["kv"]
    assert kv["kv_pages_total"] > 0 and kv["kv_page_size"] == 4
    assert kv["prefix_hit_tokens"] >= 8
    assert report["kernel_dispatch"].get("paged_flash_decode.torch", 0) > 0
