"""The check that decides ``correct`` fails what it must: the fp8 control,
and a run whose timed path is broken underneath (each fault a served cell
can have), driven through the rest of a run on the CPU at a smoke size.
The exchange between chips has no fault to plant: every cell runs on one
card."""

import time

import numpy as np
import pytest
import torch

from benchlib import check, paths, spec as specs
from benchlib.cell import run_cell
from benchlib.weights import make_weights
from reference import plain
from smoke import smoke_config, smoke_mix


class Broken:
    """A backend whose outputs are broken where they are produced, on every
    call: "unchanged" hands back the call's previous output, "half_batch"
    leaves the slots of the batch's second half out (zero logits), "token"
    alters one row's token in turn (its logits negated)."""

    def __init__(self, inner, fault: str, batch: int = 4):
        self.inner, self.fault, self.batch = inner, fault, batch
        self.prev, self.calls = None, 0
        self.model = inner.model

    def __getattr__(self, name):
        return getattr(self.inner, name)

    def _rows(self, slots, lg: np.ndarray) -> np.ndarray:
        self.calls += 1
        lg = np.array(lg, copy=True)
        if self.fault == "unchanged":
            out, self.prev = (self.prev if self.prev is not None and
                              self.prev.shape[1:] == lg.shape[1:] else lg), lg
            return np.resize(out, lg.shape)
        if self.fault == "half_batch":
            lg[[i for i, s in enumerate(slots) if s >= self.batch // 2]] = 0.0
        elif self.fault == "token":
            r = self.calls % lg.shape[0]
            lg[r] = -lg[r]
        return lg

    def step(self, tokens):
        return self._rows(range(self.batch), self.inner.step(tokens))

    def join_step(self):
        done = self.inner.join_step()
        if not done:
            return done
        slots = sorted(done)
        return dict(zip(slots, self._rows(slots, np.stack([done[s] for s in slots]))))


def _run(cell, wrap=None, seed=11, control=False):
    man = paths.Manifest.load()
    return run_cell(man, cell, seed, 1.5, False, t_start=time.perf_counter(), device="cpu",
                    config=smoke_config(), mix=smoke_mix(man, cell), wrap_backend=wrap,
                    control=control)


@pytest.mark.parametrize("cell", ["mixtral-decode-c4", "mixtral-prompt-1tok"])
def test_sound_run_is_correct(cell):
    res = _run(cell)
    assert res["correct"], res["check"]
    assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", ["mixtral-decode-c4", "mixtral-prompt-1tok"])
def test_control_run_reports_the_controls_verdict(cell):
    """With the control on, a run's verdict and compared numbers are the
    control's, judged by the cell's limits, and the program's own verdict
    stays in its reading."""
    res = _run(cell, control=True)
    assert res["reading"]["program"]["correct"], res["reading"]["program"]
    expect = check.control_verdict(res["reading"], paths.limits_file(cell))
    assert (res["correct"], res["check"]) == expect
    assert set(res["check"]) == set(res["reading"]["program"]["check"])


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "token"])
@pytest.mark.parametrize("cell", ["mixtral-decode-c4", "mixtral-prompt-1tok"])
def test_broken_path_is_not_correct(cell, fault):
    """Every run with the fault comes out incorrect, on every seed."""
    for seed in (11, 12, 13):
        res = _run(cell, wrap=lambda b: Broken(b, fault), seed=seed)
        assert not res["correct"], (fault, seed, res["check"])


CELLS = {"mixtral-decode-c4": "mixtral-8x7b-l8", "phi-decode-c4": "phi-3.5-moe-l8",
         "mixtral-prompt-1tok": "mixtral-8x7b-l8"}


@pytest.mark.parametrize("device", ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
@pytest.mark.parametrize("cell", sorted(CELLS))
def test_control_is_not_correct(cell, device):
    """The reference in fp8 put in the program's place comes out incorrect
    by the cell's own limits (the reference's own logits in that place
    read no error): 4 requests of 64 served tokens in a decode cell, 16
    prompts of one token in the prompt cell.  The served tokens are drawn
    at random and teacher-forced, as the check reads them: the control's
    readings are those of the token it puts first at each position."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("no CUDA card")
    # eight layers of width 256: at two layers of 64 the fp8 rounding has
    # little depth to grow through
    cfg = CELLS[cell]
    spec = specs.plain_spec(smoke_config(cfg, width=256, layers=8, vocab=2048,
                                         experts=8 if cfg.startswith("mixtral") else 16))
    limits = paths.limits_file(cell)
    man = paths.Manifest.load()
    decode = man.traffic_file(man.cell(cell))["output_len"][1] > 1
    n_req, n_tok = (4, 64) if decode else (16, 1)
    for seed in (1, 2, 3):
        w = make_weights(spec, seed, device)
        rng = np.random.default_rng(seed)
        prompts, outs, rows = {}, {}, {}
        for rid in range(n_req):
            prompts[rid] = rng.integers(0, spec["vocab_size"], 24)
            outs[rid] = rng.integers(0, spec["vocab_size"], n_tok)
            toks = torch.from_numpy(np.concatenate([prompts[rid], outs[rid][:-1]]))
            rows[rid] = list(plain.logits(w, spec, toks, 24).cpu().numpy())
        r = check.readings(w, spec, prompts, outs, rows, list(range(n_req)), reference=plain,
                           control=True)
        assert r["err_max"] < 1e-4
        ok, compared = check.control_verdict(r, limits)
        assert not ok, (seed, compared)
