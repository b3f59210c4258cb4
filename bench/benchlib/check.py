"""What decides ``correct``: the served tokens of a sample of the window's
requests, and the logits they were drawn from, against the plain reference
of the configuration's block (``bench/reference/<module>.py``, named by the
block's ``REFERENCE``).

The sample is drawn from the seed among the requests that had a token in
the window, with the request that served the most tokens always in it.
For each, the reference runs once over its prompt and served tokens
(teacher-forced).  At every served position it gives the gap by which the
served token's logit lies below the reference's best, and the relative
error of the program's logits, |program - reference| / |reference|.  With
``control`` the same positions are read under the reference computed in
fp8 (the control, which has to come out incorrect): the gap of the token
it puts first, and the error of its logits; ``control_verdict`` puts those
readings in the program's place and judges them by the cell's limits."""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch


def sample(rec, outputs: Dict[int, np.ndarray], k: int, seed: int) -> List[int]:
    """rids of the sample: the longest served request and k - 1 more."""
    cands = sorted(rid for rid, ts in rec.stamps.items()
                   if rid not in rec.warm and any(rec.in_window(t) for t in ts)
                   and len(outputs.get(rid, ())) > 0)
    if not cands:
        return []
    longest = max(cands, key=lambda r: (len(outputs[r]), -r))
    rest = [r for r in cands if r != longest]
    rng = np.random.default_rng([int(seed) % (1 << 63), 2])
    pick = rng.choice(len(rest), size=min(k - 1, len(rest)), replace=False) if rest else []
    return [longest] + sorted(rest[i] for i in pick)


def _summary(gap: np.ndarray, err: np.ndarray, prefix: str = "") -> Dict[str, float]:
    """``err_tmean`` is the mean of the smallest nine tenths of the errors:
    the largest route flips near a tie leave it, while a fault in more than
    a tenth of the positions (an error of 1 or more each) moves it."""
    if gap.size == 0:
        return {}
    low = np.sort(err)[:-(-9 * err.size // 10)]
    return {f"{prefix}gap_widest": float(gap.max()), f"{prefix}gap_mean": float(gap.mean()),
            f"{prefix}mismatch_share": float((gap > 0).mean()),
            f"{prefix}err_p50": float(np.median(err)), f"{prefix}err_mean": float(err.mean()),
            f"{prefix}err_tmean": float(low.mean()),
            f"{prefix}err_p90": float(np.percentile(err, 90)), f"{prefix}err_max": float(err.max())}


def readings(weights: dict, spec: dict, prompts: Dict[int, np.ndarray],
             outputs: Dict[int, np.ndarray], logits: Dict[int, List[np.ndarray]],
             rids: List[int], *, reference, control: bool = False) -> Dict[str, object]:
    """The sample's per-position gaps and logit errors (and the control's)
    against `reference` (a module with the block's ``logits``), on the
    weights' device, float32 with TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = weights["embed"].device
    gaps, errs, cgaps, cerrs, per, per_err, per_cerr = [], [], [], [], [], [], []
    for rid in rids:
        prompt, out = np.asarray(prompts[rid], np.int64), np.asarray(outputs[rid], np.int64)
        toks = torch.from_numpy(np.concatenate([prompt, out[:-1]]))
        ref = reference.logits(weights, spec, toks, len(prompt))
        best = ref.max(dim=-1).values
        norm = ref.norm(dim=-1)
        o = torch.from_numpy(out).to(dev)
        g = best - ref.gather(1, o[:, None])[:, 0]
        prog = torch.from_numpy(np.stack(logits[rid])).to(dev)
        e = (prog - ref).norm(dim=-1) / norm
        gaps.append(g.cpu().numpy())
        errs.append(e.cpu().numpy())
        per.append(float(g.max()))
        per_err.append(float(e.mean()))
        if control:
            c = reference.logits(weights, spec, toks, len(prompt), fp8=True)
            cgaps.append((best - ref.gather(1, c.argmax(-1)[:, None])[:, 0]).cpu().numpy())
            cerrs.append(((c - ref).norm(dim=-1) / norm).cpu().numpy())
            per_cerr.append(float(cerrs[-1].mean()))
            del c
        del ref, prog
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    cat = lambda xs: np.concatenate(xs) if xs else np.zeros((0,))  # noqa: E731
    res: Dict[str, object] = {"served_tokens": int(sum(len(x) for x in gaps)),
                              "per_request": per, "err_per_request": per_err}
    if control:
        res["control_err_per_request"] = per_cerr
    res.update(_summary(cat(gaps), cat(errs)))
    if control:
        res.update(_summary(cat(cgaps), cat(cerrs), "control_"))
    return res


def verdict(reading: Dict[str, object], limits, failed: int) -> Tuple[bool, Dict[str, dict]]:
    """correct, and each compared number beside its limit: every number the
    cell's limits file gives a limit (a number listed there without one has
    readings but no upper reading, and is not compared)."""
    compared = {k: v["limit"] for k, v in (limits or {}).items() if "limit" in v}
    check = {name: {"value": reading.get(name), "limit": lim} for name, lim in compared.items()}
    ok = (failed == 0 and reading["served_tokens"] > 0 and bool(check)
          and all(c["value"] is not None and c["value"] <= c["limit"] for c in check.values()))
    return ok, check


def control_verdict(reading: Dict[str, object], limits) -> Tuple[bool, Dict[str, dict]]:
    """The verdict on the fp8 control put in the program's place: its
    readings (``control_*``) judged by the cell's limits, as a run's are."""
    ctl = {k[len("control_"):]: v for k, v in reading.items() if k.startswith("control_")}
    ctl["served_tokens"] = reading["served_tokens"]
    return verdict(ctl, limits, 0)
