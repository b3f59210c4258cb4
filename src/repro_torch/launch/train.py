"""Training launcher of the port.

  PYTHONPATH=src python -m repro_torch.launch.train --arch mixtral-8x7b --smoke \
      --steps 200 --batch 8 --seq 64 [--device cpu]

The JAX package's flags (``repro.launch.train``), plus ``--device``
(default ``cuda``).  Prints the config's parameter counts, a log line every
tenth of the steps, the checkpoint's path with ``--ckpt-dir`` (the
reference's format) and, last, the final history entry as JSON.
"""

import argparse
import dataclasses
import json

from repro_torch.configs import get_config, smoke_variant
from repro_torch.data.pipeline import DataConfig, batches, eval_batches
from repro_torch.device import resolve_device
from repro_torch.models import build_model
from repro_torch.training import checkpoint as ckpt
from repro_torch.training.optimizer import OptimizerConfig
from repro_torch.training.train_loop import make_eval_step, train


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_variant(cfg, vocab=args.vocab)
        cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg)
    print(f"arch={cfg.name} params={cfg.param_count()/1e6:.1f}M "
          f"active={cfg.active_param_count()/1e6:.1f}M")

    dc = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch)
    it = batches(dc, device=dev)
    if cfg.encoder is not None:
        it = _with_frames(it, cfg, dev)
    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                           total_steps=args.steps)
    eval_fn = None
    if args.eval_every:
        ev = eval_batches(dc, 2, device=dev)
        if cfg.encoder is not None:
            ev = list(_with_frames(iter(ev), cfg, dev))
        es = make_eval_step(model)

        def eval_fn(params):
            return sum(float(es(params, b)) for b in ev) / len(ev)

    state, hist = train(model, ocfg, it, args.steps, log_every=max(args.steps // 10, 1),
                        eval_fn=eval_fn, device=dev)
    if args.ckpt_dir:
        path = ckpt.save(args.ckpt_dir, state.params, step=args.steps, cfg=cfg)
        print(f"checkpoint: {path}")
    print(json.dumps(hist[-1]))


def _with_frames(it, cfg, dev):
    """Whisper's batches: the token stream's, with seeded audio frames
    (B, seq_len, d_enc) times 0.02 (the conv frontend is stubbed)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(0)
    for b in it:
        frames = rng.normal(size=(b.tokens.shape[0], cfg.encoder.seq_len,
                                  cfg.encoder.d_model)) * 0.02
        yield b._replace(audio_frames=torch.from_numpy(frames.astype(np.float32)).to(dev))


if __name__ == "__main__":
    main()
