"""Training launcher on one device — ``src/repro/launch/train.py`` with
``--device`` (default ``cuda``; ``cpu`` runs the plain versions).

  python -m repro_torch.launch.train --arch granite-3-2b --steps 10 \\
      --batch 8 --seq 512 --device cuda
  python -m repro_torch.launch.train --smoke --steps 3 --device cpu

f32 params and AdamW moments, per-layer remat, batches from the
synthetic corpus (``training.data.packed_batches``), random weights from
`--seed`. On CUDA the attention's and the selective scan's forward and
backward run on the hand-written kernels, so every kind trains there
(``--arch zamba2-2.7b --smoke`` included).
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.configs import get_config, get_smoke_config
from repro_torch.models.model import Model
from repro_torch.training import (OptimizerConfig, build_train_step,
                                  init_train_state, packed_batches,
                                  save_checkpoint)
from repro_torch.training.optimizer import leaves


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--checkpoint", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device (cuda, or cpu)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = Model(cfg, device=args.device)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    params, opt = init_train_state(model, gen)
    n_params = sum(p.numel() for p in leaves(params))
    print(f"arch={cfg.name} params={n_params / 1e6:.1f}M "
          f"batch={args.batch}x{args.seq} device={model.device}", flush=True)

    ocfg = OptimizerConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                           total_steps=args.steps)
    step_fn = build_train_step(model, ocfg, microbatches=args.microbatches)
    data = packed_batches(cfg.vocab_size, args.batch, args.seq,
                          seed=args.seed)

    t0 = time.time()
    for step in range(1, args.steps + 1):
        batch = {k: torch.from_numpy(v).to(model.device)
                 for k, v in next(data).items()}
        params, opt, metrics = step_fn(params, opt, batch)
        if step % args.log_every == 0 or step == 1:
            toks = args.batch * args.seq * step
            print(f"step {step:5d} loss {float(metrics['loss']):.4f} "
                  f"gnorm {float(metrics['grad_norm']):.2f} "
                  f"lr {float(metrics['lr']):.2e} "
                  f"tok/s {toks / (time.time() - t0):.0f}", flush=True)
    if args.checkpoint:
        save_checkpoint(args.checkpoint, params, opt, step=args.steps)
        print(f"saved checkpoint to {args.checkpoint}")


if __name__ == "__main__":
    main()
