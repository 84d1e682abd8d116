"""Training launcher (port of ``launch/train.py``).

Runs the port's trainer end to end: synthetic data pipeline -> train step
(autograd, through the hand-written attention backward on the card) ->
RSM coordinator -> grid checkpoints.  ``--device`` defaults to cuda;
``--smoke`` takes the reduced config, which runs on the CPU too:

  PYTHONPATH=src python -m repro_torch.launch.train --smoke --device cpu \\
      --steps 50
"""
from __future__ import annotations

import argparse
import tempfile
import time

from ..configs import get_config
from ..core.device import resolve_device
from ..data.pipeline import DataConfig
from ..optim.adamw import AdamWConfig
from ..runtime.train_loop import Trainer


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: a new temporary directory")
    ap.add_argument("--ckpt-every", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--fail-at", type=int, default=-1,
                    help="simulate a crash at this step and recover")
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_torch_ckpt_")
    print(f"arch={cfg.name} params={cfg.n_params():,} device={device}")

    trainer = Trainer(
        cfg, ckpt_dir,
        opt_cfg=AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                            total_steps=args.steps),
        data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                            global_batch=args.batch),
        n_virtual_workers=args.workers, ckpt_every=args.ckpt_every,
        device=device)

    t0 = time.time()
    for step in range(args.steps):
        if step == args.fail_at:
            print(f"[failure injection] crashing at step {step}...")
            restored = trainer.crash_and_recover()
            print(f"[recovery] resumed from committed checkpoint step {restored}")
        m = trainer.run_step()
        if step % 5 == 0 or step == args.steps - 1:
            print(f"step {m['step']:4d} ce={m['ce']:.4f} "
                  f"grad_norm={m['grad_norm']:.3f} lr={m['lr']:.2e} "
                  f"committed={trainer.coord.view.committed_step}")
    dt = time.time() - t0
    print(f"done: {args.steps} steps in {dt:.1f}s "
          f"({dt / args.steps * 1e3:.0f} ms/step); "
          f"last committed ckpt: {trainer.coord.view.committed_ckpt}")


if __name__ == "__main__":
    main()
