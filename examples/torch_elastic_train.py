"""End-to-end fault-tolerant training on the PyTorch port (twin of
``examples/elastic_train.py``): train a small LM for 120 steps with
RSM-coordinated step commits, grid checkpoints, a simulated crash +
recovery, a straggler and an elastic rescale.

  PYTHONPATH=src python examples/torch_elastic_train.py [--device cpu]
"""
import argparse
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.train_loop import Trainer

ap = argparse.ArgumentParser()
ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
ap.add_argument("--steps", type=int, default=120)
args = ap.parse_args()

cfg = get_config("granite-3-2b").smoke()
ckpt_dir = tempfile.mkdtemp(prefix="repro_torch_ckpt_")

trainer = Trainer(
    cfg, ckpt_dir,
    opt_cfg=AdamWConfig(lr=3e-3, warmup_steps=10, total_steps=200),
    data_cfg=DataConfig(vocab_size=cfg.vocab_size, seq_len=64,
                        global_batch=8, seed=0),
    n_virtual_workers=4, ckpt_every=20, device=args.device)

print(f"training {cfg.name}: {cfg.n_params():,} params on {trainer.device}, "
      f"4 virtual DP workers, grid checkpoints at {ckpt_dir}")

losses = []
for step in range(args.steps):
    straggler = 3 if step == 40 else None        # worker 3 hangs at step 40
    m = trainer.run_step(straggler=straggler)
    losses.append(m["ce"])
    if step == 40:
        print(f"  step 40: straggler worker/3 noop-filled; "
              f"commit frontier {trainer.coord.view.committed_step}")
    if step == 60:
        print("  step 60: simulating full job crash...")
        restored = trainer.crash_and_recover()
        print(f"  recovered from committed checkpoint at step {restored} "
              f"(grid store, one row read)")
    if step == 80:
        trainer.scale_workers(6)
        print(f"  step 80: elastic scale-up to 6 workers "
              f"(generation {trainer.coord.view.generation}; deterministic "
              f"data pipeline needs no handoff)")
    if step % 20 == 0:
        print(f"step {m['step']:4d} ce={m['ce']:.4f} "
              f"committed={trainer.coord.view.committed_step}")

print(f"\nloss: first5={sum(losses[:5])/5:.4f} last5={sum(losses[-5:])/5:.4f}")
assert sum(losses[-5:]) < sum(losses[:5]), "loss should decrease"
print("done - loss decreased through a straggler, a crash and a rescale.")
