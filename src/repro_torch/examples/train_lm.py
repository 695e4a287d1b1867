"""End-to-end training example: a small LM for a few hundred steps —
the counterpart of ``examples/train_lm.py``.

Uses the whole substrate — synthetic data pipeline, plan-laid-out
microbatched train step over a local mesh, async checkpoints — on a
small model.  The loss must drop well below the unigram entropy of the
synthetic Markov stream, proving the pipeline learns the transition
structure end-to-end.  Runs on the CUDA card unless ``--device cpu`` is
given.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_lm [--steps 200]
      (pass --arch mamba2-130m --full for the real 130M config)
"""
import argparse
import time

import torch

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import (ShapeConfig, TrainConfig, get_config,
                                 smoke_config)
from repro_torch.configs.base import ModelConfig
from repro_torch.data import make_batch_iterator
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.launch.steps import make_train_cell
from repro_torch.mesh import resolve_device

DEMO_CONFIG = ModelConfig(
    name="demo-20m", family="dense", n_layers=8, d_model=256,
    n_heads=8, n_kv_heads=4, d_ff=1024, vocab_size=2048, head_dim=32,
    max_seq_len=1024, tie_embeddings=True, sub_quadratic=False,
)


def main(argv=None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--arch", default=None)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--ckpt-dir", default="results/example_ckpt")
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    if args.arch:
        cfg = get_config(args.arch) if args.full else smoke_config(args.arch)
    else:
        cfg = DEMO_CONFIG
    print(f"model: {cfg.name} ({cfg.param_count()/1e6:.1f}M params)")

    train_cfg = TrainConfig(
        learning_rate=3e-3, warmup_steps=20, total_steps=args.steps,
        optimizer="adamw", remat=False, compute_dtype="float32")
    mesh = make_local_mesh(device=device)
    shape = ShapeConfig("example", args.seq_len, args.batch, "train")
    cell = make_train_cell(cfg, shape, mesh, train_cfg)

    gen = torch.Generator(device=device).manual_seed(0)
    params, _ = cell.model.init(gen)
    params, opt_state = cell.place(params)

    data = make_batch_iterator(vocab_size=cfg.vocab_size, batch=args.batch,
                               seq_len=args.seq_len, seed=0)
    ckpt = Checkpointer(args.ckpt_dir, keep=2)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        batch = {k: v.to(device) for k, v in next(data).items()}
        params, opt_state, m = cell.step_fn(params, opt_state, batch, step)
        if step % 20 == 0 or step == args.steps - 1:
            loss = float(m["loss"])
            losses.append(loss)
            print(f"step {step:4d}  loss {loss:.4f}  "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)")
        if (step + 1) % 100 == 0:
            ckpt.save_async(step + 1, cell.gather(params, opt_state))
    ckpt.wait()
    print(f"\nloss {losses[0]:.3f} -> {losses[-1]:.3f} "
          f"({args.steps} steps, {time.time()-t0:.0f}s)")
    assert losses[-1] < losses[0] - 0.5, "model failed to learn"
    print("OK: the pipeline learns the synthetic Markov structure")
    return losses


if __name__ == "__main__":
    main()
