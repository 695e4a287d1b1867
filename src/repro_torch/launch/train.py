"""End-to-end training entry point — counterpart of
:mod:`repro.launch.train`.

Wires the config registry, the synthetic data pipeline, the plan-laid-out
microbatched train step over a mesh of ranks stacked on one device
(:func:`repro_torch.launch.mesh.make_local_mesh`: ``--ranks`` ranks,
``--model-parallel`` of them along ``model``), the fault-tolerant loop
with async checkpoints and the straggler monitor together, on the CUDA
card unless ``--device cpu`` is given.  A checkpoint holds the whole
(gathered) parameter and optimizer-state trees, so a sharded run and an
unsharded one restore each other's.  A run across processes
(``--coordinator``, ``--num-hosts`` > 1) needs the ``torch.distributed``
backend and is refused.

Examples:
  # a smoke-size model for 300 steps on the CPU
  PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-130m \\
      --smoke --steps 300 --device cpu

  # gemma3-1b at full size on the card
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --steps 30

  # 4 ranks, 2 along the model axis (a (2, 2) mesh)
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --model-parallel 2 --ranks 4 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import logging
import time

import torch

log = logging.getLogger("repro_torch.train")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-size)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--model-parallel", type=int, default=1)
    ap.add_argument("--ranks", type=int, default=None,
                    help="virtual ranks stacked on the device (default: "
                    "--model-parallel)")
    ap.add_argument("--ckpt-dir", default="results/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--coordinator", default=None,
                    help="multi-host coordinator address")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import (ShapeConfig, get_config,
                                     recommended_train_config, smoke_config)
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import DISTRIBUTED, make_train_cell
    from repro_torch.mesh import resolve_device
    from repro_torch.models.blocks import not_ported
    from repro_torch.pytree import tree_map
    from repro_torch.runtime import FaultTolerantLoop, StragglerMonitor

    if args.coordinator or args.num_hosts > 1:
        raise not_ported("a multi-host run (--coordinator)", DISTRIBUTED)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    train_cfg = dataclasses.replace(
        recommended_train_config(cfg),
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 20))
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    mesh = make_local_mesh(args.model_parallel, ranks=args.ranks,
                           device=device)
    cell = make_train_cell(cfg, shape, mesh, train_cfg)

    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    params, _ = cell.model.init(gen, dtype=getattr(torch,
                                                   train_cfg.param_dtype))
    params, opt_state = cell.place(params)

    def batch_at(step):
        """The batch of ``step`` (keyed by it: a restored run replays)."""
        encdec = cfg.family == "encdec"
        batch = next(make_batch_iterator(
            vocab_size=cfg.vocab_size, batch=args.batch,
            seq_len=args.seq_len, seed=train_cfg.seed, shard=args.host_id,
            num_shards=args.num_hosts, start_step=step,
            embed_dim=cfg.d_model if cfg.embedding_stub else None,
            frames=cfg.encoder.n_frames if encdec else None))
        return tree_map(lambda x: x.to(device), batch)

    ckpt = GatheringCheckpointer(
        Checkpointer(args.ckpt_dir, host_id=args.host_id,
                     num_hosts=args.num_hosts), cell)
    monitor = StragglerMonitor()
    history: list[float] = []

    def step_fn(state, step):
        params, opt_state = state
        t0 = time.perf_counter()
        params, opt_state, m = cell.step_fn(params, opt_state,
                                            batch_at(step), step)
        loss = float(m["loss"])             # waits for the step
        status = monitor.observe(time.perf_counter() - t0)
        if status != "ok":
            log.warning("straggler status at step %d: %s", step, status)
        history.append(loss)
        if step % args.log_every == 0:
            log.info("step %5d loss %.4f ce %.4f gnorm %.2f lr %.2e",
                     step, loss, float(m["ce"]), float(m["grad_norm"]),
                     float(m["lr"]))
        return params, opt_state

    loop = FaultTolerantLoop(step_fn=step_fn, checkpointer=ckpt,
                             checkpoint_every=args.ckpt_every)
    state = (params, opt_state)
    start = 0
    restored = ckpt.restore_latest(state)
    if restored is not None:
        start, state = restored
        log.info("resumed from step %d", start)
    state = loop.run(state, start_step=start, num_steps=args.steps - start)
    ckpt.save(args.steps, state)
    if len(history) >= 2:
        log.info("loss: first %.4f -> last %.4f", history[0], history[-1])
    params, opt_state = cell.gather(*state)
    return {"params": params, "opt_state": opt_state, "losses": history,
            "start": start, "mesh": mesh}


class GatheringCheckpointer:
    """A :class:`~repro_torch.checkpoint.Checkpointer` of a train cell's
    (params, opt_state) as the cell stores them: it saves the gathered
    (whole) trees and lays restored ones out again, so a checkpoint holds
    the same leaves whatever the mesh."""

    def __init__(self, ckpt, cell) -> None:
        self.ckpt, self.cell = ckpt, cell

    def save(self, step: int, state) -> str:
        return self.ckpt.save(step, self.cell.gather(*state))

    def save_async(self, step: int, state) -> None:
        self.ckpt.save_async(step, self.cell.gather(*state))

    def wait(self) -> None:
        self.ckpt.wait()

    def restore_latest(self, like):
        got = self.ckpt.restore_latest(self.cell.gather(*like))
        if got is None:
            return None
        step, (params, opt_state) = got
        return step, self.cell.place(params, opt_state)


if __name__ == "__main__":
    main()
