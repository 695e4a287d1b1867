"""End-to-end training entry point — counterpart of
:mod:`repro.launch.train`.

Wires the config registry, the synthetic data pipeline, the plan-laid-out
microbatched train step over a mesh of ranks stacked on one device
(:func:`repro_torch.launch.mesh.make_local_mesh`: ``--ranks`` ranks,
``--model-parallel`` of them along ``model``), the fault-tolerant loop
with async checkpoints and the straggler monitor together, on the CUDA
card unless ``--device cpu`` is given.  A checkpoint holds the whole
(gathered) parameter and optimizer-state trees, so a sharded run and an
unsharded one restore each other's, whatever the host count.

Across processes (``--coordinator HOST:PORT --num-hosts N --host-id I``,
one command a host) the hosts join one ``torch.distributed`` group
(NCCL on the card, gloo with ``--device cpu``; host 0 serves the
rendezvous at ``HOST:PORT``), and ``--ranks`` (global) ranks form a
:class:`~repro_torch.mesh.ProcessMesh` split along ``data`` over the
hosts.  Each host draws its own rows with ``shard=host_id,
num_shards=num_hosts``, as the reference's launcher does: the global batch
is the hosts' batches in host order.  Every host writes its shard into one
step directory, committed by host 0 after a barrier.  The process group
is destroyed on the way out, on failure too.

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

  # the same mesh over two processes (two data ranks each), one command
  # a host
  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma3-1b \\
      --smoke --model-parallel 2 --ranks 4 --device cpu \\
      --coordinator 127.0.0.1:29500 --num-hosts 2 --host-id 0   # and 1
"""
from __future__ import annotations

import argparse
import dataclasses
import json
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
                    help="HOST:PORT of host 0's rendezvous (a run across "
                    "processes)")
    ap.add_argument("--num-hosts", type=int, default=1)
    ap.add_argument("--host-id", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)

    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")
    if args.num_hosts > 1 and not args.coordinator:
        raise ValueError(f"--num-hosts {args.num_hosts} needs --coordinator "
                         "HOST:PORT")
    if not 0 <= args.host_id < args.num_hosts:
        raise ValueError(f"--host-id {args.host_id} is not one of the "
                         f"{args.num_hosts} hosts")
    from repro_torch.mesh import resolve_device

    device = resolve_device(args.device)
    if not args.coordinator:
        return _run(args, device)
    import torch.distributed as dist

    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda",
                                  args.host_id % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=f"tcp://{args.coordinator}",
                            world_size=args.num_hosts, rank=args.host_id)
    try:
        return _run(args, device)
    finally:
        dist.destroy_process_group()


def _run(args, device) -> dict:
    """The run of :func:`main` on ``device`` (in the process group when
    ``args.coordinator`` is set)."""
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import (ShapeConfig, get_config,
                                     recommended_train_config, smoke_config)
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.mesh import make_local_mesh, make_process_mesh
    from repro_torch.launch.steps import make_train_cell
    from repro_torch.pytree import tree_map
    from repro_torch.runtime import FaultTolerantLoop, StragglerMonitor

    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    train_cfg = dataclasses.replace(
        recommended_train_config(cfg),
        learning_rate=args.lr, total_steps=args.steps,
        warmup_steps=max(1, args.steps // 20))
    shape = ShapeConfig("cli", args.seq_len, args.batch, "train")
    if args.coordinator:
        mesh = make_process_mesh(args.model_parallel, ranks=args.ranks,
                                 device=device)
    else:
        mesh = make_local_mesh(args.model_parallel, ranks=args.ranks,
                               device=device)
    cell = make_train_cell(cfg, shape, mesh, train_cfg)

    gen = torch.Generator(device=device).manual_seed(train_cfg.seed)
    params, _ = cell.model.init(gen, dtype=getattr(torch,
                                                   train_cfg.param_dtype))
    params, opt_state = cell.place(params)

    def batch_at(step):
        """This host's rows of the batch of ``step`` (keyed by it: a
        restored run replays)."""
        encdec = cfg.family == "encdec"
        batch = next(make_batch_iterator(
            vocab_size=cfg.vocab_size, batch=args.batch,
            seq_len=args.seq_len, seed=train_cfg.seed, shard=args.host_id,
            num_shards=args.num_hosts, start_step=step,
            embed_dim=cfg.d_model if cfg.embedding_stub else None,
            frames=cfg.encoder.n_frames if encdec else None))
        return tree_map(lambda x: x.to(device), batch)

    barrier = None
    if args.coordinator:
        import torch.distributed as dist

        # checkpoints commit on a host-side group of their own: the async
        # save's barrier runs on a thread beside the step's collectives
        ckpt_group = dist.new_group(backend="gloo")

        def barrier():
            dist.barrier(group=ckpt_group)
    ckpt = GatheringCheckpointer(
        Checkpointer(args.ckpt_dir, host_id=args.host_id,
                     num_hosts=args.num_hosts, barrier=barrier), cell)
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
    log.info("losses %s", json.dumps(history))       # every digit
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
        """The newest step, laid out on the cell's mesh.  Every host's
        shard holds the whole trees, so a host beyond the checkpoint's
        host count reads one that is there."""
        whole = self.cell.gather(*like)
        steps = self.ckpt.list_steps()
        if not steps:
            return None
        hosts = self.ckpt.manifest(steps[-1])["num_hosts"]
        params, opt_state = self.ckpt.restore(
            steps[-1], whole, shard=self.ckpt.host_id % hosts)
        return steps[-1], self.cell.place(params, opt_state)


if __name__ == "__main__":
    main()
