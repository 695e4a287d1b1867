"""``python -m repro_torch.launch.train`` across processes on the CPU
(``--coordinator 127.0.0.1:<free port> --num-hosts 2 --device cpu``,
gloo), gemma3-1b's smoke config, 2 ranks along ``data`` (one a host),
batch 4 x 16, 3 steps, a checkpoint every 2.

The commands run one round at a time, each round's two hosts at once:
(1) the two hosts; (2) the two hosts again from a copy of round 1's
step-2 checkpoint.  Between them, in this process, the same entry point
(``launch.train.main``) on one process with ``--ranks 2``, its batch
iterator drawing the two hosts' shards in host order (the same global
batch), is the reference; the restores across host counts are checked
in this process too, by the leaves they restore.  Every loss (logged
with every digit) and every checkpointed leaf is compared exactly:
tolerance none.
"""
import json
import os
import re
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--arch", "gemma3-1b", "--smoke", "--steps", "3", "--batch", "4",
        "--seq-len", "16", "--device", "cpu", "--log-every", "1",
        "--ckpt-every", "2", "--ranks", "2"]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _start(ckpt):
    """The two hosts' commands, started."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    addr = f"127.0.0.1:{_free_port()}"
    return [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *ARGS,
         "--ckpt-dir", str(ckpt), "--coordinator", addr, "--num-hosts", "2",
         "--host-id", str(h)], env=env, cwd=ckpt.parent, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE) for h in range(2)]


def _losses(procs):
    """Every host's logged losses; a host that fails fails the test."""
    out = []
    for p in procs:
        _, err = p.communicate(timeout=300)
        assert p.returncode == 0, err[-3000:]
        out.append(json.loads(re.findall(r"losses (\[.*\])", err)[-1]))
    return out


def _copy_step(src, dst, step):
    dst.mkdir()
    shutil.copytree(src / f"step_{step:08d}", dst / f"step_{step:08d}")
    return dst


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("process_launch")
    got = {"hosts": _losses(_start(tmp / "two"))}
    one = _one_process(tmp / "one")
    into_one = _restores(_copy_step(tmp / "two", tmp / "into_one", 2),
                         host_id=0, num_hosts=1)
    host1 = _restores(tmp / "one", host_id=1, num_hosts=2)
    got["restart"] = _losses(_start(_copy_step(tmp / "two",
                                               tmp / "restart", 2)))
    return tmp, got, one, into_one, host1


def _one_process(ckpt):
    """``launch.train.main`` with the commands' arguments on one process
    (``--ranks 2``), each step's batch the two hosts' shards in host
    order: (losses, final trees by leaf name)."""
    import torch

    from repro_torch import data
    from repro_torch.launch import train
    from repro_torch.pytree import flatten_with_paths

    draw = data.make_batch_iterator

    def two_hosts(**kw):
        shards = [draw(**dict(kw, shard=h, num_shards=2)) for h in range(2)]
        for parts in zip(*shards):
            yield {k: torch.cat([p[k] for p in parts]) for k in parts[0]}

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    data.make_batch_iterator = two_hosts
    try:
        out = train.main([*ARGS, "--ckpt-dir", str(ckpt)])
    finally:
        data.make_batch_iterator = draw
        torch.set_num_threads(n)
    names, leaves = flatten_with_paths((out["params"], out["opt_state"]))
    return out["losses"], {k: v.numpy() for k, v in zip(names, leaves)}


def _restores(ckpt, *, host_id, num_hosts):
    """(step, whole trees by leaf name) that host ``host_id`` of
    ``num_hosts`` restores from ``ckpt`` onto a 2-rank cell."""
    import torch

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import (ShapeConfig, recommended_train_config,
                                     smoke_config)
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell
    from repro_torch.launch.train import GatheringCheckpointer
    from repro_torch.pytree import flatten_with_paths

    cfg = smoke_config("gemma3-1b")
    cell = make_train_cell(cfg, ShapeConfig("t", 16, 4, "train"),
                           make_local_mesh(1, ranks=2, device="cpu"),
                           recommended_train_config(cfg))
    params, _ = cell.model.init(torch.Generator().manual_seed(9))
    ck = GatheringCheckpointer(Checkpointer(
        str(ckpt), host_id=host_id, num_hosts=num_hosts,
        barrier=lambda: None), cell)
    step, state = ck.restore_latest(cell.place(params))
    names, leaves = flatten_with_paths(cell.gather(*state))
    return step, {n: leaf.numpy() for n, leaf in zip(names, leaves)}


def _leaves(step_dir, host):
    with np.load(step_dir / f"shard_{host}.npz") as f:
        return {k: f[k] for k in f.files}


def test_two_hosts_equal_one_process_on_the_same_batch(runs):
    """The two hosts log the same three losses, which equal the single
    process's fed the same global batch, and their final parameters and
    optimizer state equal its, leaf for leaf."""
    tmp, got, (losses, trees), _, _ = runs
    a, b = got["hosts"]
    assert len(losses) == 3 and np.isfinite(losses).all()
    assert a == b == losses
    two = _leaves(tmp / "two" / "step_00000003", 0)
    assert two.keys() == trees.keys() and len(two) > 10
    for k in trees:
        np.testing.assert_array_equal(two[k], trees[k], err_msg=k)


def test_checkpoint_holds_both_shards_and_one_manifest(runs):
    """Each step directory of the two-host run holds both hosts' shards
    (the same whole trees) and one manifest naming two hosts; no staging
    directory is left."""
    tmp = runs[0]
    ck = tmp / "two"
    assert sorted(os.listdir(ck)) == ["step_00000002", "step_00000003"]
    for step in ("step_00000002", "step_00000003"):
        assert sorted(os.listdir(ck / step)) == [
            "manifest.json", "shard_0.npz", "shard_1.npz"]
        manifest = json.loads((ck / step / "manifest.json").read_text())
        assert manifest["num_hosts"] == 2
        assert manifest["step"] == int(step.split("_")[1])
        h0, h1 = _leaves(ck / step, 0), _leaves(ck / step, 1)
        for k in h0:
            np.testing.assert_array_equal(h0[k], h1[k], err_msg=k)


def test_restart_continues_as_the_uninterrupted_run(runs):
    """The two hosts restarted from the step-2 checkpoint run step 2 only,
    with the uninterrupted run's loss, and end on its parameters."""
    tmp, got = runs[:2]
    assert got["restart"] == [got["hosts"][0][2:]] * 2
    end, want = (_leaves(tmp / d / "step_00000003", 0)
                 for d in ("restart", "two"))
    for k in want:
        np.testing.assert_array_equal(end[k], want[k], err_msg=k)


def test_checkpoints_restore_across_host_counts(runs):
    """One process restores the two hosts' step-2 checkpoint, and host 1
    of two the single process's step-3 checkpoint (which has no shard 1),
    each into the leaves that were saved."""
    tmp, _, (_, trees), into_one, host1 = runs
    for (step, restored), want, label in (
            (into_one, _leaves(tmp / "two" / "step_00000002", 0), "2 -> 1"),
            (host1, trees, "1 -> 2")):
        assert step == (2 if label == "2 -> 1" else 3), label
        assert sorted(restored) == sorted(want) and len(want) > 10, label
        for n in want:
            np.testing.assert_array_equal(restored[n], want[n],
                                          err_msg=f"{label} {n}")
