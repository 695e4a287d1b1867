"""The port's training substrate on the CPU, held against the JAX
package: the synthetic data pipeline (its transition matrix and unigram
equal the reference's, rtol 1e-6; its draws are deterministic per
(seed, step, shard) and, a pinned difference, are a ``torch.Generator``'s,
not ``jax.random``'s bits), the checkpointer (a checkpoint written by
either package restores in the other, bit for bit; async save, ``keep``,
a torn ``.tmp`` directory ignored), ``FaultTolerantLoop`` (a planted
``StepFailure`` and a restore give the uninterrupted run's state bit for
bit) and the train entry point, ``python -m repro_torch.launch.train --smoke
--device cpu`` for 3 steps, with ``--model-parallel 2 --ranks 4`` on a
(2, 2) stacked mesh, and the ``train_lm`` example until its learning
check, which 3 steps cannot pass.
"""
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def test_data_pipeline_matches_reference_and_pins_its_draws():
    from repro.data.pipeline import SyntheticLM as JSyntheticLM
    from repro.data.pipeline import make_batch_iterator as jbatches
    from repro_torch.data import SyntheticLM, make_batch_iterator

    j, t = JSyntheticLM(300, seed=5), SyntheticLM(300, seed=5)
    np.testing.assert_allclose(t._trans.numpy(), np.asarray(j._trans),
                               rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(t._unigram.numpy(), np.asarray(j._unigram))
    assert t._band == j._band

    def first(it):
        return next(it)
    kw = dict(vocab_size=300, batch=4, seq_len=16, seed=5)
    a = first(make_batch_iterator(**kw, start_step=3))
    b = first(make_batch_iterator(**kw, start_step=3))
    c = first(make_batch_iterator(**kw, start_step=4))
    d = first(make_batch_iterator(**kw, start_step=3, shard=1, num_shards=2))
    assert set(a) == {"labels", "tokens"}
    assert a["tokens"].dtype == torch.int32 and a["tokens"].shape == (4, 16)
    assert int(a["tokens"].min()) >= 0 and int(a["tokens"].max()) < 300
    torch.testing.assert_close(a["tokens"], b["tokens"], rtol=0, atol=0)
    assert not torch.equal(a["tokens"], c["tokens"])
    assert d["tokens"].shape == (2, 16)
    # the pinned difference: the same distribution, not jax.random's bits
    want = next(jbatches(**kw, start_step=3))
    assert not np.array_equal(a["tokens"].numpy(), np.asarray(want["tokens"]))
    # the stubs: precomputed embeddings, and frames beside the tokens
    e = first(make_batch_iterator(**kw, embed_dim=8))
    assert set(e) == {"labels", "embeds"} and e["embeds"].shape == (4, 16, 8)
    f = first(make_batch_iterator(**kw, embed_dim=8, frames=6))
    assert set(f) == {"labels", "tokens", "frames"}
    assert f["frames"].shape == (4, 6, 8)
    with pytest.raises(ValueError, match="frames requires embed_dim"):
        first(make_batch_iterator(**kw, frames=6))


def _state(seed):
    rng = np.random.default_rng(seed)
    params = {"embed": rng.normal(size=(5, 3)).astype(np.float32),
              "slots": {"slot0": {"w": rng.normal(size=(2, 3, 3)).astype(
                  np.float32)}}}
    opt = {"count": np.int32(7), "m": params, "v": params}
    return params, opt


def test_checkpoints_restore_across_packages(tmp_path):
    """A (params, optimizer state) pair written by the reference restores
    in the port, and the port's in the reference: the same leaf names in
    the manifest (JAX's sorted key order), every value bit for bit."""
    from repro.checkpoint import Checkpointer as JCheckpointer
    from repro_torch import convert
    from repro_torch.checkpoint import Checkpointer

    params, opt = _state(0)
    jtree = jax.tree_util.tree_map(jnp.asarray, (params, opt))
    like = (convert.params_from_numpy(params, "cpu"),
            convert.params_from_numpy(opt, "cpu"))
    JCheckpointer(str(tmp_path / "j")).save(12, jtree)
    step, got = Checkpointer(str(tmp_path / "j")).restore_latest(
        jax.tree_util.tree_map(torch.zeros_like, like))
    assert step == 12
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    Checkpointer(str(tmp_path / "t")).save(13, like)
    jck = JCheckpointer(str(tmp_path / "t"))
    assert jck.list_steps() == [13]
    back = jck.restore(13, jax.tree_util.tree_map(jnp.zeros_like, jtree))
    for g, w in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jtree)):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    import json
    names = [json.load(open(tmp_path / d / "step_000000{}".format(s)
                            / "manifest.json"))["names"]
             for d, s in (("j", 12), ("t", 13))]
    assert names[0] == names[1] and names[0][0] == "0/embed"


def test_async_save_keep_and_torn_tmp(tmp_path):
    """``save_async`` writes in the background (``wait`` drains it);
    ``keep`` leaves the newest steps; a torn ``.tmp`` directory (a crash
    mid-save) is never listed nor restored; a shape change is refused;
    bfloat16 leaves round-trip."""
    from repro_torch.checkpoint import Checkpointer

    ck = Checkpointer(str(tmp_path), keep=2)
    tree = {"w": torch.arange(6.0).view(2, 3),
            "h": torch.ones(4, dtype=torch.bfloat16) / 3}
    for step in (1, 2, 3):
        ck.save_async(step, {"w": tree["w"] + step, "h": tree["h"]})
    ck.wait()
    assert ck.list_steps() == [2, 3]
    torn = tmp_path / "step_00000009.tmp0"
    torn.mkdir()
    (torn / "manifest.json").write_text("{}")
    assert ck.list_steps() == [2, 3]
    step, got = ck.restore_latest(tree)
    assert step == 3
    torch.testing.assert_close(got["w"], tree["w"] + 3, rtol=0, atol=0)
    assert got["h"].dtype == torch.bfloat16
    torch.testing.assert_close(got["h"], tree["h"], rtol=0, atol=0)
    with pytest.raises(ValueError, match="shape mismatch"):
        ck.restore(3, {"w": torch.zeros(3, 2), "h": tree["h"]})


def _train_loop(tmp, fail_at):
    """6 steps of the port's train step on gemma3-1b's smoke config at 2
    layers (a checkpoint every 2 steps) with a ``StepFailure`` planted
    once at ``fail_at``; returns (state, restores)."""
    import dataclasses

    from repro_torch.checkpoint import Checkpointer
    from repro_torch.configs import (ShapeConfig, TrainConfig,
                                     smoke_config)
    from repro_torch.data import make_batch_iterator
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell
    from repro_torch.runtime import FaultTolerantLoop, StepFailure

    cfg = dataclasses.replace(smoke_config("gemma3-1b"), n_layers=2)
    cell = make_train_cell(cfg, ShapeConfig("t", 16, 2, "train"),
                           make_local_mesh(device="cpu"),
                           TrainConfig(compute_dtype="float32",
                                       warmup_steps=2, total_steps=6,
                                       learning_rate=1e-2))
    params, _ = cell.model.init(torch.Generator().manual_seed(0))
    failed = []

    def hook(step):
        if step == fail_at and not failed:
            failed.append(step)
            raise StepFailure(f"planted at step {step}")

    def step_fn(state, step):
        batch = next(make_batch_iterator(vocab_size=cfg.vocab_size, batch=2,
                                         seq_len=16, start_step=step))
        p, s, _ = cell.step_fn(*state, batch, step)
        return p, s

    loop = FaultTolerantLoop(step_fn=step_fn,
                             checkpointer=Checkpointer(str(tmp)),
                             checkpoint_every=2, backoff_s=0.0,
                             failure_hook=hook)
    state = loop.run((params, cell.optimizer.init(params)), start_step=0,
                     num_steps=6)
    return state, loop.restores


def test_fault_tolerant_loop_recovers_to_the_uninterrupted_run(tmp_path):
    want, restores = _train_loop(tmp_path / "a", fail_at=None)
    assert restores == 0
    got, restores = _train_loop(tmp_path / "b", fail_at=5)
    assert restores == 1
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_train_entry_point_runs_three_steps_on_the_cpu(tmp_path):
    """``python -m repro_torch.launch.train --smoke --device cpu``: three
    steps, a checkpoint at the end; a second run (in this process)
    resumes from it; a run across processes (``--coordinator``) raises
    naming the distributed backend."""
    from repro_torch.launch import train

    args = ["--arch", "gemma3-1b", "--smoke", "--steps", "3", "--batch",
            "2", "--seq-len", "16", "--device", "cpu", "--log-every", "1",
            "--ckpt-dir", str(tmp_path / "ck")]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                          *args], env=env, capture_output=True, text=True,
                         timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "step     2 loss" in out.stderr and "loss: first" in out.stderr
    assert sorted(os.listdir(tmp_path / "ck")) == ["step_00000003"]
    again = train.main(args)
    assert again["start"] == 3 and again["losses"] == []
    with pytest.raises(NotImplementedError, match="torch.distributed "
                       "backend"):
        train.main(args + ["--coordinator", "localhost:1234"])


def test_train_entry_point_across_ranks(tmp_path):
    """``--model-parallel 2 --ranks 4``: two steps on a (2, 2) mesh, its
    gathers and psums counted, a checkpoint of the whole trees, which a
    one-rank run resumes from; ``--num-hosts 2`` is refused."""
    from repro_torch.launch import train

    args = ["--arch", "gemma3-1b", "--smoke", "--steps", "2", "--batch",
            "4", "--seq-len", "16", "--device", "cpu", "--log-every", "1",
            "--ckpt-dir", str(tmp_path / "ck")]
    got = train.main(args + ["--model-parallel", "2", "--ranks", "4"])
    mesh = got["mesh"]
    assert mesh.shape == {"data": 2, "model": 2}
    assert mesh.launches["psum"] > 0 and mesh.launches["all_gather"] > 0
    assert len(got["losses"]) == 2 and all(np.isfinite(got["losses"]))
    assert got["params"]["embed"].shape == (512, 128)
    again = train.main(args)
    assert again["start"] == 2 and again["losses"] == []
    with pytest.raises(NotImplementedError, match="torch.distributed "
                       "backend"):
        train.main(args + ["--num-hosts", "2"])


def test_train_lm_example_runs_to_its_check(tmp_path):
    """``python -m repro_torch.examples.train_lm --device cpu --steps 3``
    runs the whole path; 3 steps cannot pass its learning check, whose
    own assertion is what ends it.  Without ``--device`` the example, as
    ``make_local_mesh()``, takes the card, and raises where there is
    none."""
    from repro_torch.examples import train_lm
    from repro_torch.launch.mesh import make_local_mesh

    if not torch.cuda.is_available():
        for entry in (lambda: train_lm.main(["--steps", "1"]),
                      make_local_mesh):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                entry()
    with pytest.raises(AssertionError, match="model failed to learn"):
        train_lm.main(["--device", "cpu", "--steps", "3", "--batch", "2",
                       "--seq-len", "32", "--ckpt-dir", str(tmp_path)])
