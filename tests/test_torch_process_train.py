"""The train and serve cells of the PyTorch port over a process mesh on
the CPU (two gloo processes, one spawn: ``tests/_torch_process.py``),
held against the same cells on the stacked mesh fed the same global
batch, and one case against the JAX package's train step.

Train (smoke configs at one layer, ``tests/test_torch_dist_train.py``'s
weights, batch of 8 x 16 and settings, two steps): gemma3-1b data
parallel on (4, 1) with a mask, gemma3-1b ZeRO-3 on (2, 2) with a mask,
qwen2-moe-a2.7b on (2, 1) (one dispatch group a data rank); each process
feeds its own rows, and every step's metrics, the gathered parameters and
optimizer state and the mesh's counters equal the stacked cell's bit for
bit.  The (4, 1) case is also held against the reference's step at
``tests/test_torch_dist_step.py``'s tolerance (metrics rtol 1e-5,
parameters and state rtol = atol = 1e-4).  Serve: gemma3-1b's prefill and
two decode steps on (2, 1), bf16, each process its two rows: logits and
caches bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

from tests import _torch_process as tproc
from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_dist_step import _reference_steps
from tests.test_torch_dist_train import (B, KW, LAYERS, _batch,
                                         _initial_state, _setup)
from tests.test_torch_process_mesh import _same
from tests.test_torch_train import _tree_close

#: name -> (arch, (data, model), zero3, masked)
TRAIN = {"gemma3-1b-dp": ("gemma3-1b", (4, 1), False, True),
         "gemma3-1b-zero3": ("gemma3-1b", (2, 2), True, True),
         "qwen2-moe-a2.7b": ("qwen2-moe-a2.7b", (2, 1), False, False)}
STEPS = (3, 4)
SERVE = ("gemma3-1b", (2, 1), 4, 16)        # arch, mesh, batch, length


def _train_inputs(name):
    from repro_torch import convert
    from repro_torch.configs import TrainConfig

    arch, mesh, zero3, masked = TRAIN[name]
    _, jparams, model, params = _setup(arch, LAYERS)
    state = convert.params_from_numpy(jax.tree_util.tree_map(
        np.asarray, _initial_state("adamw", jparams)), "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in _batch(model.cfg, B, 5, masked).items()}
    tcfg = TrainConfig(optimizer="adamw", zero3=zero3, strategy="dp_tp",
                       **KW)
    return (name, model.cfg, mesh, tcfg, params, state, batch, STEPS)


def _serve_inputs():
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model
    from repro_torch.pytree import tree_map

    arch, mesh, b, s = SERVE
    cfg = smoke_config(arch)
    params = build_model(cfg).init(torch.Generator().manual_seed(3))[0]
    params = tree_map(lambda t: t.to(torch.bfloat16), params)
    g = torch.Generator().manual_seed(4)
    batch = {"tokens": torch.randint(1, cfg.vocab_size, (b, s), generator=g,
                                     dtype=torch.int32)}
    toks = [torch.randint(1, cfg.vocab_size, (b,), generator=g,
                          dtype=torch.int32) for _ in range(2)]
    poss = [torch.full((b,), s - 3 + i, dtype=torch.int32) for i in range(2)]
    return ("serve", cfg, mesh, params, batch, (toks, poss))


def _stacked_train(case):
    """The case on the stacked mesh, as the children run it."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_train_cell

    _, cfg, (dp, mp), tcfg, params, state, batch, steps = case
    mesh = make_local_mesh(mp, ranks=dp * mp, device="cpu")
    mesh.log = []
    b, s = batch["labels"].shape
    cell = make_train_cell(cfg, ShapeConfig("t", s, b, "train"), mesh, tcfg)
    p, st = cell.place(params, state)
    metrics = []
    for i in steps:
        p, st, m = cell.step_fn(p, st, batch, i)
        metrics.append({k: v.detach() for k, v in m.items()})
    return {"metrics": metrics, "state": cell.gather(p, st),
            "counters": tproc.counters(mesh)}


def _stacked_serve(case):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_decode_cell, make_prefill_cell

    _, cfg, (dp, mp), params, batch, (toks, poss) = case
    mesh = make_local_mesh(mp, ranks=dp * mp, device="cpu")
    b, s = batch["tokens"].shape
    pcell = make_prefill_cell(cfg, ShapeConfig("prefill", s, b, "prefill"),
                              mesh)
    dcell = make_decode_cell(cfg, ShapeConfig("decode", s, b, "decode"), mesh)
    p, c = pcell.place(params)
    logits, c = pcell.step_fn(p, batch, c)
    got = [(logits, pcell.gather(p, c)[1])]
    for tok, pos in zip(toks, poss):
        logits, c = dcell.step_fn(p, c, tok, pos)
        got.append((logits, dcell.gather(p, c)[1]))
    return got


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(stacked results, reference steps, each process's results): one
    spawn of two processes, the stacked cells and the reference's steps
    run here meanwhile."""
    tmp = tmp_path_factory.mktemp("process_train")
    spec = {"train": [_train_inputs(n) for n in TRAIN],
            "serve": [_serve_inputs()]}
    torch.save(spec, tmp / "inputs.pt")
    results = tproc.start(tproc.train_cells, 2, tmp,
                          inputs=str(tmp / "inputs.pt"))
    want = {c[0]: _stacked_train(c) for c in spec["train"]}
    want["serve"] = _stacked_serve(spec["serve"][0])
    ref = _reference_steps("gemma3-1b", "adamw", 1, True)
    return want, ref, results()


@pytest.mark.parametrize("name", list(TRAIN))
def test_train_steps_equal_the_stacked_mesh(run, name):
    """Two steps on the process mesh, each process feeding its own rows:
    metrics, parameters, optimizer state and counters equal the stacked
    cell's on the global batch, on both processes."""
    want, _, results = run
    want = want[name]
    assert want["counters"]["launches"]["psum"] > 0
    for rank, res in enumerate(results):
        _same(want, res[name], f"{name} rank {rank}")


def test_train_step_holds_against_the_reference(run):
    """The (4, 1) case over two processes against the reference's two
    steps on one device, its ``_dp_degree`` bound to 1 (a dense model)."""
    from repro_torch import convert

    _, want, results = run
    got = results[0]["gemma3-1b-dp"]
    params = got["state"][0]
    for i, (m, (wp, ws, wm)) in enumerate(zip(got["metrics"], want)):
        for k in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(wm[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=f"step {i} {k}")
    _tree_close(params, want[-1][0], 1e-4, "params")
    _tree_close(convert.tree_to_numpy(got["state"][1]), want[-1][1], 1e-4,
                "state")


def test_prefill_cell_equals_the_stacked_cell(run):
    """gemma3-1b's prefill on (2, 1) over two processes: each process's
    logits are its rows of the stacked cell's, and the gathered caches
    equal the stacked cell's, bit for bit."""
    want, _, results = run
    want = want["serve"][0]
    got = [res["serve"][0] for res in results]
    _same(want[0], torch.cat([g[0] for g in got]), "prefill logits")
    for rank, g in enumerate(got):
        _same(want[1], g[1], f"prefill caches rank {rank}")


def test_decode_cell_equals_the_stacked_cell(run):
    """Two decode steps from the prefill's caches, the same way."""
    want, _, results = run
    for i, w in enumerate(want["serve"][1:]):
        got = [res["serve"][1 + i] for res in results]
        _same(w[0], torch.cat([g[0] for g in got]), f"decode {i} logits")
        for rank, g in enumerate(got):
            _same(w[1], g[1], f"decode {i} caches rank {rank}")
