"""``omp.compile`` over the port's process mesh
(``repro_torch.mesh.ProcessMesh``: the first axis's ranks split over the
processes of a gloo group) on the CPU, held against the stacked mesh
(``repro_torch.mesh.Mesh``) and, for one batch, against the JAX
reference's ``run_reference``.

One spawn a world size, 2 and 4 processes (``tests/_torch_process.py``,
one torch thread a child; the programs reach the children pickled by
value, so a child imports no JAX): the torch-bodied twins of
``tests/test_differential.py``'s seeded block families (rank 1 and 2)
and of ``tests/test_torch_region.py``'s region families, on a 4- and an
8-rank first axis (rank 2: a (4, 2) mesh), under every lowering the
stacked mesh runs them with — ``fused`` (both comm schedules, and the
gather rule, for a region), ``collective`` (replicated, sliced and straggler-weighted
inputs), ``kernel`` (K1's plain version on the CPU) and
``master_worker`` (the master in and out).  Every process returns the
whole result; it must equal the stacked mesh's bit for bit, with equal
plan artifacts (the rendered report, the cost summary, the chunk plans,
the kernel spans), counters and log, and equal refusals.
Tolerance: none, except the JAX reference's rtol = atol = 1e-4.
"""
import cloudpickle
import numpy as np
import pytest
import torch

from tests import _torch_process as tproc
from tests import test_torch_differential as td
from tests import test_torch_region as tr

ONE = ((4,), ("data",))
WIDE = ((8,), ("data",))
TWO = ((4, 2), ("i", "j"))

BLOCK = [{}, {"lowering": "collective"}, {"lowering": "kernel"},
         {"lowering": "master_worker"},
         {"lowering": "master_worker", "paper_master_excluded": True}]
BLOCK2 = [{}, {"lowering": "collective"}, {"lowering": "kernel"},
          {"lowering": "master_worker"}]
REGION = [{}, {"comm_schedule": "inline"}, {"lowering": "kernel"},
          {"lowering": "collective"}, {"lowering": "master_worker"},
          {"comm": "gather"}]
REGION2 = [{}, {"comm_schedule": "inline"}, {"lowering": "kernel"},
           {"lowering": "collective"}]
#: on one family: sliced inputs, and a straggler-weighted chunk plan
EXTRA = {"stencil": [{"lowering": "collective", "shard": "slice"},
                     {"lowering": "collective",
                      "chunk_weights": (1.0, 3.0, 1.0, 2.0)}]}


def _cases():
    """``(name, program, env, mesh shape, axes, options)`` per case, and
    the JAX reference batch: ``{name: (jax program, jax env)}``."""
    cases, jax_cases = [], {}
    for j, fam in enumerate(td.BLOCK_FAMILIES):
        prog, env, jprog, jenv, _ = td.make_case(1500 + j, fam)
        cases.append((f"block/{fam}", prog, env, *ONE,
                      BLOCK + EXTRA.get(fam, [])))
        cases.append((f"block8/{fam}", prog, env, *WIDE, BLOCK[:3]))
        jax_cases[f"block/{fam}"] = (jprog, jenv)
    for j, fam in enumerate(td.BLOCK_FAMILIES2):
        prog, env = td.make_case2(1520 + j, fam)[:2]
        cases.append((f"block2/{fam}", prog, env, *TWO, BLOCK2))
    # the nest's j axis first in the mesh: the processes would split it
    cases.append(("split_j/matmul2", prog, env, (4, 2), ("j", "i"), [{}]))
    for j, fam in enumerate(tr.FAMILIES):
        prog, env = tr.make_case(1540 + j, fam)[:2]
        cases.append((f"region/{fam}", prog, env, *ONE, REGION))
        cases.append((f"region8/{fam}", prog, env, *WIDE, REGION[:3]))
    for j, fam in enumerate(tr.FAMILIES2):
        prog, env = tr.make_case2(1560 + j, fam)[:2]
        cases.append((f"region2/{fam}", prog, env, *TWO, REGION2))
    return cases, jax_cases


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at world 2 and 4 (the two groups run side by side), and
    the JAX reference of the batch, computed here meanwhile."""
    tmp = tmp_path_factory.mktemp("process_compile")
    cases, jax_cases = _cases()
    inputs = tmp / "cases.pkl"
    inputs.write_bytes(cloudpickle.dumps(cases))
    waits = {w: tproc.start(tproc.compile_cases, w, tmp, inputs=str(inputs),
                            store=str(tmp / "store") if w == 2 else None)
             for w in (2, 4)}
    refs = {name: td._jax_reference(*c) for name, c in jax_cases.items()}
    return {"cases": cases, "refs": refs,
            **{w: wait() for w, wait in waits.items()}}


def _same(want, got, label):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), (label, sorted(want), sorted(got))
        for k in want:
            _same(want[k], got[k], f"{label}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), label
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{label}[{i}]")
    elif torch.is_tensor(want):
        assert want.dtype == got.dtype and want.shape == got.shape, (
            label, want.dtype, got.dtype, want.shape, got.shape)
        assert torch.equal(want, got) or (
            want.is_floating_point() and torch.equal(
                want.isnan(), got.isnan()) and torch.equal(
                want.nan_to_num(), got.nan_to_num())), label
    else:
        assert want == got, (label, want, got)


def _cases_of(res):
    return [(k, r) for k, r in res.items() if k != "store"]


def _check(runs, world, prefix, keys=("out", "report", "cost", "schedule",
                                      "spans", "counters", "refused")):
    """Every case under ``prefix`` on every process of ``world``: the
    process mesh's outcome equals the stacked mesh's; returns how many
    ran and how many were refused, on each process."""
    ran = refused = 0
    for rank, res in enumerate(runs[world]):
        for (name, i), r in _cases_of(res):
            if not name.startswith(prefix):
                continue
            want, got = r["want"], r["got"]
            label = f"world {world} process {rank} {name} options {i}"
            assert want.keys() == got.keys(), (label, want, got)
            for k in keys:
                if k in want:
                    _same(want[k], got[k], f"{label} {k}")
            if "refused" in want:
                refused += 1
            else:
                ran += 1
    return ran // world, refused // world


@pytest.mark.parametrize("world", [2, 4])
def test_blocks_equal_the_stacked_mesh(runs, world):
    """Rank-1 blocks of every seeded family, on 4 and 8 ranks, under
    ``fused``, ``collective`` (replicated, sliced, weighted), ``kernel``
    and ``master_worker`` (master in and out): on every process the whole
    result, the plan artifacts, the counters and log equal the stacked
    mesh's.  Rank-2 blocks on a (4, 2) mesh, its ``i`` ranks split:
    ``fused``, ``collective`` and ``kernel`` equal too, and
    master/worker is refused on both with the same message; a mesh whose
    first axis is the nest's ``j`` axis is refused over processes."""
    ran, refused = _check(runs, world, "block/")
    ran8, _ = _check(runs, world, "block8/")
    assert ran == 32 and ran8 == 18 and refused == 0
    ran, refused = _check(runs, world, "block2/")
    assert ran == 6 and refused == 2
    for res in runs[world]:
        for (name, i), r in _cases_of(res):
            if name.startswith("block2/") and "refused" in r["want"]:
                assert "MASTER_WORKER" in r["got"]["refused"]
            if name.startswith("split_j/"):
                # a process mesh that would split the nest's j axis
                # refuses it, where the stacked mesh runs it
                assert "out" in r["want"], r["want"]
                assert r["got"]["refused"].startswith("NotImplementedError")
                assert "splits the nest's i axis only" in r["got"][
                    "refused"]


@pytest.mark.parametrize("world", [2, 4])
def test_regions_equal_the_stacked_mesh(runs, world):
    """Rank-1 and rank-2 regions (chain, ping-pong halos, serial glue, a
    zero-trip stage; a 2-D heat stencil and a transpose) under ``fused``
    (aggregate and inline comm schedules, and every boundary a gather),
    ``kernel``, and the staged
    ``collective`` and ``master_worker``: equal to the stacked mesh's."""
    ran, _ = _check(runs, world, "region/")
    ran8, _ = _check(runs, world, "region8/")
    ran2, _ = _check(runs, world, "region2/")
    assert ran >= 20 and ran8 >= 10 and ran2 >= 6


def test_each_process_stages_and_computes_its_own_ranks(runs):
    """Under every lowering but master/worker (whose ranks compute the
    chunks of their compute rank), every slab a process stages and every
    dense value it computes — plain or through K1's wrapper — has a rank
    dim of its block of the first axis, never the axis's whole size."""
    for world in (2, 4):
        for res in runs[world]:
            for (name, i), r in _cases_of(res):
                prog = next(c for c in runs["cases"] if c[0] == name)
                if prog[5][i].get("lowering") == "master_worker" \
                        or "out" not in r["got"]:
                    continue
                dims = r["dims"]
                assert set(dims) <= {r["block"]}, (world, name, i, dims)
                if not name.endswith("zerotrip"):
                    assert dims == [r["block"]], (world, name, i, dims)
    assert {r["block"] for _, r in _cases_of(runs[4][0])} == {1, 2}


def test_one_batch_equals_the_jax_reference(runs):
    """The rank-1 block batch, as each process of the world-2 group
    returned it under ``fused``, ``kernel`` and ``master_worker``, equals
    the JAX reference's ``run_reference`` within the differential wall's
    rtol = atol = 1e-4."""
    from repro_torch import convert

    checked = 0
    for rank, res in enumerate(runs[2]):
        for (name, i), r in _cases_of(res):
            if name not in runs["refs"] or i not in (0, 2, 3):
                continue
            ref = runs["refs"][name]
            got = convert.env_to_numpy(r["got"]["out"])
            assert set(got) == set(ref), (name, sorted(got), sorted(ref))
            for k in ref:
                np.testing.assert_allclose(
                    got[k], ref[k], **td.TOL,
                    err_msg=f"process {rank} {name} options {i} key={k!r}")
            checked += 1
    assert checked == 2 * 3 * len(td.BLOCK_FAMILIES)


def test_processes_share_one_store_and_serve(runs):
    """Two processes compile one program on the process mesh with the
    persistent store in one directory: the cold compile writes one entry
    (process 0 alone writes, after the barrier every process passes
    before it looks), and after the in-memory cache is dropped both
    processes restore it; the results agree.  A compile service on each
    process serves four concurrent requests of one cold key with one
    compile, each result the stacked mesh's."""
    got = [res["store"] for res in runs[2]]
    for g in got:
        assert g["restored"] == [False, True]
        assert g["entries"] == got[0]["entries"]
        assert len(g["entries"]) == 1 and g["entries"][0].endswith(".aot")
    assert got[0]["written"][0] > 0 and got[1]["written"] == [0, 0]
    assert got[0]["written"][1] == 0
    assert torch.equal(got[0]["out"], got[1]["out"])
    for g in got:
        assert g["cold_compiles"] == 1 and len(g["served"]) == 4
        for out in g["served"]:
            assert torch.equal(out, g["stacked"])


def test_service_runs_mixed_requests_in_one_order(runs):
    """A compile service on each process of two, given requests of three
    programs queued at once in one order (then one through ``run``): its
    one worker runs them in that order on both processes, so their
    collectives pair; each result equals the stacked mesh's, with one
    cold compile a program."""
    for rank, res in enumerate(runs[2]):
        g = res["store"]
        assert g["mixed_cold_compiles"] == 3
        assert [n for n, _ in g["mixed"]] == [
            "gemm", "bicg", "atax", "bicg", "gemm", "atax", "bicg", "atax"]
        for i, (name, out) in enumerate(g["mixed"]):
            assert torch.equal(out, g["mixed_want"][name]), (rank, i, name)

