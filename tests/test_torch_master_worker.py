"""The paper's master/worker lowering (Fig. 1b) in the port, held against
the JAX package.

* Every seeded block family of ``tests/test_torch_differential.py`` and
  every rank-1 region family of ``tests/test_torch_region.py`` runs under
  ``lowering="master_worker"`` on 2, 3 and 8 ranks, with the master
  excluded and included, as a block and as a region (staged per loop),
  against the reference's ``run_reference`` at rtol=atol=1e-4.
* The stacked mesh's ``ppermute`` launches and bytes equal those of the
  reference's executor (``repro.core.transform._execute_master_worker``,
  traced on 8 virtual devices in a subprocess), and so do the rendered
  report and ``cost_summary()``: ``tests/test_torch_mw_messages.py``,
  with this file's cases and reference program.
* A send planted to the wrong rank fails: each rank computes from the
  copy it received.
"""
import numpy as np
import pytest
import torch

from tests import test_torch_differential as td
from tests import test_torch_region as tr

REGION_FAMILIES = ("chain", "pingpong", "glue", "zerotrip")
SETTINGS = (True, False)          # paper_master_excluded


def _compile_each_way(omp, prog, mesh):
    for excluded in SETTINGS:
        for as_region in (False, True):
            p = omp.region(prog) if as_region else prog
            yield (f"excluded={excluded} region={as_region}",
                   omp.compile(p, mesh, lowering="master_worker",
                               paper_master_excluded=excluded))


MASTER_WORKER_P = [2, 3, 8]
MASTER_WORKER_FAMILIES = td.BLOCK_FAMILIES + REGION_FAMILIES


def every_family_matches_jax_reference_under_master_worker(family, p):
    from repro_torch import omp

    seed = 7000 + 10 * p + (td.BLOCK_FAMILIES + REGION_FAMILIES).index(family)
    mesh = omp.make_mesh((p,), ("data",), device="cpu")
    if family in td.BLOCK_FAMILIES:
        prog, env, jprog, jenv, _ = td.make_case(seed, family)
        ref = td._jax_reference(jprog, jenv)
        variants = _compile_each_way(omp, prog, mesh)
    else:
        prog, env, jprog, jenv, _ = tr.make_case(seed, family)
        ref = tr._jax_region_reference(jprog, jenv)
        variants = ((f"excluded={ex}", omp.compile(
            prog, mesh, lowering="master_worker", paper_master_excluded=ex))
            for ex in SETTINGS)
    for label, compiled in variants:
        td._assert_matches(compiled(env), ref,
                           f"{prog.name} P={p} {label}")


# ---------------------------------------------------------------------------
# Messages, report and cost summary against the reference's executor
# ---------------------------------------------------------------------------

COUNT_CASES = [(fam, p, ex) for fam in td.BLOCK_FAMILIES for p in (3, 8)
               for ex in SETTINGS]
COUNT_SEED = 101

_REFERENCE_COUNTS = """
import json
import jax
import numpy as np
from repro import omp
from repro.compat import make_mesh
from tests import test_differential as jd

sent = []
ppermute = jax.lax.ppermute


def counted(x, axis_name, perm):
    sent.append(len(perm) * int(np.prod(x.shape)) * x.dtype.itemsize)
    return ppermute(x, axis_name, perm)


jax.lax.ppermute = counted
out = {}
for fam, p, ex in CASES:
    prog, env, _ = jd.make_case(SEED, fam)
    c = omp.compile(prog, make_mesh((p,), ("data",)),
                    lowering="master_worker", paper_master_excluded=ex)
    sent.clear()
    jax.eval_shape(lambda e: c(e), env)    # traces the executor once
    out[f"{fam}/{p}/{ex}"] = dict(launches=len(sent), bytes=sum(sent),
                                  report=c.report(),
                                  cost=c.cost_summary())
print("JSON" + json.dumps(out))
"""


def test_master_worker_costs_more_than_collective_as_in_reference():
    """``tests/test_report.py::test_report_master_worker_costs_more``."""
    from repro_torch import omp
    from repro_torch.core.plan import make_plan
    from repro_torch.core.report import _comm_summary

    @omp.parallel_for(stop=64)
    def block(i, env):
        return {"y": omp.at(i, env["x"][i] + 1.0)}

    env = {"x": torch.zeros(64), "y": torch.zeros(64)}

    def total(plan):
        return int(_comm_summary(plan)[-1].split("~")[1].split()[0])

    assert (total(make_plan(block, env, 8, lowering="master_worker"))
            > total(make_plan(block, env, 8, lowering="collective")))


# ---------------------------------------------------------------------------
# Rejections and a planted fault
# ---------------------------------------------------------------------------


def test_master_worker_rejections_match_reference_word_for_word():
    from repro import omp as jomp
    from repro.compat import make_mesh as jmake_mesh
    from repro_torch import omp

    prog, _, jprog, _, _ = td.make_case(3, "map")
    jmesh = jmake_mesh((1,), ("data",))
    mesh2 = omp.make_mesh((2,), ("data",), device="cpu")
    # the reference's Lowering.PALLAS is the port's Lowering.KERNEL
    for low, opts in (("kernel", dict(paper_master_excluded=True)),
                      ("master_worker", dict(chunk_weights=(1.0,))),
                      ("fused", dict(paper_master_excluded="yes"))):
        with pytest.raises(jomp.CompileError) as ref:
            jomp.compile(jprog, jmesh, **opts,
                         lowering=low.replace("kernel", "pallas"))
        with pytest.raises(omp.CompileError) as mine:
            omp.compile(prog, mesh2, **opts, lowering=low)
        assert str(mine.value) == str(ref.value).replace(
            "PALLAS", "KERNEL").replace("pallas variant", "kernel variant")
    with pytest.raises(jomp.CompileError) as ref:
        jomp.compile(jprog, jmesh, lowering="master_worker")
    with pytest.raises(omp.CompileError) as mine:
        omp.compile(prog, omp.make_mesh((1,), ("data",), device="cpu"),
                    lowering="master_worker")
    assert str(mine.value) == str(ref.value)


def test_a_send_to_the_wrong_rank_fails():
    """Rank 2 taking its copy of an input from rank 1's slot of the
    message (which carries nothing) must change the result: the compute
    phase reads every rank's received copy, not one shared tensor."""
    from repro_torch import omp
    from repro_torch.core import transform as tf

    n = 24

    @omp.parallel_for(stop=n, schedule=omp.static(1), name="mw_fault")
    def prog(i, env):
        return {"y": omp.at(i, env["x"][i] * 2.0 + 1.0)}

    rng = np.random.default_rng(0)
    env = {"x": torch.as_tensor(rng.normal(size=n).astype(np.float32)),
           "y": torch.zeros(n)}
    ref = prog(env)["y"]
    mesh = omp.make_mesh((4,), ("data",), device="cpu")
    healthy = omp.compile(prog, mesh, lowering="master_worker")(env)["y"]
    torch.testing.assert_close(healthy, ref, rtol=1e-6, atol=1e-6)

    good = tf._mw_send

    def misrouted(mesh, x, src, dst, d, current, axis):
        msg = mesh.ppermute(x, axis, [(src, dst)])
        if dst == 2:
            slots = list(range(msg.shape[0]))
            slots[2] = 1
            msg = msg.index_select(0, torch.tensor(slots))
        sel = (d == dst).reshape((-1,) + (1,) * (x.dim() - 1))
        return torch.where(sel, msg, current)

    tf._mw_send = misrouted
    try:
        bad = omp.compile(prog, mesh, lowering="master_worker",
                          paper_master_excluded=True)(env)["y"]
    finally:
        tf._mw_send = good
    # worker 1 (mesh rank 2) owns every third row; it computed from zeros
    wrong = ~torch.isclose(bad, ref, rtol=1e-4, atol=1e-4)
    assert wrong.any()
    assert torch.equal(wrong.nonzero().flatten() % 3,
                       torch.full((int(wrong.sum()),), 1))
    torch.testing.assert_close(bad[wrong], torch.ones(int(wrong.sum())))
