"""The PyTorch port's planning artifacts, mesh, geometry and diagnostics,
held against the JAX package (small sizes, CPU).

* **Plan artifacts are equal**: ``ChunkPlan`` owners/slot_map,
  ``ContextInfo``, ``DistPlan`` strategies, and ``KernelPlan`` span
  partitions with the chunk dims of the grid, on 1/2/4/8 ranks and the
  1x1/2x1/2x2/4x2 meshes (the JAX planner takes counts, not a mesh).
* **Rejections match**: ``CompileError`` / ``LoopNotCanonical`` on the
  same programs and options.
* **The port stands alone**: no file of ``src/repro_torch`` nor
  ``chip_smoke.py`` imports ``jax`` or ``repro``; the default device is
  the card and ``make_mesh`` raises without one.

The heaviest plan cases (``DistPlan``/``ContextInfo`` on 1/2/4/8 ranks,
the nest staging geometry, ``merge_chunk_values``) are in
``tests/test_torch_core_plans.py``, and the ``KernelPlan`` spans in
``tests/test_torch_kernel_plans.py``; both use this file's helpers.
"""
import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from tests import test_torch_differential as td
from tests._hypothesis_compat import given, settings, strategies as st

REPO = Path(__file__).resolve().parents[1]
MESHES2 = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}


def _norm(x):
    """A structural view of a (nested) plan artifact, with the two
    frameworks' dtypes and enums printed alike."""
    if isinstance(x, (torch.dtype, np.dtype)) or type(x).__name__ in (
            "dtype", "DType"):
        return str(x).replace("torch.", "")
    if hasattr(x, "__dataclass_fields__"):
        return (type(x).__name__,
                {k: _norm(getattr(x, k)) for k in x.__dataclass_fields__
                 if k not in ("trace", "source")})
    if isinstance(x, dict):
        return {k: _norm(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(_norm(v) for v in x)
    if hasattr(x, "value") and type(x).__module__.endswith(".context"):
        return x.value
    return x


def _plans(case, p, shard, lowering="collective"):
    from repro.core import plan as jplan
    from repro_torch.core import plan as tplan

    prog, env, jprog, jenv, _ = case
    num = p if prog.rank == 1 else MESHES2[p]
    axis = "data" if prog.rank == 1 else ("i", "j")
    kw = dict(axis=axis, shard_inputs=shard, lowering=lowering)
    return (tplan.make_plan(prog, env, num, **kw),
            jplan.make_plan(jprog, jenv, num, **kw))


# ---------------------------------------------------------------------------
# Plan artifacts
# ---------------------------------------------------------------------------


@settings(max_examples=30, deadline=None)
@given(t=st.integers(0, 40), p=st.integers(1, 8),
       kind=st.sampled_from(["static", "dynamic", "guided"]),
       chunk=st.sampled_from([None, 1, 2, 3, 7]),
       weighted=st.sampled_from([False, True]))
def test_chunk_plans_equal_reference(t, p, kind, chunk, weighted):
    from repro.core import loop as jloop, pragma as jpragma
    from repro.core import schedule as jsched
    from repro_torch.core import loop, pragma, schedule

    weights = [1.0 + (d % 3) for d in range(p)] if weighted and t else None
    mine = schedule.make_chunk_plan(loop.analyze_loop(0, t, 1),
                                    pragma.Schedule(kind, chunk), p,
                                    weights=weights)
    ref = jsched.make_chunk_plan(jloop.analyze_loop(0, t, 1),
                                 jpragma.Schedule(kind, chunk), p,
                                 weights=weights)
    assert mine == schedule.ChunkPlan(**ref.__dict__)


@settings(max_examples=40, deadline=None)
@given(chunk=st.integers(1, 5000))
def test_axis_tiles_follow_the_hopper_rule(chunk):
    """Power-of-two tiles of 32..1024 lanes on the last axis (a leading
    axis fills the rest of a 1024-lane budget), covering each chunk
    exactly."""
    from repro_torch.core.nest import derive_axis_tiles, derive_nest_tiles

    tl = derive_axis_tiles(chunk)
    assert tl.tile & (tl.tile - 1) == 0 and 32 <= tl.tile <= 1024
    cover = tl.cover()
    assert cover[0][0] == 0 and sum(n for _, n in cover) == chunk
    assert all(a + n == b for (a, n), (b, _) in zip(cover, cover[1:]))
    ti, tj = derive_nest_tiles((chunk, 7 + chunk % 300))
    assert ti.tile * tj.tile <= 1024 and ti.tile & (ti.tile - 1) == 0
    assert sum(n for _, n in ti.cover()) == chunk


# ---------------------------------------------------------------------------
# Context analysis on access forms beyond the families
# ---------------------------------------------------------------------------


def context_access_forms_match_reference():
    """Constant and negative positions, whole-axis slices, 0-d scalars,
    unused buffers: the same ReadKinds and maps as the jaxpr walk."""
    import jax.numpy as jnp

    from repro.core import context as jctx
    from repro.core.nest import LoopNest as JNest
    from repro_torch.core import context as tctx
    from repro_torch.core.nest import LoopNest as TNest
    from repro_torch.core.pragma import ParallelFor, at, red

    def body_t(i, env):
        return {"y": at(i, env["X"][i, 2] + env["x"][2] + env["x"][-1]
                        + env["s"] + env["X"][i][3] + env["x"][i + 1]),
                "r": red(env["z"][2 * i])}

    from repro.core.pragma import at as jat, red as jred

    def body_j(i, env):
        return {"y": jat(i, env["X"][i, 2] + env["x"][2] + env["x"][-1]
                         + env["s"] + env["X"][i][3] + env["x"][i + 1]),
                "r": jred(env["z"][2 * i])}

    def body2_t(i, j, env):
        return {"C": at((i, j), env["A"][i, j] + env["B"][:, j].sum()
                        + env["A"][j, i] + env["D"][i].sum())}

    def body2_j(i, j, env):
        return {"C": jat((i, j), env["A"][i, j] + env["B"][:, j].sum()
                         + env["A"][j, i] + env["D"][i].sum())}

    shapes = {"X": (9, 4), "x": (9,), "s": (), "z": (20,), "y": (9,),
              "u": (3,)}
    shapes2 = {"A": (6, 6), "B": (3, 6), "D": (6, 5), "C": (6, 6)}
    for (bt, bj, shp, kw) in ((body_t, body_j, shapes,
                               dict(stop=8, reduction={"r": "+"})),
                              (body2_t, body2_j, shapes2,
                               dict(stop=(5, 5), collapse=2))):
        pt, pj = ParallelFor(bt, **kw), ParallelFor(bj, **kw)
        from repro.core.pragma import ParallelFor as JPF
        pj = JPF(bj, **kw)
        tenv = {k: torch.zeros(s) for k, s in shp.items()}
        jenv = {k: jnp.zeros(s, jnp.float32) for k, s in shp.items()}
        mine = tctx.analyze_context(pt, tenv, TNest.from_program(pt))
        ref = jctx.analyze_context(pj, jenv, JNest.from_program(pj))
        assert _norm(mine) == _norm(ref)


# ---------------------------------------------------------------------------
# Rejections
# ---------------------------------------------------------------------------


def _bodies():
    """Programs both packages refuse, as (name, kwargs, body) with the
    body written once against a namespace ``m`` (omp of either side)."""
    return [
        ("nonaffine", dict(stop=4), lambda m, x: lambda i, env: {
            "y": m.at(i * i, env["x"][i])}),
        ("concurrent", dict(stop=4), lambda m, x: lambda i, env: {
            "y": m.at(0 * i + 1, env["x"][i])}),
        ("oob", dict(stop=8), lambda m, x: lambda i, env: {
            "y": m.at(i + 5, env["x"][i])}),
        ("noclause", dict(stop=4), lambda m, x: lambda i, env: {
            "y": m.red(env["x"][i])}),
        ("redwrite", dict(stop=4, reduction={"y": "+"}),
         lambda m, x: lambda i, env: {"y": m.at(i, env["x"][i])}),
        ("shape", dict(stop=4), lambda m, x: lambda i, env: {
            "y": m.at(i, x.stack([env["x"][i], env["x"][i]]))}),
        ("put2", dict(stop=(2, 2), collapse=2),
         lambda m, x: lambda i, j, env: {"y": m.put(env["x"])}),
        ("swapped2", dict(stop=(2, 3), collapse=2),
         lambda m, x: lambda i, j, env: {"Y": m.at((j, i), env["x"][i])}),
        ("notdict", dict(stop=4), lambda m, x: lambda i, env: 1.0),
    ]


@pytest.mark.parametrize("name", [b[0] for b in _bodies()])
def test_rejections_match_reference(name):
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import omp

    (_, kw, make), = [b for b in _bodies() if b[0] == name]
    jenv = {"x": np.arange(8, dtype=np.float32),
            "y": np.zeros(8, np.float32), "Y": np.zeros((8, 8), np.float32)}
    jmesh_axes = ("i", "j") if kw.get("collapse") == 2 else ("data",)
    errs = []
    for m, x, env in ((jomp, jnp, {k: jnp.asarray(v) for k, v in jenv.items()}),
                      (omp, torch, td._env_of(jenv))):
        prog = m.parallel_for(**kw)(make(m, x))
        if m is omp:
            mesh = omp.make_mesh((1,) * len(jmesh_axes), jmesh_axes,
                                 device="cpu")
        else:
            from repro.compat import make_mesh
            mesh = make_mesh((1,) * len(jmesh_axes), jmesh_axes)
        with pytest.raises(m.LoopNotCanonical) as info:
            m.compile(prog, mesh, env_like=env)
        errs.append(info.value)
    jerr, terr = errs
    assert type(jerr).__name__ == type(terr).__name__
    assert str(terr) == str(jerr)


@pytest.mark.parametrize("opts, match", [
    (dict(lowering="bogus"), "fused"),
    (dict(comm="x"), "gather"),
    (dict(shard="x"), "slice"),
    (dict(schedule=3), "Schedule"),
    (dict(axis=("i", "i")), "axis"),
    (dict(keep_sharded=True), "keep_sharded"),
    (dict(comm_schedule="later"), "comm_schedule"),
    (dict(chunk_weights=(1.0, -2.0)), "finite"),
])
def test_option_rejections_match_reference(opts, match):
    from repro import omp as jomp
    from repro_torch import omp

    with pytest.raises(jomp.CompileError, match=match) as ref:
        jomp.Options(**opts)
    with pytest.raises(omp.CompileError, match=match) as mine:
        omp.Options(**opts)
    # the port names the reference's "pallas" lowering "kernel"
    assert str(mine.value) == str(ref.value).replace("'pallas'", "'kernel'")


def test_kernel_lowering_rejects_what_pallas_rejects():
    """The reference's Lowering.PALLAS refusals, under the port's name
    for it (Lowering.KERNEL)."""
    from repro import omp as jomp
    from repro_torch import omp

    for opts, match in ((dict(unroll_chunks=True), "unroll_chunks"),
                        (dict(paper_master_excluded=True),
                         "paper_master_excluded"),
                        (dict(chunk_weights=(1.0, 2.0)), "chunk_weights")):
        with pytest.raises(jomp.CompileError, match=match):
            jomp.Options(lowering="pallas", **opts)
        with pytest.raises(omp.CompileError, match=match) as mine:
            omp.Options(lowering="kernel", **opts)
        assert "'kernel'" in str(mine.value) or "KERNEL" in str(mine.value)


def test_compile_rejections_match_reference():
    from repro import omp as jomp
    from repro.compat import make_mesh
    from repro_torch import omp

    prog2 = omp.parallel_for(stop=(2, 2), collapse=2)(
        lambda i, j, env: {"s": omp.red(env["x"][i])})
    jprog2 = jomp.parallel_for(stop=(2, 2), collapse=2)(
        lambda i, j, env: {"s": jomp.red(env["x"][i])})
    prog1 = omp.parallel_for(stop=2)(lambda i, env: {})
    jprog1 = jomp.parallel_for(stop=2)(lambda i, env: {})
    mesh2, jmesh2 = (omp.make_mesh((1, 1), ("i", "j"), device="cpu"),
                     make_mesh((1, 1), ("i", "j")))
    mesh1, jmesh1 = (omp.make_mesh((1,), ("data",), device="cpu"),
                     make_mesh((1,), ("data",)))
    for (p, m, mesh), (jp, jm) in (
            ((prog2, omp, mesh2), (jprog2, jmesh2)),
            ((prog1, omp, mesh1), (jprog1, jmesh1))):
        for opts, match in ((dict(lowering="master_worker"), "rank-1 only"
                             if p.rank == 2 else ">= 2 mesh ranks"),
                            (dict(lowering="master_worker", shard="slice"),
                             "rank-1 only" if p.rank == 2 else "SLICE")):
            with pytest.raises(jomp.CompileError, match=match) as ref:
                jomp.compile(jp, jm, **opts)
            with pytest.raises(omp.CompileError, match=match) as mine:
                omp.compile(p, mesh, **opts)
            assert str(mine.value) == str(ref.value)
    with pytest.raises(omp.CompileError, match="not both"):
        omp.compile(prog1, mesh1, omp.Options(), lowering="collective")
    with pytest.raises(omp.CompileError, match="ParallelFor"):
        omp.compile(lambda i, env: {}, mesh1)
    # a region compiles (tests/test_torch_region.py), and so does a region
    # under master/worker, staged per loop, equal to the reference
    assert omp.compile(omp.region(prog1), mesh1).program.stages == (prog1,)
    prog, env, jprog, jenv, _ = td.make_case(11, "map")
    mw = omp.compile(omp.region(prog),
                     omp.make_mesh((2,), ("data",), device="cpu"),
                     lowering="master_worker")
    td._assert_matches(mw(env), td._jax_reference(jprog, jenv),
                       "region under master/worker")
    with pytest.raises(omp.LoopNotCanonical, match="non-zero"):
        omp.analyze_loop(0, 4, 0)


# ---------------------------------------------------------------------------
# The mesh, the merges, the report
# ---------------------------------------------------------------------------


def test_mesh_collectives_and_counters():
    from repro_torch import omp

    mesh = omp.make_mesh((4, 2), ("i", "j"), device="cpu")
    x = torch.arange(24, dtype=torch.float32).reshape(4, 2, 3)
    assert torch.equal(mesh.psum(x, ("i", "j")), x.sum((0, 1)))
    assert torch.equal(mesh.pmax(x, ("i", "j")), x.amax((0, 1)))
    assert torch.equal(mesh.pmin(x, "i"), x.amin(0))
    assert torch.equal(mesh.all_gather(x, "i"), x)
    assert torch.equal(mesh.axis_index("i"),
                       torch.arange(4, dtype=torch.int32))
    assert mesh.launches == {"psum": 1, "pmax": 1, "pmin": 1,
                             "all_gather": 1}
    assert mesh.bytes["psum"] == 24 * 4
    with pytest.raises(ValueError, match="leading dims"):
        mesh.psum(x, "j")
    mesh.reset_counters()
    assert not mesh.launches


def test_fused_collectives_equal_per_operand_and_count_one_launch():
    from repro_torch import omp
    from repro_torch.core import comm_schedule as cs

    mesh = omp.make_mesh((4,), ("data",), device="cpu")
    g = torch.Generator().manual_seed(0)
    entries = {("a", "red"): ("psum", torch.randn(4, generator=g)),
               ("b", "buf"): ("psum", torch.randn(4, 3, 2, generator=g)),
               ("c", "red"): ("pmax", torch.randn(4, 5, generator=g))}
    fused = cs.fused_collectives(mesh, entries, "data")
    assert mesh.launches == {"psum": 1, "pmax": 1}
    for path, (coll, val) in entries.items():
        want = getattr(mesh, coll)(val, "data")
        assert torch.equal(fused[path], want), path


def report_renders_the_reference_plan_view():
    """The Tables 2/3 view of a plan is the reference's, line for line."""
    from repro.core import report as jreport
    from repro_torch import omp
    from repro_torch.core import report

    for case in (td.make_case(7, "stencil"), td.make_case(8, "strided"),
                 td.make_case2(9, "matmul2")):
        mine, ref = _plans(case, 2, True)
        assert report.render_plan(mine) == jreport.render_plan(ref)
    prog, env = td.make_case(7, "stencil")[:2]
    mesh = omp.make_mesh((2,), ("data",), device="cpu")
    text = omp.compile(prog, mesh, lowering="kernel", env_like=env).report()
    assert "kernel: compute span" in text and "span kernels: 1 span" in text
    passes = [pr.name for pr in omp.compile(prog, mesh, env_like=env).passes]
    assert passes == ["analyze", "schedule", "plan", "plan_comm",
                      "schedule_comm", "lower"]


def test_compile_cache_hits_on_same_shapes():
    from repro_torch import omp

    omp.clear_compile_cache()
    prog, env = td.make_case(3, "map")[:2]
    mesh = omp.make_mesh((2,), ("data",), device="cpu")
    a = omp.compile(prog, mesh, env_like=env)
    b = omp.compile(prog, mesh, env_like={k: v + 1 for k, v in env.items()})
    assert (a.cache_hit, b.cache_hit) == (False, True)
    stats = omp.compile_cache_stats()
    assert {k: stats[k] for k in ("hits", "misses", "size")} == {
        "hits": 1, "misses": 1, "size": 1}
    # the reference's keys, the persistent store's counters at zero (off)
    from repro.core import api as japi

    assert set(stats) == set(japi.compile_cache_stats())
    assert stats["persistent_dir"] is None and not any(
        v for k, v in stats.items() if k.startswith(("disk_", "evict")))


# ---------------------------------------------------------------------------
# The port stands alone, and runs on the card by default
# ---------------------------------------------------------------------------


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def port_imports_neither_jax_nor_the_reference():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) >= 17
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro", "flax", "optax",
                               "benchmarks"), (
                f"{path.relative_to(REPO)} imports {name}")


def test_default_device_is_the_card(monkeypatch):
    from repro_torch import omp

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        omp.make_mesh((2,), ("data",))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        omp.make_mesh((2,), ("data",), device="cuda")
    assert omp.make_mesh((2,), ("data",), device="cpu").device.type == "cpu"


def test_run_refuses_an_env_on_another_device():
    from repro_torch import omp

    prog, env = td.make_case(3, "map")[:2]
    mesh = omp.make_mesh((2,), ("data",), device="meta")
    with pytest.raises(ValueError, match="lies on cpu"):
        omp.compile(prog, mesh)(env)
