"""Whole programs (``omp.region``) in the PyTorch port, held against the
JAX package on the CPU.

Every region family of ``tests/test_differential.py`` (``make_case`` /
``make_case2``: chain, pingpong, glue, zerotrip, heat2d, transpose2) has
a torch-bodied twin here, drawn from the same seed and run on the JAX
case's env taken through numpy; a few more regions (scatter + put,
whole-array and stencil reshards, a partial-cover chain, host-side glue,
the multi-field chain of ``tests/test_comm.py``) cover the executor's
other paths.

* **Plan artifacts are equal** to the reference's, on 1/2/4/8 ranks and
  the 1x1/2x1/2x2/4x2 meshes: each stage's feeds and gathers, the final
  layouts, every ``BoundaryComm`` (op, bytes, hops, shift, alternatives),
  the ``CommSchedule`` (events, groups, launch counts, ``launches_saved``,
  ``modeled_cost_bytes``) in both modes, and the ``KernelPlan`` spans
  (stage indices, forwarded keys, the grid's chunk dims, ``max_fused``).
* **Outputs** of ``fused`` (comm auto and gather, comm_schedule aggregate
  and inline), ``collective`` and ``kernel`` equal JAX ``prog(env)`` at
  rtol = atol = 1e-4; aggregate equals inline bit for bit;
  ``lowering="kernel"`` equals JAX ``lowering="pallas"`` on the 1-device
  mesh, as ``check_case_pallas`` runs it.
* **Rejections** match the reference's.

The plan equalities on 1/2/4/8 ranks, the kernel-vs-pallas check and the
scatter/put/reshard regions are in ``tests/test_torch_region_plans.py``,
which uses this file's twins and helpers.
"""
import random

import numpy as np
import pytest
import torch

from tests import test_differential as jd
from tests import test_torch_differential as td
from tests.test_torch_comm import same_reason

FAMILIES = ("chain", "pingpong", "glue", "zerotrip")
FAMILIES2 = ("heat2d", "transpose2")
MESHES2 = {1: (1, 1), 2: (2, 1), 4: (2, 2), 8: (4, 2)}
TOL = dict(rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# Torch twins of the region families
# ---------------------------------------------------------------------------


def make_case(seed: int, family: str):
    """Torch twin of ``jd.make_case`` for a region family: the same draws
    in the same order and the same env (through numpy).  Returns
    ``(region, env, jax_region, jax_env, family)``."""
    from repro_torch import omp

    rng = random.Random(seed)
    jprog, jenv, _ = jd.make_case(seed, family)
    sched = td._schedule(rng)
    env = td._env_of(jenv)

    if family == "chain":
        n = rng.randint(4, 24)

        @omp.parallel_for(stop=n, schedule=sched, name=f"c1_{seed}")
        def l1(i, env):
            return {"tmp": omp.at(i, env["x"][i] * 2.0)}

        @omp.parallel_for(stop=n, schedule=sched, name=f"c2_{seed}")
        def l2(i, env):
            return {"y": omp.at(i, env["tmp"][i] + 1.0)}

        @omp.parallel_for(stop=n, schedule=sched, reduction={"tot": "+"},
                          name=f"c3_{seed}")
        def l3(i, env):
            return {"tot": omp.red(env["y"][i])}

        prog = omp.region(l1, l2, l3, name=f"chain{seed}")

    elif family == "pingpong":
        n = rng.randint(10, 28)

        def sweep(src, dst, name):
            @omp.parallel_for(start=1, stop=n - 1, schedule=sched, name=name)
            def body(i, env):
                v = 0.25 * (env[src][i - 1] + 2.0 * env[src][i]
                            + env[src][i + 1])
                return {dst: omp.at(i, v)}
            return body

        prog = omp.region(sweep("a", "b", f"s1_{seed}"),
                          sweep("b", "a", f"s2_{seed}"),
                          sweep("a", "b", f"s3_{seed}"),
                          name=f"pingpong{seed}")

    elif family == "glue":
        n = rng.randint(4, 20)

        @omp.parallel_for(stop=n, schedule=sched, name=f"g1_{seed}")
        def g1(i, env):
            return {"tmp": omp.at(i, env["x"][i] * env["x"][i])}

        glue = omp.serial(lambda env: {"bias": env["bias"] * 0.5},
                          reads=("bias",), name=f"halve{seed}")

        @omp.parallel_for(stop=n, schedule=sched, name=f"g2_{seed}")
        def g2(i, env):
            return {"y": omp.at(i, env["tmp"][i] + env["bias"][0])}

        prog = omp.region(g1, glue, g2, name=f"glue{seed}")

    else:  # zerotrip
        n = rng.randint(3, 12)

        @omp.parallel_for(stop=0, schedule=sched, reduction={"s": "+"},
                          name=f"z0_{seed}")
        def z0(i, env):
            return {"y": omp.at(i, env["x"][i]), "s": omp.red(env["x"][i])}

        @omp.parallel_for(stop=n, schedule=sched, name=f"z1_{seed}")
        def z1(i, env):
            return {"y": omp.at(i, env["x"][i] + env["s"])}

        prog = omp.region(z0, z1, name=f"zerotrip{seed}")

    _same_stages(prog, jprog)
    return prog, env, jprog, jenv, family


def make_case2(seed: int, family: str):
    """Torch twin of ``jd.make_case2`` for a region family."""
    from repro_torch import omp

    rng = random.Random(seed)
    jprog, jenv, _ = jd.make_case2(seed, family)
    sched = td._schedule(rng)
    env = td._env_of(jenv)

    if family == "heat2d":
        n = rng.randint(6, 14)
        m = rng.randint(6, 14)

        def sweep(src, dst, name):
            @omp.parallel_for(start=(1, 1), stop=(n - 1, m - 1), collapse=2,
                              schedule=sched, name=name)
            def body(i, j, env):
                v = 0.25 * (env[src][i - 1, j] + env[src][i + 1, j]
                            + env[src][i, j - 1] + env[src][i, j + 1])
                return {dst: omp.at((i, j), v)}
            return body

        prog = omp.region(sweep("a", "b", f"h1_{seed}"),
                          sweep("b", "a", f"h2_{seed}"),
                          name=f"heat2d{seed}")

    else:  # transpose2
        n = rng.randint(4, 10)

        @omp.parallel_for(stop=(n, n), collapse=2, schedule=sched,
                          name=f"t1_{seed}")
        def t1(i, j, env):
            return {"t": omp.at((i, j), env["x"][i, j] * 2.0)}

        @omp.parallel_for(stop=(n, n), collapse=2, schedule=sched,
                          name=f"t2_{seed}")
        def t2(i, j, env):
            return {"y": omp.at((i, j), env["t"][j, i] + 1.0)}

        prog = omp.region(t1, t2, name=f"transpose2_{seed}")

    _same_stages(prog, jprog)
    return prog, env, jprog, jenv, family


def _same_stages(prog, jprog):
    assert prog.name == jprog.name
    for s, js in zip(prog.stages, jprog.stages, strict=True):
        assert s.name == js.name
        if hasattr(s, "bounds"):
            assert (s.bounds, s.reduction) == (js.bounds, js.reduction)


def _case(family, p, seed):
    if family in FAMILIES2:
        return make_case2(seed, family), MESHES2[p], ("i", "j")
    return make_case(seed, family), (p,), ("data",)


# ---------------------------------------------------------------------------
# Plan artifacts
# ---------------------------------------------------------------------------


def _layout(lay):
    if lay == "repl":
        return lay
    if hasattr(lay, "axes"):
        return ("slab2", tuple((a.chunk, a.num_devices, a.local_chunks,
                                a.padded_trip, a.base, a.cover)
                               for a in lay.axes), lay.has_prior)
    return ("slab", lay.chunk, lay.num_devices, lay.local_chunks,
            lay.padded_trip, lay.base, lay.cover, lay.has_prior)


def _cost(c):
    return (c.op, c.payload_bytes, c.wire_bytes, c.hops)


def _bc(bc):
    return (bc.stage, bc.key, bc.op, _cost(bc.cost), same_reason(bc.reason),
            bc.shift, {k: _cost(v) for k, v in bc.alternatives.items()})


def _region_view(rp):
    return dict(
        name=rp.name, axis=rp.axis, num_devices=rp.num_devices,
        stages=[(s.name, s.kind, s.gathers, s.feeds, s.serial_writes)
                for s in rp.stages],
        env_keys=rp.env_keys, touched=rp.touched_keys,
        final={k: _layout(v) for k, v in rp.final_layout.items()},
        counts=(rp.n_elided, rp.n_reshards, rp.n_halo),
        comms=[_bc(bc) for bc in rp.comms],
        log=[same_reason(line) for line in rp.log],
        wire=(rp.planned_wire_bytes, rp.gather_wire_bytes))


def _sched_view(s):
    return dict(
        mode=s.mode, rank=s.rank,
        events=[(e.key, e.consumer, e.consumer_idx, e.producer,
                 e.producer_idx, e.shifts, e.chunks, e.num_devices,
                 e.wire_bytes, e.hops, e.span) for e in s.events],
        groups=[(g.issue_idx, g.issue_stage, g.keys, g.launches_inline,
                 g.launches_packed) for g in s.groups],
        fusions=[(f.stage, f.stage_idx, f.paths, f.launches_inline,
                  f.launches_fused) for f in s.reduce_fusions],
        launches=(s.launches_inline, s.launches_scheduled,
                  s.launches_saved, s.wire_bytes, s.n_hoisted),
        cost=s.modeled_cost_bytes(), lines=s.describe_lines())


def _kernel_view(kp):
    return ((kp.name, kp.rank, kp.n_kernels, kp.max_fused, kp.n_loop_stages),
            [(s.stage_names, s.stage_indices, s.forwarded, s.n_outputs,
              s.grid[:s.rank]) for s in kp.spans])


def _both_plans(case, num, axis, comm="auto"):
    from repro.core import comm_schedule as jcs, pallas_lower as jpl
    from repro.core.region import plan_region as jplan_region
    from repro_torch.core import comm_schedule as cs, kernel_lower as kl
    from repro_torch.core.region import plan_region

    prog, env, jprog, jenv, _ = case
    mine = plan_region(prog, env, num, axis=axis, comm=comm)
    ref = jplan_region(jprog, jenv, num, axis=axis, comm=comm)
    assert _region_view(mine) == _region_view(ref), prog.name
    for mode in ("aggregate", "inline"):
        assert _sched_view(cs.build_comm_schedule(mine, mode=mode)) == \
            _sched_view(jcs.build_comm_schedule(ref, mode=mode)), \
            (prog.name, mode)
    kmine = kl.plan_region_kernels(mine)
    assert _kernel_view(kmine) == _kernel_view(jpl.plan_region_kernels(ref))
    for span in kmine.spans:
        assert span.grid[span.rank:] == tuple(t.n_tiles for t in span.tiles)
        assert span.source.n_programs == span.launch_programs
    return mine, ref


def _multifield(o, fields=3, sweeps=5, n=96, c=4, lib=None):
    """``tests/test_comm.py::_multifield_region`` for either package."""
    a_names = tuple(f"a{k}" for k in range(fields))
    b_names = tuple(f"b{k}" for k in range(fields))

    def sweep(srcs, dsts, name):
        @o.parallel_for(start=1, stop=n - 1, schedule=o.static(c), name=name)
        def body(i, env):
            return {d: o.at(i, 0.25 * (env[s][i - 1] + 2.0 * env[s][i]
                                       + env[s][i + 1]))
                    for s, d in zip(srcs, dsts)}
        return body

    stages, cur, nxt = [], a_names, b_names
    for k in range(sweeps):
        stages.append(sweep(cur, nxt, f"s{k + 1}"))
        cur, nxt = nxt, cur
    env = {k: np.sin((j + 1) * np.arange(n, dtype=np.float32) * 0.01)
           for j, k in enumerate(a_names)}
    env.update({k: np.zeros(n, np.float32) for k in b_names})
    return o.region(*stages, name="multifield"), env


def _jax_env(env):
    import jax.numpy as jnp

    return {k: jnp.asarray(v) for k, v in env.items()}


def test_multifield_and_hoisted_schedules_equal_reference():
    """Same-boundary buffers pack into one exchange per issue point, and
    an exchange whose consumer sits two stages after its producer is
    hoisted to the producer — as the reference schedules them."""
    from repro import omp as jomp
    from repro_torch import omp

    reg, env = _multifield(omp)
    jreg, _ = _multifield(jomp)
    case = (reg, td._env_of(env), jreg, _jax_env(env), "multifield")
    mine, _ = _both_plans(case, 8, "data")
    sched = omp.build_comm_schedule(mine, mode="aggregate")
    assert len(sched.events) == 12 and len(sched.groups) == 4
    assert (sched.launches_inline, sched.launches_scheduled) == (24, 8)

    def hoist(o):
        n, c = 64, 4

        @o.parallel_for(stop=n, schedule=o.static(c), name="mk_u")
        def mk_u(i, env):
            return {"u": o.at(i, env["x"][i] * 2.0)}

        @o.parallel_for(stop=n, schedule=o.static(c), name="mk_w")
        def mk_w(i, env):
            return {"w": o.at(i, env["y"][i] + 1.0)}

        @o.parallel_for(start=1, stop=n - 1, schedule=o.static(c),
                        name="use_u")
        def use_u(i, env):
            return {"z": o.at(i, env["u"][i - 1] + env["u"][i + 1])}

        env = {k: np.arange(n, dtype=np.float32) * (j + 1)
               for j, k in enumerate(("x", "y", "u", "w", "z"))}
        return o.region(mk_u, mk_w, use_u, name="hoist"), env

    (reg, env), (jreg, _) = hoist(omp), hoist(jomp)
    mine, _ = _both_plans((reg, td._env_of(env), jreg, _jax_env(env),
                           "hoist"), 8, "data")
    (ev,) = omp.build_comm_schedule(mine).events
    assert (ev.producer_idx, ev.consumer_idx, ev.span) == (0, 2, 1)


# ---------------------------------------------------------------------------
# Outputs
# ---------------------------------------------------------------------------

VARIANTS = {
    "fused_auto": dict(comm="auto"),
    "fused_inline": dict(comm="auto", comm_schedule="inline"),
    "fused_gather": dict(comm="gather"),
    "fused_gather_inline": dict(comm="gather", comm_schedule="inline"),
    "collective": dict(lowering="collective"),
    "kernel": dict(lowering="kernel"),
}


def _jax_region_reference(jprog, jenv):
    import jax

    out = jax.jit(lambda e: jprog(e))(jenv)
    return {k: np.asarray(v) for k, v in out.items()}


def check_region(case, mesh_shape, axes) -> dict:
    """Every region lowering of the port against JAX ``prog(env)``; the
    two schedule modes bit for bit."""
    from repro_torch import omp

    prog, env, jprog, jenv, family = case
    ref = _jax_region_reference(jprog, jenv)
    td._assert_matches(prog(env), ref, f"{prog.name}/shared memory")
    mesh = omp.make_mesh(mesh_shape, axes, device="cpu")
    outs = {}
    for name, opts in VARIANTS.items():
        outs[name] = omp.compile(prog, mesh, **opts)(env)
        td._assert_matches(outs[name], ref,
                           f"{prog.name}/{name} mesh={mesh_shape}")
    for comm in ("auto", "gather"):
        a = outs["fused_auto" if comm == "auto" else "fused_gather"]
        i = outs["fused_inline" if comm == "auto" else "fused_gather_inline"]
        for k in ref:
            assert torch.equal(a[k], i[k]), (prog.name, comm, k)
    return outs


REGION_FAMILY_OUTPUTS_MATCH_JAX_P = [1, 2, 4, 8]
REGION_FAMILY_OUTPUTS_MATCH_JAX_FAMILY = FAMILIES + FAMILIES2


def region_family_outputs_match_jax(family, p):
    case, shape, axes = _case(family, p, 4000 + 10 * p
                              + (FAMILIES + FAMILIES2).index(family))
    check_region(case, shape, axes)


def _more_regions(o, lib):
    """Scatter + put stages, a whole-array reshard, a stencil reshard
    through a partial-cover slab, and a reduction-carrying chain."""
    f32 = lib.float32

    @o.parallel_for(stop=10, name="c1")
    def c1(i, env):
        return {"z": o.at(3 * i + 2, env["x"][i])}

    @o.parallel_for(stop=10, name="c2")
    def c2(i, env):
        return {"w": o.put(lib.full((4,), 1.0, dtype=f32) * i)}

    @o.parallel_for(stop=12, name="w1")
    def w1(i, env):
        return {"tmp": o.at(i, env["x"][i] * 3.0)}

    @o.parallel_for(stop=12, name="w2")
    def w2(i, env):
        return {"y": o.at(i, env["tmp"][i] + env["tmp"].sum())}

    @o.parallel_for(start=1, stop=11, name="p1")
    def p1(i, env):
        return {"u": o.at(i, env["x"][i] + 1.0)}

    @o.parallel_for(start=1, stop=11, name="p2", reduction={"s": "max"})
    def p2(i, env):
        v = env["u"][i - 1] - env["u"][i + 1]
        return {"v": o.at(i, v), "s": o.red(v)}

    x = np.linspace(-1.0, 2.0, 30).astype(np.float32)
    envs = [
        {"x": x[:10], "z": -np.ones(40, np.float32),
         "w": np.zeros(4, np.float32)},
        {"x": x[:12], "tmp": np.zeros(12, np.float32),
         "y": np.zeros(12, np.float32)},
        {"x": x[:12], "u": np.full(12, 5.0, np.float32),
         "v": np.zeros(12, np.float32), "s": np.float32(-3.0)},
    ]
    regions = [o.region(c1, c2, name="scatter_put"),
               o.region(w1, w2, name="whole"),
               o.region(p1, p2, name="partial")]
    return list(zip(regions, envs))


@pytest.mark.parametrize("p", [2, 8])
def test_multifield_aggregate_issues_fewer_ppermutes_on_equal_bytes(p):
    """The reference's bar (``benchmarks/stencil_halo.py``): inline issues
    at least 2x aggregate's ppermute launches on equal wire bytes, with
    bit-identical outputs equal to the shared-memory run."""
    from repro import omp as jomp
    from repro_torch import omp

    reg, env = _multifield(omp, n=64)
    jreg, _ = _multifield(jomp, n=64)
    ref = _jax_region_reference(jreg, _jax_env(env))
    env = td._env_of(env)
    counts, outs = {}, {}
    for mode in ("aggregate", "inline"):
        mesh = omp.make_mesh((p,), ("data",), device="cpu")
        comp = omp.compile(reg, mesh, comm_schedule=mode, env_like=env)
        mesh.reset_counters()
        outs[mode] = comp(env)
        counts[mode] = (mesh.launches["ppermute"], mesh.bytes["ppermute"])
        td._assert_matches(outs[mode], ref, f"multifield {mode} P={p}")
    (agg, agg_b), (inl, inl_b) = counts["aggregate"], counts["inline"]
    assert inl >= 2 * agg > 0 and agg_b == inl_b, counts
    for k in ref:
        assert torch.equal(outs["aggregate"][k], outs["inline"][k]), k


# ---------------------------------------------------------------------------
# Span pins, passes and rejections
# ---------------------------------------------------------------------------


def _chain(o, lib, n=21):
    @o.parallel_for(stop=n, name="k1")
    def l1(i, env):
        return {"tmp": o.at(i, env["x"][i] * 2.0)}

    @o.parallel_for(stop=n, name="k2")
    def l2(i, env):
        return {"y": o.at(i, env["tmp"][i] + 1.0)}

    @o.parallel_for(stop=n, name="k3", reduction={"tot": "+"})
    def l3(i, env):
        return {"tot": o.red(env["y"][i])}

    env = {"x": np.arange(n, dtype=np.float32) * 0.1,
           "tmp": np.zeros(n, np.float32), "y": np.zeros(n, np.float32),
           "tot": np.float32(0.0)}
    return o.region(l1, l2, l3, name="chaink"), env


def test_span_pins_of_the_reference_hold():
    """chain -> ONE span of 3 stages forwarding {tmp, y}; a halo feed
    breaks spans; serial glue breaks spans (tests/test_pallas_lower.py)."""
    from repro_torch import omp

    mesh = omp.make_mesh((1,), ("data",), device="cpu")
    reg, env = _chain(omp, torch)
    c = omp.compile(reg, mesh, lowering="kernel", env_like=td._env_of(env))
    kp = c.kernel_plan
    assert kp.n_kernels == 1 and kp.max_fused == 3
    assert kp.spans[0].stage_names == ("k1", "k2", "k3")
    assert set(kp.spans[0].forwarded) == {"tmp", "y"}
    assert set(kp.spans[0].source.forwarded) == {(1, "tmp"), (2, "y")}
    assert "register-forwarded: tmp, y" in c.report()
    assert [p.name for p in c.passes][-2:] == ["kernel", "lower"]

    (prog, env, *_), _, _ = _case("pingpong", 1, 18)
    c = omp.compile(prog, mesh, lowering="kernel", env_like=env)
    assert c.kernel_plan.n_kernels == 3 and c.kernel_plan.max_fused == 1

    (prog, env, *_), _, _ = _case("glue", 1, 19)
    c = omp.compile(prog, mesh, lowering="kernel", env_like=env)
    assert c.kernel_plan.n_kernels == 2
    assert all(len(s.stage_names) == 1 for s in c.kernel_plan.spans)


def test_compiled_region_passes_report_and_cost_summary():
    from repro_torch import omp

    (prog, env, *_), shape, axes = _case("pingpong", 4, 7)
    mesh = omp.make_mesh(shape, axes, device="cpu")
    fused = omp.compile(prog, mesh, env_like=env)
    assert [p.name for p in fused.passes] == list(
        ("analyze", "schedule", "plan", "plan_comm", "schedule_comm",
         "lower"))
    assert isinstance(fused.plan, omp.RegionPlan)
    assert fused.boundaries == tuple(fused.plan.comms)
    assert fused.comm_schedule is fused.plan.comm_sched
    summary = fused.cost_summary()
    assert summary["kind"] == "region" and summary["n_halo"] == 2
    assert summary["launches_scheduled"] <= summary["launches_inline"]
    rep = fused.report()
    for needle in ("ParallelRegion transformation report", "HALO-EXCHANGED",
                   "communication schedule", "final buffer layouts"):
        assert needle in rep, needle
    staged = omp.compile(prog, mesh, lowering="collective", env_like=env)
    assert staged.boundaries == () and staged.comm_schedule == ()
    assert [n for n, _ in staged.plan] == [s.name for s in prog.stages]
    assert staged.cost_summary()["kind"] == "region_staged"
    assert "staged lowering" in staged.report()


def _host_glue_region(o, lib):
    @o.parallel_for(stop=8, name="hg1")
    def l1(i, env):
        return {"tmp": o.at(i, env["x"][i] * 2.0)}

    def glue_fn(env):
        # deliberately host-side: a concrete numpy round trip
        total = float(np.asarray(env["tmp"]).sum())
        return {"bias": lib.full((1,), total, dtype=lib.float32)}

    @o.parallel_for(stop=8, name="hg2")
    def l2(i, env):
        return {"y": o.at(i, env["tmp"][i] + env["bias"][0])}

    env = {"x": np.arange(8, dtype=np.float32),
           "tmp": np.zeros(8, np.float32), "bias": np.zeros(1, np.float32),
           "y": np.zeros(8, np.float32)}
    return o.region(l1, o.serial(glue_fn, reads=("tmp",), name="hostglue"),
                    l2, name="hostglue_region"), env


def test_region_rejections_match_reference():
    """chunk_weights on a fused region, the kernel lowering on host-side
    glue (the reference's pallas message, worded for KERNEL), and
    master/worker, which waits for its own slice; the staged lowering
    defers host-glue planning to run time as the reference does."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro.compat import make_mesh as jmake_mesh
    from repro_torch import omp

    mesh = omp.make_mesh((2,), ("data",), device="cpu")
    jmesh = jmake_mesh((1,), ("data",))
    reg, env = _chain(omp, torch)
    jreg, _ = _chain(jomp, jnp)
    with pytest.raises(jomp.CompileError) as ref:
        jomp.compile(jreg, jmesh, chunk_weights=(1.0,))
    with pytest.raises(omp.CompileError) as mine:
        omp.compile(reg, mesh, chunk_weights=(1.0, 2.0))
    assert str(mine.value) == str(ref.value)
    out = omp.compile(reg, mesh, lowering="collective",
                      chunk_weights=(1.0, 2.0))(td._env_of(env))
    td._assert_matches(out, _jax_region_reference(jreg, _jax_env(env)),
                       "weighted staged chain")
    # master/worker stages the region per loop, as collective does
    out = omp.compile(reg, mesh, lowering="master_worker")(td._env_of(env))
    td._assert_matches(out, _jax_region_reference(jreg, _jax_env(env)),
                       "master/worker staged chain")

    hreg, henv = _host_glue_region(omp, torch)
    jhreg, _ = _host_glue_region(jomp, jnp)
    henv_t = td._env_of(henv)
    with pytest.raises(jomp.CompileError, match="PALLAS cannot compile"):
        jomp.compile(jhreg, jmesh, env_like=_jax_env(henv), lowering="pallas")
    with pytest.raises(omp.CompileError, match="KERNEL cannot compile "
                       "region 'hostglue_region'"):
        omp.compile(hreg, mesh, env_like=henv_t, lowering="kernel")
    c = omp.compile(hreg, mesh, env_like=henv_t, lowering="collective")
    assert "not shape-traceable" in c._pass("plan").input
    td._assert_matches(c(henv_t), {k: np.asarray(v) for k, v in
                                   jhreg(_jax_env(henv)).items()},
                       "host glue staged")
