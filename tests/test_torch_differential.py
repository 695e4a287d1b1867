"""Differential wall of the PyTorch port against the JAX package.

Every single-block family of ``tests/test_differential.py`` has a
torch-bodied twin here (:func:`make_case` / :func:`make_case2`): the same
seed draws the same program parameters, and the JAX case's env, taken
through numpy, is the twin's env (``convert.env_from_numpy``).  The port
runs on the CPU (``device="cpu"``), where the kernel lowering's span
wrapper takes its plain PyTorch version.

Held against the reference:

* outputs of ``lowering="collective"`` (shard replicate and slice, plus
  the one-chunk-per-rank fast path) and ``lowering="kernel"`` against
  JAX ``run_reference`` at rtol=atol=1e-4, on 1/2/4/8-rank meshes and
  the 2-D meshes 1x1/2x1/2x2/4x2;
* ``lowering="kernel"`` against JAX ``lowering="pallas"`` (interpret
  mode) on the 1-device mesh, as ``test_differential_pallas_every_family``
  runs it.
"""
import random

import numpy as np
import pytest
import torch

from tests import test_differential as jd
from tests._hypothesis_compat import given, settings, strategies as st

BLOCK_FAMILIES = ("map", "stencil", "strided", "reduce", "put", "combo")
BLOCK_FAMILIES2 = ("rowreduce2", "matmul2")
TOL = dict(rtol=1e-4, atol=1e-4)


def _schedule(rng):
    from repro_torch import omp

    kind = rng.choice([omp.static, omp.dynamic, omp.guided])
    chunk = rng.choice([None, None, 1, 2, 3, 5])
    return kind(chunk)


def _env_of(jax_env, device="cpu"):
    from repro_torch import convert

    return convert.env_from_numpy(
        {k: np.asarray(v) for k, v in jax_env.items()}, device)


def make_case(seed: int, family: str | None = None, device="cpu"):
    """Torch twin of ``tests.test_differential.make_case`` for the
    single-block families: the same draws in the same order, the same env
    (through numpy).  Returns ``(program, env, jax_program, jax_env,
    family)``; ``None`` when the seed draws a region family."""
    from repro_torch import omp

    rng = random.Random(seed)
    jprog, jenv, drawn = jd.make_case(seed, family)
    if family is None:
        rng.choice(jd.FAMILIES)
    family = drawn
    if family not in BLOCK_FAMILIES:
        return None
    sched = _schedule(rng)
    env = _env_of(jenv, device)

    if family == "map":
        n = rng.randint(3, 24)
        start = rng.choice([0, 0, 1, 2])
        stop = rng.randint(start, n)
        step = rng.choice([1, 1, 2])

        @omp.parallel_for(start=start, stop=stop, step=step, schedule=sched,
                          name=f"map{seed}")
        def prog(i, env):
            return {"y": omp.at(i, env["x"][i] * 2.0 + 1.0)}

    elif family == "stencil":
        n = rng.randint(8, 24)
        w = rng.choice([1, 2])

        @omp.parallel_for(start=w, stop=n - w, schedule=sched,
                          name=f"stencil{seed}")
        def prog(i, env):
            v = (env["x"][i - w] + env["x"][i] + env["x"][i + w]) / 3.0
            return {"y": omp.at(i, v)}

    elif family == "strided":
        t = rng.randint(1, 9)
        a = rng.choice([2, 3])
        b = rng.randint(0, 2)

        @omp.parallel_for(stop=t, schedule=sched, name=f"strided{seed}")
        def prog(i, env):
            return {"z": omp.at(a * i + b, env["x"][i] + 3.0)}

    elif family == "reduce":
        n = rng.randint(1, 20)
        op = rng.choice(["+", "max", "min", "*"])
        rng.random()  # the fresh/existing accumulator draw (env carries it)

        @omp.parallel_for(stop=n, schedule=sched, reduction={"s": op},
                          name=f"reduce{seed}")
        def prog(i, env):
            return {"s": omp.red(env["x"][i])}

    elif family == "put":
        t = rng.randint(1, 9)

        @omp.parallel_for(stop=t, schedule=sched, name=f"put{seed}")
        def prog(i, env):
            return {"w": omp.put(
                torch.full((3,), 1.0, device=i.device) * i)}

    else:  # combo
        n = rng.randint(2, 16)

        @omp.parallel_for(stop=n, schedule=sched, reduction={"s": "+"},
                          name=f"combo{seed}")
        def prog(i, env):
            v = env["x"][i] * env["x"][i]
            return {"y": omp.at(i, v), "s": omp.red(v)}

    assert prog.bounds == jprog.bounds, (prog.bounds, jprog.bounds)
    assert prog.name == jprog.name and prog.reduction == jprog.reduction
    return prog, env, jprog, jenv, family




def make_case2(seed: int, family: str | None = None, device="cpu"):
    """Torch twin of ``tests.test_differential.make_case2`` for the
    single-block rank-2 families (``None`` for a region family)."""
    from repro_torch import omp

    rng = random.Random(seed)
    jprog, jenv, drawn = jd.make_case2(seed, family)
    if family is None:
        rng.choice(jd.FAMILIES2)
    family = drawn
    if family not in BLOCK_FAMILIES2:
        return None
    sched = _schedule(rng)
    env = _env_of(jenv, device)

    if family == "rowreduce2":
        n = rng.randint(3, 10)
        m = rng.randint(3, 10)
        op = rng.choice(["+", "max", "min", "*"])
        rng.random()  # the fresh/existing accumulator draw

        @omp.parallel_for(stop=(n, m), collapse=2, schedule=sched,
                          reduction={"s": op}, name=f"rr_{seed}")
        def prog(i, j, env):
            return {"s": omp.red(env["x"][i, j])}

    else:  # matmul2: dot(A[i], B[:, j]) as a product and a trailing sum
        n = rng.randint(3, 9)
        m = rng.randint(3, 9)
        rng.randint(2, 6)

        @omp.parallel_for(stop=(n, m), collapse=2, schedule=sched,
                          name=f"mm_{seed}")
        def prog(i, j, env):
            return {"C": omp.at((i, j),
                                (env["A"][i] * env["B"][:, j]).sum())}

    assert prog.bounds == jprog.bounds, (prog.bounds, jprog.bounds)
    assert prog.name == jprog.name and prog.reduction == jprog.reduction
    return prog, env, jprog, jenv, family


# ---------------------------------------------------------------------------
# Outputs: the port's lowerings against JAX run_reference
# ---------------------------------------------------------------------------


def _jax_reference(jprog, jenv):
    """JAX ``run_reference`` under one ``jax.jit`` (one XLA compile per
    case instead of one per eager op)."""
    import jax
    from repro.core import transform as jt

    out = jax.jit(lambda e: jt.run_reference(jprog, e))(jenv)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_matches(got, ref, label):
    from repro_torch import convert

    assert set(got) == set(ref), (label, sorted(got), sorted(ref))
    got = convert.env_to_numpy(got)
    for k in ref:
        np.testing.assert_allclose(got[k], ref[k], **TOL,
                                   err_msg=f"{label} key={k!r}")


def check_case(case, mesh) -> None:
    """Every block lowering of the port on ``mesh`` against the JAX
    shared-memory reference (the port's own reference too)."""
    from repro_torch import omp

    prog, env, jprog, jenv, family = case
    ref = _jax_reference(jprog, jenv)
    _assert_matches(prog(env), ref, f"{prog.name}/run_reference")
    p = mesh.shape["data"]
    variants = {
        "collective": dict(lowering="collective"),
        "collective_slice": dict(lowering="collective", shard="slice"),
        "kernel": dict(lowering="kernel"),
        "kernel_slice": dict(lowering="kernel", shard="slice"),
        "inline": dict(lowering="collective", comm_schedule="inline"),
    }
    t = len(range(prog.start, prog.stop, prog.step))
    if t > 0:
        # one chunk per rank: the static fast path (no chunk-level vmap)
        variants["onechunk"] = dict(lowering="collective", shard="slice",
                                    schedule=omp.static(-(-t // p)))
    for name, opts in variants.items():
        compiled = omp.compile(prog, mesh, **opts)
        _assert_matches(compiled(env), ref, f"{prog.name}/{name} P={p}")
        if name == "onechunk":
            assert compiled.plan.chunks.local_chunks == 1


def check_case2(case, mesh) -> None:
    from repro_torch import omp

    prog, env, jprog, jenv, family = case
    ref = _jax_reference(jprog, jenv)
    _assert_matches(prog(env), ref, f"{prog.name}/run_reference")
    shape = (mesh.shape["i"], mesh.shape["j"])
    for low in ("collective", "kernel"):
        for shard in ("replicate", "slice"):
            got = omp.compile(prog, mesh, lowering=low, shard=shard)(env)
            _assert_matches(got, ref, f"{prog.name}/{low}/{shard} {shape}")


@pytest.mark.parametrize("p", [1, 2, 4, 8])
@pytest.mark.parametrize("family", BLOCK_FAMILIES)
def test_every_block_family_matches_jax_reference(family, p):
    from repro_torch import omp

    mesh = omp.make_mesh((p,), ("data",), device="cpu")
    j = BLOCK_FAMILIES.index(family)
    check_case(make_case(1000 * p + j, family), mesh)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("family", BLOCK_FAMILIES2)
def test_every_rank2_block_family_matches_jax_reference(family, shape):
    from repro_torch import omp

    mesh = omp.make_mesh(shape, ("i", "j"), device="cpu")
    j = BLOCK_FAMILIES2.index(family)
    check_case2(make_case2(7000 + 100 * shape[0] + 10 * shape[1] + j,
                           family), mesh)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), p=st.sampled_from([1, 2, 3, 4]))
def test_random_block_draws_match_jax_reference(seed, p):
    """Random seeds and schedules (zero-trip and trip < ranks draws
    included) through every lowering."""
    from repro_torch import omp

    family = BLOCK_FAMILIES[seed % len(BLOCK_FAMILIES)]
    check_case(make_case(seed, family),
               omp.make_mesh((p,), ("data",), device="cpu"))


def test_zero_trip_and_fewer_iterations_than_ranks():
    """A zero-trip loop writes nothing but defines a fresh reduction as
    the identity; a 1-iteration loop on 8 ranks leaves 7 idle."""
    from repro import omp as jomp
    from repro_torch import omp

    for stop in (0, 1):
        @omp.parallel_for(stop=stop, reduction={"s": "max"}, name="z")
        def body(i, env):
            return {"y": omp.at(i, env["x"][i] + 1.0),
                    "s": omp.red(env["x"][i])}

        @jomp.parallel_for(stop=stop, reduction={"s": "max"}, name="z")
        def jbody(i, env):
            return {"y": jomp.at(i, env["x"][i] + 1.0),
                    "s": jomp.red(env["x"][i])}

        jenv = {"x": np.arange(3, dtype=np.float32) + 2.0,
                "y": np.zeros(3, np.float32)}
        ref = _jax_reference(jbody, jenv)
        env = _env_of(jenv)
        for p in (1, 8):
            mesh = omp.make_mesh((p,), ("data",), device="cpu")
            for low in ("collective", "kernel"):
                got = omp.compile(body, mesh, lowering=low)(env)
                _assert_matches(got, ref, f"stop={stop} P={p} {low}")


# ---------------------------------------------------------------------------
# Lowering.KERNEL against the reference's Lowering.PALLAS (interpret mode)
# ---------------------------------------------------------------------------


def test_kernel_lowering_matches_jax_pallas_every_family():
    """Each block family through the port's kernel lowering (span
    wrapper -> plain version on the CPU, then merge_chunk_values) and
    through the JAX pallas lowering on its 1-device mesh, as
    ``test_differential_pallas_every_family`` runs it."""
    import jax
    from jax.sharding import Mesh

    from repro import omp as jomp
    from repro.compat import make_mesh as jmake_mesh
    from repro_torch import omp

    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    jmesh2 = jmake_mesh((1, 1), ("i", "j"))
    mesh = omp.make_mesh((1,), ("data",), device="cpu")
    mesh2 = omp.make_mesh((1, 1), ("i", "j"), device="cpu")
    cases = [make_case(500 + j, f) for j, f in enumerate(BLOCK_FAMILIES)]
    cases += [make_case2(600 + j, f) for j, f in enumerate(BLOCK_FAMILIES2)]
    for prog, env, jprog, jenv, family in cases:
        jm, m = (jmesh, mesh) if prog.rank == 1 else (jmesh2, mesh2)
        want = jomp.compile(jprog, jm, lowering="pallas")(jenv)
        want = {k: np.asarray(v) for k, v in want.items()}
        got = omp.compile(prog, m, lowering="kernel")(env)
        _assert_matches(got, want, f"{family} kernel-vs-pallas")


# ---------------------------------------------------------------------------
# Sliced reads past either end of a replicated array
# ---------------------------------------------------------------------------


def test_out_of_range_replicated_reads_match_jax_reference():
    """``x[i + 3]`` past the end and ``x[i - 5]`` before the start (and
    their rank-2 twins): the reference's indexing wraps a negative index
    once and clamps; the port's plain path (``run_reference`` and the
    lane executor's replicated reads) and its kernel lowering give the
    same values, under both shard policies."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import omp

    rng = np.random.default_rng(7)
    x = rng.normal(size=12).astype(np.float32)
    a = rng.normal(size=(6, 5)).astype(np.float32)

    def rank1(o):
        @o.parallel_for(stop=12, name="oob")
        def body(i, env):
            return {"y": o.at(i, env["x"][i + 3] + 10.0 * env["x"][i - 5])}
        return body

    def rank2(o):
        @o.parallel_for(stop=(6, 5), collapse=2, name="oob2")
        def body(i, j, env):
            return {"b": o.at((i, j), env["a"][i + 2, j - 3]
                              - env["a"][i - 4, j + 1])}
        return body

    cases = [(rank1, {"x": x, "y": np.zeros(12, np.float32)}, (2,),
              ("data",)),
             (rank2, {"a": a, "b": np.zeros((6, 5), np.float32)}, (2, 1),
              ("i", "j"))]
    for make, env_np, shape, axes in cases:
        jenv = {k: jnp.asarray(v) for k, v in env_np.items()}
        want = _jax_reference(make(jomp), jenv)
        prog, env = make(omp), _env_of(env_np)
        _assert_matches(prog(env), want, f"{prog.name} run_reference")
        mesh = omp.make_mesh(shape, axes, device="cpu")
        for low in ("collective", "kernel"):
            for shard in ("replicate", "slice"):
                got = omp.compile(prog, mesh, lowering=low, shard=shard)(env)
                _assert_matches(got, want, f"{prog.name} {low}/{shard}")
