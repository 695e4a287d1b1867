"""The PolyBench kernels of the port (``repro_torch.polybench``) held
against the JAX package's (``benchmarks/polybench.py``).

Every kernel at a small size, rectangular where its body allows, with
its env drawn from a numpy seed and handed to both packages:

* the port's ``lowering="kernel"`` (the span wrapper takes its plain
  version on CPU tensors) and ``lowering="collective"`` on 1, 2 and 4
  ranks of the in-process mesh against the reference's ``run_reference``
  at rtol = atol = 1e-4, and on one rank against the reference's
  ``lowering="pallas"`` (interpret mode) on a one-device mesh;
* the generated K1 source of every block: it parses, holds one
  ``tl.dot`` at 3xTF32 per ``mm`` of its body inside a K-loop and one
  row sum per ``mv`` inside a pipelined K-loop (no ``tl.dot``), and
  equals the plain version under the NumPy emulation of
  ``triton.language`` (``tests/test_torch_span_kernel.py``) — with the
  register-tile cap lowered too, so that value axes are tiled over loops
  and the grid.
"""
import ast
import re

import numpy as np
import pytest
import torch

from tests import test_torch_span_kernel as tsk

TOL = dict(rtol=1e-4, atol=1e-4)

#: Small dims, rectangular where the body allows (PolyBench's names).
DIMS = {
    "pi": dict(n=40),
    "gemm": dict(ni=20, nj=23, nk=26),
    "2mm": dict(ni=16, nj=18, nk=22, nl=24),
    "3mm": dict(ni=16, nj=18, nk=20, nl=22, nm=24),
    "atax": dict(m=18, n=22),
    "bicg": dict(m=18, n=22),
    "mvt": dict(n=40),
    "gesummv": dict(n=28),
    "syrk": dict(m=20, n=26),
    "syr2k": dict(m=20, n=26),
    "covariance": dict(m=26, n=30),
    "jacobi2d": dict(n=22),
}

#: The trip count of each block, which sizes the reference's builder.
STOPS = {
    "pi": ("n", "n"), "gemm": ("ni",), "2mm": ("ni", "ni"),
    "3mm": ("ni", "nj", "ni"), "atax": ("m", "m", "m"), "bicg": ("n", "n"),
    "mvt": ("n", "n"), "gesummv": ("n",), "syrk": ("n",), "syr2k": ("n",),
    "covariance": ("m", "m"), "jacobi2d": ("n",),
}

#: ``tl.dot`` calls per block: one per ``aten.mm``.
DOTS = {
    "pi": (0, 0), "gemm": (1,), "2mm": (1, 1), "3mm": (1, 1, 1),
    "atax": (0, 0, 0), "bicg": (0, 0), "mvt": (0, 0), "gesummv": (0,),
    "syrk": (1,), "syr2k": (2,), "covariance": (0, 1), "jacobi2d": (0,),
}
#: Row sums per block: one per ``aten.mv`` (a matrix-vector product).
MVS = {"atax": (1, 0, 0), "bicg": (1, 0), "mvt": (1, 0), "gesummv": (2,)}


def _kernel(name):
    from repro_torch import polybench as pb

    return pb.make(name, DIMS[name])


def _jax_programs(name):
    """The reference's programs for ``DIMS[name]``: block ``b`` of its
    builder sized by that block's own trip count (its bodies take any
    operand shapes)."""
    from benchmarks import polybench as jpb

    build = {"2mm": jpb.make_2mm, "3mm": jpb.make_3mm}.get(
        name, getattr(jpb, f"make_{name}", None))
    return [build(DIMS[name][stop]).programs[b]
            for b, stop in enumerate(STOPS[name])]


def _jax_run(programs, env_np, run):
    import jax.numpy as jnp

    env = {k: jnp.asarray(v) for k, v in env_np.items()}
    for prog in programs:
        env = run(prog, env)
    return {k: np.asarray(v) for k, v in env.items()}


def _jax_reference(name, env_np):
    import jax
    from repro.core import transform as jt

    return _jax_run(_jax_programs(name), env_np, lambda p, e: jax.jit(
        lambda x: jt.run_reference(p, x))(e))


def _port_run(kernel, env_np, mesh, lowering):
    from repro_torch import convert, omp

    env = convert.env_from_numpy(env_np, "cpu")
    for prog in kernel.programs:
        env = omp.compile(prog, mesh, lowering=lowering)(env)
    return convert.env_to_numpy(env)


def _assert_env(got, want, label):
    assert set(got) == set(want), label
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **TOL,
                                   err_msg=f"{label} key={k!r}")


POLYBENCH_KERNEL_MATCHES_REFERENCE_NAME = sorted(DIMS)


def polybench_kernel_matches_reference(name):
    """Both block lowerings on 1, 2 and 4 ranks == the reference's
    ``run_reference`` on the same numpy env (every key: the blocks'
    intermediates too)."""
    from repro_torch import omp

    kernel = _kernel(name)
    assert kernel.dims == DIMS[name]
    env_np = kernel.numpy_env(seed=7)
    want = _jax_reference(name, env_np)
    for p in (1, 2, 4):
        mesh = omp.make_mesh((p,), ("data",), device="cpu")
        for lowering in ("collective", "kernel"):
            _assert_env(_port_run(kernel, env_np, mesh, lowering), want,
                        f"{name} P={p} {lowering}")


POLYBENCH_KERNEL_MATCHES_REFERENCE_PALLAS_NAME = sorted(DIMS)


def polybench_kernel_matches_reference_pallas(name):
    """The port's kernel lowering on one rank == the reference's Pallas
    lowering (interpret mode) on a one-device mesh named ``"data"``."""
    import jax
    from jax.sharding import Mesh

    from repro import omp as jomp
    from repro_torch import omp

    kernel = _kernel(name)
    env_np = kernel.numpy_env(seed=8)
    jmesh = Mesh(np.asarray(jax.devices()[:1]), ("data",))
    want = _jax_run(_jax_programs(name), env_np, lambda p, e: jomp.compile(
        p, jmesh, lowering="pallas")(e))
    mesh = omp.make_mesh((1,), ("data",), device="cpu")
    _assert_env(_port_run(kernel, env_np, mesh, "kernel"), want,
                f"{name} kernel-vs-pallas")


JACOBI2D_PLAN_ARTIFACTS_EQUAL_REFERENCE_SHARD = [False, True]


def jacobi2d_plan_artifacts_equal_reference(shard):
    """jacobi2d's ``DistPlan`` (its strategies: ``A`` replicated, or read
    through halo windows when inputs are sliced) and ``KernelPlan`` spans
    equal the reference's on 1, 2 and 4 ranks; its generated kernel,
    emulated, equals the plain version under either plan."""
    import jax.numpy as jnp

    from repro.core import pallas_lower as jpl
    from repro.core import plan as jplan
    from repro_torch import convert
    from repro_torch.core import kernel_lower as kl
    from repro_torch.core import plan as tplan
    from tests.test_torch_core import _norm

    kernel = _kernel("jacobi2d")
    env_np = kernel.numpy_env(seed=3)
    env = convert.env_from_numpy(env_np, "cpu")
    jenv = {k: jnp.asarray(v) for k, v in env_np.items()}
    (prog,), (jprog,) = kernel.programs, _jax_programs("jacobi2d")
    for p in (1, 2, 4):
        kw = dict(axis="data", shard_inputs=shard, lowering="collective")
        mine = tplan.make_plan(prog, env, p, **kw)
        ref = jplan.make_plan(jprog, jenv, p, **kw)
        assert _norm(mine) == _norm(ref), (p, shard)
        assert mine.vars["A"].in_strategy == (
            "shard_halo" if shard else "replicate")
        tsk._check_family((prog, env), (p,), ("data",),
                          "slice" if shard else "replicate")
        kmine = kl.plan_block_kernel(mine, prog, name=prog.name)
        kref = jpl.plan_block_kernel(ref, name=prog.name)
        assert (kmine.n_loop_stages, kmine.n_kernels) == (
            kref.n_loop_stages, kref.n_kernels) == (1, 1)
        for sm, sr in zip(kmine.spans, kref.spans):
            assert (sm.stage_names, sm.stage_indices, sm.forwarded,
                    sm.n_outputs) == (sr.stage_names, sr.stage_indices,
                                      sr.forwarded, sr.n_outputs)
            assert sm.grid[:1] == sr.grid[:1]


def _check_blocks(name, p, seed=9):
    """Every block's generated source: parses, one ``tl.dot`` at 3xTF32
    per matrix product, inside a loop over its contracted axis, and one
    pipelined row-sum K-loop per matrix-vector product; and, emulated, it
    equals the plain version on every lane that holds an iteration,
    writing every value of those lanes."""
    from repro_torch import convert, omp

    kernel = _kernel(name)
    env = convert.env_from_numpy(kernel.numpy_env(seed), "cpu")
    mesh = omp.make_mesh((p,), ("data",), device="cpu")
    sources = []
    mvs = MVS.get(name, (0,) * len(kernel.programs))
    for prog, dots, mv in zip(kernel.programs, DOTS[name], mvs):
        comp = omp.compile(prog, mesh, lowering="kernel", env_like=env)
        (span,) = comp.kernel_plan.spans
        text = span.source.text
        ast.parse(text)
        assert text.count("tl.dot(") == dots, (prog.name, text)
        # every float32 dot states 3xTF32: none runs at the default
        assert text.count('input_precision="tf32x3"') == dots, text
        if dots:
            assert re.search(r"for t\d+ in range\(0, \d+, \d+\):\n.*\n.*\n"
                             r"\s+r\d+c = ", text), text
        loops = re.findall(r"for t\d+ in tl\.range\(0, \d+, \d+, "
                           r"num_stages=\d+\):", text)
        assert len(loops) == len(re.findall(r"acc\d+ \+= ", text)) == mv, \
            text
        tsk._check_family((prog, env), (p,), ("data",), "replicate")
        sources.append(span.source)
        env = comp(env)
    return sources


POLYBENCH_GENERATED_KERNELS_NAME = sorted(DIMS)


def polybench_generated_kernels(name):
    for p in (1, 4):
        _check_blocks(name, p)


POLYBENCH_VALUE_AXES_TILED_NAME = ["gemm", "covariance", "atax", "syr2k",
                                  "gesummv", "jacobi2d"]


def polybench_value_axes_tiled(name, monkeypatch):
    """With the register-tile cap lowered to 16 elements, value axes of
    22-30 elements no longer fit one tile: products split their output
    over the grid's value axis, stores loop over tiles, and
    ``covariance``'s ``row - mean(row)`` takes a first pass over the row
    before its store pass; with the matrix-vector K tile lowered to 8,
    each row sum takes several K tiles, the last one masked; jacobi2d's
    rolled rows are read at wrapped positions tile by tile — still equal
    to the plain version, and every value of every live lane written."""
    from repro_torch.kernels import span_kernel

    monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", 16)
    monkeypatch.setattr(span_kernel, "_BK_MV", 8)
    sources = _check_blocks(name, 2)
    text = "".join(s.text for s in sources)
    if name in ("gemm", "syr2k", "covariance"):
        assert any(s.value_tiles > 1 for s in sources)
        assert "vt = pid %" in text
    if name == "covariance":
        # two loops over the row: the mean's pass, then the store's
        center = sources[0].text
        assert len(re.findall(r"for t\d+ in range\(0, 30, 16\):",
                              center)) == 2, center
    if name == "atax":
        assert re.search(r"for t\d+ in range\(0, 22, 16\):\n(.*\n)*\s+"
                         r"tl\.store\(", sources[1].text)
    if name in ("atax", "gesummv"):
        k = DIMS[name]["n"]
        assert re.search(rf"for t\d+ in tl\.range\(0, {k}, 8, num_stages=",
                         sources[0].text), sources[0].text
    if name == "jacobi2d":
        assert re.search(r"for t\d+ in range\(0, 22, 16\):", text), text
        assert "+ 21) % 22)" in text and "+ 1) % 22)" in text


def test_polybench_sizes():
    """EXTRALARGE_DATASET dims of PolyBench/C 4.2.1, as the module
    states them; ``pi`` keeps its default."""
    from repro_torch import polybench as pb

    assert pb.LINEAR_ALGEBRA == ("gemm", "2mm", "3mm", "atax", "bicg", "mvt",
                                 "gesummv", "syrk", "syr2k", "covariance")
    assert pb.STENCILS == ("jacobi2d",)
    assert [b.__name__ for b in pb.ALL_KERNELS] == [
        f"make_{n}" for n in ("pi",) + pb.LINEAR_ALGEBRA + pb.STENCILS]
    assert pb.make("gemm").dims == dict(ni=2000, nj=2300, nk=2600)
    # PolyBench's jacobi-2d EXTRALARGE N, one sweep (TSTEPS 1000 -> 1)
    jac = pb.make("jacobi2d")
    assert jac.dims == dict(n=2800) and jac.check_keys == ("B",)
    (loop,) = jac.programs
    assert (loop.name, loop.bounds) == ("jacobi", ((1, 2799, 1),))
    assert pb.make("covariance").dims == dict(m=2600, n=3000)
    assert pb.make("pi").dims == dict(n=2048)
    k = pb.make("3mm", dict(ni=3, nj=4, nk=5, nl=6, nm=7))
    shapes = {key: v.shape for key, v in k.numpy_env().items()}
    assert shapes == {"A": (3, 5), "B": (5, 4), "C": (4, 7), "D": (7, 6),
                      "E": (3, 4), "F": (4, 6), "G": (3, 6)}
    assert [p.bounds for p in k.programs][1] == k.programs[1].bounds
    a, b = k.numpy_env(seed=1), k.numpy_env(seed=1)
    assert all(np.array_equal(a[key], b[key]) for key in a)


def _cuda_route(name, monkeypatch):
    """The span wrapper on CPU tensors, then with the device check
    bypassed as if they stood on the card: the calls it makes (the plain
    version, or a launch of ``name``'s first block's kernel recorded by
    a stand-in) and that block's generated source."""
    from repro_torch import convert, omp
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel

    kernel = _kernel(name)
    env = convert.env_from_numpy(kernel.numpy_env(), "cpu")
    comp = omp.compile(kernel.programs[0],
                       omp.make_mesh((2,), ("data",), device="cpu"),
                       lowering="kernel", env_like=env)
    source = comp.kernel_plan.spans[0].source
    repl, slabs = transform.stage_inputs(comp.plan, env)
    stages = [kernel_lower.SpanStage(plan=comp.plan,
                                     program=kernel.programs[0],
                                     ext_windows=slabs, env_repl=repl)]
    calls = []
    monkeypatch.setattr(span_kernel, "span_values_plain_stages",
                        lambda *a: calls.append("plain") or [{}])
    monkeypatch.setattr(span_kernel, "launch_span",
                        lambda src, io, dev, lo=0: calls.append(
                            ("launch", src.fn_name, dev.type)) or [{}])
    span_kernel.span_stage_values(stages, source, "cpu")
    monkeypatch.setattr(span_kernel, "_check_device",
                        lambda tensors, device: torch.device(device))
    span_kernel.span_stage_values(stages, source, "cuda")
    return calls, source


@pytest.mark.parametrize("name", ["gesummv", "jacobi2d"])
def test_cuda_span_of_a_row_sum_or_roll_never_reaches_the_plain_version(
        name, monkeypatch):
    """The matrix-vector row sums (gesummv: two, no ``tl.dot``) and the
    rolled rows of jacobi2d launch their generated kernel on the card;
    the plain version serves CPU tensors only."""
    calls, source = _cuda_route(name, monkeypatch)
    assert "tl.dot(" not in source.text
    assert source.text.count("tl.range(") == (2 if name == "gesummv" else 0)
    assert calls == ["plain", ("launch", source.fn_name, "cuda")]


def test_cuda_span_of_a_product_never_reaches_the_plain_version(
        monkeypatch):
    """On a CUDA device the wrapper launches the generated ``tl.dot``
    kernel (here a stand-in that records the call) and never takes the
    plain version, which serves CPU tensors only."""
    from repro_torch import convert, omp
    from repro_torch.core import kernel_lower, transform
    from repro_torch.kernels import span_kernel

    kernel = _kernel("gemm")
    env = convert.env_from_numpy(kernel.numpy_env(), "cpu")
    comp = omp.compile(kernel.programs[0],
                       omp.make_mesh((2,), ("data",), device="cpu"),
                       lowering="kernel", env_like=env)
    source = comp.kernel_plan.spans[0].source
    assert "tl.dot(" in source.text
    repl, slabs = transform.stage_inputs(comp.plan, env)
    stages = [kernel_lower.SpanStage(plan=comp.plan,
                                     program=kernel.programs[0],
                                     ext_windows=slabs, env_repl=repl)]
    calls = []
    monkeypatch.setattr(span_kernel, "span_values_plain_stages",
                        lambda *a: calls.append("plain") or [{}])
    monkeypatch.setattr(span_kernel, "launch_span",
                        lambda src, io, dev, lo=0: calls.append(
                            ("launch", src.fn_name, dev.type)) or [{}])
    span_kernel.span_stage_values(stages, source, "cpu")
    # the inputs stand on the card: only the device check is bypassed
    monkeypatch.setattr(span_kernel, "_check_device",
                        lambda tensors, device: torch.device(device))
    span_kernel.span_stage_values(stages, source, "cuda")
    assert calls == ["plain", ("launch", source.fn_name, "cuda")]
