"""K1's rank window on the CPU: the span kernel a process of a process mesh
launches over its own ranks ``lo .. lo + block - 1`` of the first nest
axis (``span_kernel.generate_span(..., block=)``, ``lo`` its first
argument).

* A stacked mesh is the window ``(0, P)``: its generated source is the
  one the generator always wrote, character for character (two pinned
  names, and ``block=P`` against no window on every torch-bodied program
  of the port), so the persistent store's entries stay valid.
* For a rank-1 stencil block, a block product (PolyBench ``gemm``), a
  rank-1 region span of three stages with forwarded keys, a rank-2
  product block and a rank-2 region: each span launched (under the NumPy
  emulation of ``tests/test_torch_span_kernel.py``) on every window of
  ``P/2`` and of ``P/4`` ranks joins to the full launch bit for bit on
  every lane that holds an iteration, and each window equals its plain
  version (``span_values_plain_stages`` on the same rank window) within
  rtol = atol = 1e-4 (the emulation sums in another order).
* The persistent store never hands a process mesh's entry to a stacked
  mesh of the same shape, or the reverse.
* K1's launcher (faked below its C call) hands a windowed kernel its
  first rank ahead of its inputs and outputs.
"""
import dataclasses

import pytest
import torch

from tests import test_torch_differential as td
from tests import test_torch_kernel_audit as ka
from tests import test_torch_polybench as tpb
from tests import test_torch_region as tr
from tests import test_torch_span_kernel as tsk

CPU = torch.device("cpu")
TOL = dict(rtol=1e-4, atol=1e-4)

#: Today's span kernels of two PolyBench blocks at ``tpb.DIMS`` on 8
#: ranks (the generator's name hashes the kernel's parameters and body).
PINNED = {"gemm": "span_765bbd1ecfcbf251", "jacobi2d": "span_32d4db866ca64c03"}


def _kernel_plan(comp, block):
    from repro_torch.core import kernel_lower as kl

    if comp.program.__class__.__name__ == "ParallelRegion":
        return kl.plan_region_kernels(comp.plan, device=CPU, block=block)
    return kl.plan_block_kernel(comp.plan, comp.program,
                                name=comp.program.name, device=CPU,
                                block=block)


def test_stacked_window_generates_todays_source():
    """``block=P`` (the stacked mesh's window, and a process mesh's at
    world 1) generates the source that no window does, on every
    torch-bodied program of the port, and two PolyBench kernels keep their
    pinned names."""
    from repro_torch import omp, polybench

    checked = 0
    for name, prog, env in ka._programs():
        shape, axes = ((4,), ("data",)) if prog.rank == 1 else \
            ((2, 2), ("i", "j"))
        mesh = omp.make_mesh(shape, axes, device="cpu")
        try:
            comp = omp.compile(prog, mesh, lowering="kernel", env_like=env)
        except omp.CompileError:
            continue
        full = comp.kernel_plan.spans
        same = _kernel_plan(comp, shape[0]).spans
        assert [s.source for s in full] == [s.source for s in same], name
        checked += len(full)
    assert checked > 60
    for name, fn in PINNED.items():
        k = polybench.make(name, tpb.DIMS[name])
        comp = omp.compile(k.programs[0], omp.make_mesh(
            (8,), ("data",), device="cpu"), lowering="kernel",
            env_like=k.env_fn("cpu"))
        assert comp.kernel_plan.spans[0].source.fn_name == fn


def _programs():
    from repro_torch import convert, omp, polybench

    k = polybench.make("gemm", tpb.DIMS["gemm"])
    chain, chain_env = tr._chain(omp, torch, n=45)
    return {
        "stencil": (*td.make_case(1601, "stencil")[:2], (8,), ("data",)),
        "gemm": (k.programs[0], k.env_fn("cpu"), (8,), ("data",)),
        "chain": (chain, convert.env_from_numpy(chain_env, "cpu"), (8,),
                  ("data",)),
        "matmul2": (*td.make_case2(1602, "matmul2")[:2], (4, 2),
                    ("i", "j")),
        "heat2d": (*tr.make_case2(1603, "heat2d")[:2], (4, 2), ("i", "j")),
    }


def _spans(comp, env, monkeypatch):
    """Each span's stages (inputs in the global layout) and source, as
    the stacked mesh's run hands them to K1's wrapper."""
    from repro_torch.kernels import span_kernel

    got = []
    real = span_kernel.span_stage_values

    def tap(stages, source, device, window=None):
        got.append((list(stages), source))
        return real(stages, source, device, window=window)

    monkeypatch.setattr(span_kernel, "span_stage_values", tap)
    comp(env)
    monkeypatch.setattr(span_kernel, "span_stage_values", real)
    return got


def _emulate(source, stages, lo, monkeypatch):
    """The span kernel of ``source`` on ``stages``' inputs, emulated, its
    rank window (if any) starting at rank ``lo``."""
    from repro_torch.kernels import span_kernel

    real = span_kernel.kernel_args
    monkeypatch.setattr(span_kernel, "kernel_args",
                        lambda s, io, _=0: real(s, io, lo))
    try:
        return tsk.emulate_span(source, [(st.ext_windows, st.env_repl)
                                         for st in stages],
                                fill=float("nan"))
    finally:
        monkeypatch.setattr(span_kernel, "kernel_args", real)


@pytest.mark.parametrize("name", ["stencil", "gemm", "chain", "matmul2",
                                  "heat2d"])
def test_windows_join_to_the_full_launch(name, monkeypatch):
    from repro_torch import omp
    from repro_torch.core import kernel_lower as kl
    from repro_torch.kernels import span_kernel

    prog, env, shape, axes = _programs()[name]
    comp = omp.compile(prog, omp.make_mesh(shape, axes, device="cpu"),
                       lowering="kernel")
    spans = _spans(comp, env, monkeypatch)
    assert spans
    p = shape[0]
    for si, (stages, source) in enumerate(spans):
        full = _emulate(source, stages, 0, monkeypatch)
        masks = [kl.lane_mask(st.plan, CPU) for st in stages]
        for block in (p // 2, p // 4):
            src = _kernel_plan(comp, block).spans[si].source
            assert src.window == (block, p) and "tl.load(rank_lo)" in src.text
            parts = []
            for lo in range(0, p, block):
                mine = [dataclasses.replace(st, ext_windows={
                    k: v.narrow(1, lo, block)
                    for k, v in st.ext_windows.items()}) for st in stages]
                got = _emulate(src, mine, lo, monkeypatch)
                want = span_kernel.span_values_plain_stages(mine, CPU,
                                                            (lo, block))
                for st, g, w in zip(mine, got, want):
                    m = kl.lane_mask(st.plan, CPU, (lo, block))
                    assert set(g) == set(w)
                    for k in w:
                        assert g[k].shape[1] == block
                        torch.testing.assert_close(
                            g[k][m], w[k][m].to(g[k].dtype), **TOL,
                            msg=f"{name} span {si} window ({lo}, {block}) "
                                f"{k}")
                parts.append(got)
            for i, (m, f) in enumerate(zip(masks, full)):
                for k in f:
                    joined = torch.cat([pt[i][k] for pt in parts], dim=1)
                    assert torch.equal(joined[m], f[k][m]), (
                        name, si, block, k)


def test_store_never_mixes_process_and_stacked_entries(tmp_path):
    """A process mesh (a gloo group of one process here) and a stacked
    mesh of one shape compile the same program: each misses the other's
    store entry, writes its own, and then restores its own; their results
    and their span kernels' sources are equal (world 1 holds every
    rank)."""
    import torch.distributed as dist

    from repro_torch import omp, polybench
    from repro_torch.core import api
    from repro_torch.mesh import ProcessMesh

    k = polybench.make("gemm", tpb.DIMS["gemm"])
    env = k.env_fn("cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    omp.enable_persistent_cache(str(tmp_path / "aot"))
    try:
        meshes = {"stacked": omp.make_mesh((8,), ("data",), device="cpu"),
                  "process": ProcessMesh((8,), ("data",), CPU)}
        assert api._mesh_signature(meshes["stacked"]) != \
            api._mesh_signature(meshes["process"])
        seen, outs, sources = [], {}, {}
        for round_, order in enumerate((("stacked", "process"),
                                        ("process", "stacked"))):
            for which in order:
                omp.clear_compile_cache()
                c = omp.compile(k.programs[0], meshes[which],
                                lowering="kernel")
                outs[which] = c(env)["C"]
                sources[which] = c.kernel_plan.spans[0].source
                seen.append((which, c.restored))
                assert len(omp.AOTStore(str(tmp_path / "aot")).entries()) \
                    == (2 if round_ or which == "process" else 1)
    finally:
        omp.disable_persistent_cache()
        dist.destroy_process_group()
    assert seen == [("stacked", False), ("process", False),
                    ("process", True), ("stacked", True)]
    assert torch.equal(outs["stacked"], outs["process"])
    assert sources["stacked"] == sources["process"]


def test_a_windowed_launch_hands_its_first_rank_to_the_kernel(monkeypatch):
    """K1's launcher on a windowed kernel (faked below the C call): the
    launch's parameters are the window's first rank, as the one-element
    int32 tensor the kernel reads, then every input and output; the grid
    is the source's."""
    import types

    from repro_torch import omp, polybench
    from repro_torch.kernels import span_kernel

    k = polybench.make("gemm", tpb.DIMS["gemm"])
    env = k.env_fn("cpu")
    comp = omp.compile(k.programs[0], omp.make_mesh((8,), ("data",),
                                                    device="cpu"),
                       lowering="kernel", env_like=env)
    src = _kernel_plan(comp, 4).spans[0].source
    blobs = []

    def k1_launch(blob):
        blobs.append(list(blob))
        return 0

    monkeypatch.setattr(span_kernel, "_compile", lambda s, a, o: (
        span_kernel._Compiled(function=7, threads=256, shared=0, extra=())))
    monkeypatch.setattr(span_kernel, "_LAUNCH_LIB", types.SimpleNamespace(
        load=lambda: types.SimpleNamespace(k1_launch=k1_launch)))
    monkeypatch.setattr(span_kernel, "_LAUNCHERS", {})
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: 0, raising=False)
    from repro_torch.core import transform

    repl, slabs = transform.stage_inputs(comp.plan, env, (4, 4))
    outs = span_kernel.launch_span(src, [(slabs, repl)], CPU, lo=4)
    (blob,) = blobs
    n = 1 + len(src.inputs) + len(src.outputs)
    assert blob[:6] == [7, src.n_programs, 256, 0, 0, n] and len(blob) == 6 + n
    assert blob[6] == span_kernel.rank_lo(4, CPU).data_ptr()
    assert span_kernel.rank_lo(4, CPU).tolist() == [4]
    assert blob[-1] == outs[0]["C"].data_ptr()
    assert outs[0]["C"].shape[1] == 4
