"""The span kernel (K1) of the PyTorch port: code generation and its
plain version.

There is no Triton and no card on the CPU, so the generated kernel
source runs here under a small NumPy emulation of the ``triton.language``
subset the template emits (:class:`_FakeTL`: program ids, aranges,
pointer arithmetic, masked loads and stores, pointwise math, reductions
over the value axis).  It must equal :func:`span_values_plain` on every
block family — the same comparison ``chip_smoke.py`` and
``tests/test_torch_gpu.py`` make on the card, where the real kernel runs.
"""
import sys
import types

import numpy as np
import pytest
import torch

from tests import test_torch_differential as td

POINTWISE = dict(rtol=1e-5, atol=1e-5)
REDUCING = dict(rtol=1e-4, atol=1e-4)   # trailing sums: another order


# ---------------------------------------------------------------------------
# A NumPy emulation of the triton.language subset the template emits
# ---------------------------------------------------------------------------


class _Arr(np.ndarray):
    """A block value: an ndarray with Triton's ``.to(dtype)``, kept an
    array even when 0-d."""

    def to(self, dtype):
        return np.asarray(self).astype(dtype).view(_Arr)

    def __array_wrap__(self, out, context=None, return_scalar=False):
        return np.asarray(out).view(_Arr)

    def __mod__(self, other):
        # Triton's integer % is C's (the sign of the dividend), NumPy's is
        # Python's: emulate the card, so the generator's fix-up is tested
        a, b = np.asarray(self), np.asarray(other)
        if np.issubdtype(np.result_type(a, b), np.integer):
            return _arr(np.fmod(a, b))
        return _arr(np.mod(a, b))


def _arr(x):
    return np.asarray(x).view(_Arr)


class _Ptr:
    def __init__(self, flat, off=0):
        self.flat, self.off = flat, off

    def __add__(self, other):
        return _Ptr(self.flat, self.off + np.asarray(other))

    __radd__ = __add__


def _fake_modules(state):
    tl = types.ModuleType("triton.language")
    tl.float32, tl.float16, tl.float64 = np.float32, np.float16, np.float64
    tl.int32, tl.int64, tl.int16, tl.int8 = np.int32, np.int64, np.int16, np.int8
    tl.uint8, tl.int1 = np.uint8, np.bool_
    tl.program_id = lambda axis: _arr(np.int32(state["pid"]))
    tl.arange = lambda lo, hi: _arr(np.arange(lo, hi, dtype=np.int32))
    tl.minimum = lambda a, b: _arr(np.minimum(a, b))
    tl.maximum = lambda a, b: _arr(np.maximum(a, b))
    tl.where = lambda c, a, b: _arr(np.where(c, a, b))
    tl.abs = lambda x: _arr(np.abs(x))
    tl.exp = lambda x: _arr(np.exp(x))
    tl.log = lambda x: _arr(np.log(x))
    tl.sqrt = lambda x: _arr(np.sqrt(x))
    tl.full = lambda shape, v, dt: _arr(np.full(shape, v, dtype=dt))
    tl.sum = lambda x, axis: _arr(np.sum(x, axis=axis, dtype=np.asarray(x).dtype))
    tl.max = lambda x, axis: _arr(np.max(x, axis=axis))
    tl.min = lambda x, axis: _arr(np.min(x, axis=axis))

    def load(ptr, mask=None, other=0):
        off = np.asarray(ptr.off)
        if mask is None:
            return _arr(ptr.flat[off])
        m = np.broadcast_to(mask, np.broadcast_shapes(off.shape,
                                                      np.shape(mask)))
        off = np.broadcast_to(off, m.shape)
        return _arr(np.where(m, ptr.flat[np.where(m, off, 0)],
                             np.asarray(other, ptr.flat.dtype)))

    def store(ptr, val, mask=None):
        off = np.asarray(ptr.off)
        shape = np.broadcast_shapes(off.shape, np.shape(val),
                                    np.shape(mask) if mask is not None else ())
        off, val = np.broadcast_to(off, shape), np.broadcast_to(val, shape)
        m = np.broadcast_to(True if mask is None else mask, shape)
        ptr.flat[off[m]] = val[m]

    tl.load, tl.store = load, store

    class _Jit:
        def __init__(self, fn):
            self.fn = fn

        def __getitem__(self, grid):
            def run(*args, num_warps=4):
                ptrs = [_Ptr(t.numpy().reshape(-1)) for t in args]
                for pid in range(grid[0]):
                    state["pid"] = pid
                    self.fn(*ptrs)
            return run

    triton = types.ModuleType("triton")
    triton.jit = _Jit
    triton.language = tl
    return triton, tl


def emulate(source, windows, env_repl, fill=0.0):
    """Run a generated span kernel on CPU tensors, as ``launch`` would
    on the card (outputs start as ``fill``)."""
    state = {"pid": 0}
    triton, tl = _fake_modules(state)
    saved = {k: sys.modules.get(k) for k in ("triton", "triton.language")}
    sys.modules["triton"], sys.modules["triton.language"] = triton, tl
    try:
        ns: dict = {}
        exec(compile(source.text, f"<{source.fn_name}>", "exec"), ns)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    args = [(windows if kind == "win" else env_repl)[key].contiguous()
            for kind, key in source.inputs]
    outs = {key: torch.full(shape, fill, dtype=dtype)
            for key, shape, dtype in source.outputs}
    ns[source.fn_name][(source.n_programs,)](*args, *outs.values())
    return outs


# ---------------------------------------------------------------------------
# Generated kernel == plain version, every block family
# ---------------------------------------------------------------------------


def _span_inputs(compiled, env):
    from repro_torch.core import transform

    plan = compiled.plan
    return transform.stage_inputs(plan, env)


def _live_slot_lanes(plan):
    """Lanes of the dense layout in chunk slots that hold an iteration:
    slot ``q * P + d`` of an axis starts at iteration ``slot * c``."""
    masks = []
    for ch, loop in zip(plan.chunks_axes, plan.nest.axes):
        slot = torch.arange(ch.num_chunks).view(ch.local_chunks,
                                                ch.num_devices, 1)
        live = slot * ch.chunk < loop.trip_count
        masks.append(live.expand(-1, -1, ch.chunk))
    if len(masks) == 1:
        return masks[0]
    return masks[0][:, :, :, None, None, None] & masks[1][None, None, None]


def _check_family(case, mesh_shape, axes, shard):
    """Emulated kernel == plain version on every lane that holds an
    iteration; the kernel writes every lane of the live chunk slots and
    leaves the padding slots unwritten."""
    from repro_torch import omp
    from repro_torch.core import kernel_lower
    from repro_torch.kernels import span_kernel

    prog, env = case[0], case[1]
    mesh = omp.make_mesh(mesh_shape, axes, device="cpu")
    comp = omp.compile(prog, mesh, lowering="kernel", shard=shard,
                       env_like=env)
    if not comp.kernel_plan.spans:
        return
    source = comp.kernel_plan.spans[0].source
    repl, slabs = _span_inputs(comp, env)
    got = emulate(source, slabs, repl, fill=float("nan"))
    want = span_kernel.span_values_plain(comp.plan, prog, slabs, repl,
                                         torch.device("cpu"))
    assert set(got) == set(want)
    mask = kernel_lower.lane_mask(comp.plan, "cpu")
    tol = REDUCING if source.text.count("tl.sum(") else POINTWISE
    for k in want:
        np.testing.assert_allclose(got[k][mask].numpy(),
                                   want[k][mask].numpy(), **tol,
                                   err_msg=f"{prog.name} key={k}")
        if got[k].is_floating_point():
            written = ~torch.isnan(got[k]).reshape(mask.shape + (-1,))
            live = _live_slot_lanes(comp.plan)
            assert bool((written == live[..., None]).all()), prog.name


@pytest.mark.parametrize("family", td.BLOCK_FAMILIES)
@pytest.mark.parametrize("p", [1, 3])
@pytest.mark.parametrize("shard", ["replicate", "slice"])
def test_generated_kernel_matches_plain_rank1(family, p, shard):
    for seed in (11, 12):
        _check_family(td.make_case(seed, family), (p,), ("data",), shard)


@pytest.mark.parametrize("family", td.BLOCK_FAMILIES2)
@pytest.mark.parametrize("shape", [(1, 1), (2, 2)])
@pytest.mark.parametrize("shard", ["replicate", "slice"])
def test_generated_kernel_matches_plain_rank2(family, shape, shard):
    for seed in (21, 22):
        _check_family(td.make_case2(seed, family), shape, ("i", "j"), shard)


@pytest.mark.parametrize("family", ["stencil", "combo", "matmul2"])
def test_generated_kernel_with_64bit_offsets(family, monkeypatch):
    """Buffers past 2^29 elements switch the offsets to 64 bits; lowering
    the threshold runs that variant of the template on small inputs."""
    from repro_torch.kernels import span_kernel

    monkeypatch.setattr(span_kernel, "_WIDE_ELEMS", 1)
    if family == "matmul2":
        _check_family(td.make_case2(41, family), (2, 2), ("i", "j"), "slice")
    else:
        _check_family(td.make_case(41, family), (3,), ("data",), "slice")


def test_generated_kernel_heat2d_halo_windows():
    """A five-point collapse(2) sweep with sliced inputs: 2-D halo
    windows, rows and columns clamped into each chunk's window."""
    from repro_torch import omp

    @omp.parallel_for(start=(1, 1), stop=(9, 12), collapse=2,
                      schedule=omp.dynamic(2))
    def heat(i, j, env):
        v = 0.25 * (env["a"][i - 1, j] + env["a"][i + 1, j]
                    + env["a"][i, j - 1] + env["a"][i, j + 1])
        return {"b": omp.at((i, j), v)}

    g = np.random.default_rng(0)
    env = {"a": torch.tensor(g.standard_normal((10, 13), np.float32)),
           "b": torch.zeros(10, 13)}
    for shape in ((1, 1), (2, 2), (4, 2)):
        _check_family((heat, env), shape, ("i", "j"), "slice")


def test_generated_kernel_pointwise_ops_and_scalars():
    """exp/log/sqrt/abs/neg/reciprocal/where/comparisons/maximum/minimum,
    a 0-d env scalar, integer index arithmetic with a negative dividend,
    a trailing amax and amin — all through the template (the ``ops`` body
    that ``chip_smoke.py`` also runs on the card)."""
    import chip_smoke
    from repro_torch import omp

    (body, env), = [(p, e) for p, e in chip_smoke.families(
        omp, torch, torch.device("cpu")) if p.name == "ops"]
    for p in (1, 4):
        _check_family((body, env), (p,), ("data",), "slice")


def test_generated_kernel_launches_only_slots_holding_iterations():
    """The grid covers the chunk slots that hold an iteration: a trip of
    37 in chunks of 3 over 4 ranks fills 13 of the plan's 16 slots."""
    from repro_torch import omp

    @omp.parallel_for(stop=37, schedule=omp.static(3))
    def body(i, env):
        return {"y": omp.at(i, env["x"][i] + 1.0)}

    env = {"x": torch.arange(37, dtype=torch.float32), "y": torch.zeros(37)}
    comp = omp.compile(body, omp.make_mesh((4,), ("data",), device="cpu"),
                       lowering="kernel", shard="slice", env_like=env)
    (span,) = comp.kernel_plan.spans
    assert comp.plan.chunks.num_chunks == 16
    assert span.slots == (13,)
    assert span.source.n_programs == span.launch_programs == 13
    _check_family((body, env), (4,), ("data",), "slice")


def test_chip_smoke_check_rejects_a_wrong_kernel_at_any_scale():
    """The kernel-vs-plain check scales its absolute tolerance with the
    values: per-lane values of order 1e-7 (``pi``'s sum lanes) fail it
    when zeroed or 0.1% off, as values of order 1 do."""
    import chip_smoke

    for scale in (1.2e-7, 1.0, 3e4):
        want = scale * (1.0 + torch.rand(1000, generator=torch.Generator()
                                         .manual_seed(0)))
        for tol in (1e-5, 1e-4):
            assert chip_smoke.agree(torch, want.clone(), want, tol)
            assert not chip_smoke.agree(torch, want * 1.001, want, tol)
            assert not chip_smoke.agree(torch, torch.zeros_like(want),
                                        want, tol)


def test_unsupported_op_raises_compile_error_naming_it():
    """A row-times-matrix body (``torch.dot`` vmaps to ``aten.mm``) needs
    tl.dot: the kernel lowering refuses it at compile time, naming the op;
    the collective lowering still runs it."""
    from repro_torch import omp

    @omp.parallel_for(stop=(3, 4), collapse=2)
    def mm(i, j, env):
        return {"C": omp.at((i, j), torch.dot(env["A"][i], env["B"][:, j]))}

    env = {"A": torch.ones(3, 5), "B": torch.ones(5, 4),
           "C": torch.zeros(3, 4)}
    mesh = omp.make_mesh((1, 1), ("i", "j"), device="cpu")
    with pytest.raises(omp.CompileError, match="aten.mm"):
        omp.compile(mm, mesh, lowering="kernel", env_like=env)
    out = omp.compile(mm, mesh, lowering="collective")(env)
    np.testing.assert_allclose(out["C"].numpy(), np.full((3, 4), 5.0))


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """The wrapper picks the plain version only for CPU tensors; any
    other device launches the kernel or raises."""
    from repro_torch import omp
    from repro_torch.kernels import span_kernel

    mesh = omp.make_mesh((2,), ("data",), device="cpu")
    calls = []
    monkeypatch.setattr(span_kernel, "span_values_plain",
                        lambda *a: calls.append("plain") or {})
    monkeypatch.setattr(span_kernel, "launch",
                        lambda *a: calls.append("launch") or {})

    prog, env = td.make_case(5, "map")[:2]
    comp = omp.compile(prog, mesh, lowering="kernel", env_like=env)
    source = comp.kernel_plan.spans[0].source
    repl, slabs = _span_inputs(comp, env)
    span_kernel.span_values(comp.plan, prog, slabs, repl, source, "cpu")
    assert calls == ["plain"]
    with pytest.raises(ValueError, match="lie on cpu"):
        span_kernel.span_values(comp.plan, prog, slabs, repl, source, "cuda")

    # the put family reads no env: its span has no input tensors at all
    prog, env = td.make_case(5, "put")[:2]
    comp = omp.compile(prog, mesh, lowering="kernel", env_like=env)
    source = comp.kernel_plan.spans[0].source
    assert source.inputs == ()
    span_kernel.span_values(comp.plan, prog, {}, {}, source, "cuda")
    assert calls == ["plain", "launch"]
    with pytest.raises(ValueError, match="CUDA"):
        span_kernel.span_values(comp.plan, prog, {}, {}, source, "meta")
    with pytest.raises(ValueError, match="lowering='kernel'"):
        span_kernel.span_values(comp.plan, prog, {}, {}, None, "cuda")
    assert calls == ["plain", "launch"]
