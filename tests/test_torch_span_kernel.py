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

    def to(self, dtype, bitcast=False):
        a = np.asarray(self)
        return (a.view(dtype) if bitcast else a.astype(dtype)).view(_Arr)

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
    # Triton's default NaN rule returns the other operand (np.fmin/fmax);
    # PropagateNan.ALL returns the NaN
    tl.PropagateNan = types.SimpleNamespace(NONE="none", ALL="all")
    tl.minimum = lambda a, b, propagate_nan="none": _arr(
        (np.minimum if propagate_nan == "all" else np.fmin)(a, b))
    tl.maximum = lambda a, b, propagate_nan="none": _arr(
        (np.maximum if propagate_nan == "all" else np.fmax)(a, b))
    tl.where = lambda c, a, b: _arr(np.where(c, a, b))
    tl.abs = lambda x: _arr(np.abs(x))
    tl.exp = lambda x: _arr(np.exp(x))
    tl.log = lambda x: _arr(np.log(x))
    tl.sqrt = lambda x: _arr(np.sqrt(x))
    tl.full = lambda shape, v, dt: _arr(np.full(shape, v, dtype=dt))
    tl.sum = lambda x, axis: _arr(np.sum(x, axis=axis, dtype=np.asarray(x).dtype))
    tl.cumsum = lambda x, axis: _arr(np.cumsum(x, axis=axis,
                                               dtype=np.asarray(x).dtype))
    tl.cumprod = lambda x, axis: _arr(np.cumprod(x, axis=axis,
                                                 dtype=np.asarray(x).dtype))
    tl.sort = lambda x, dim, descending=False: _arr(
        np.flip(np.sort(x, axis=dim), axis=dim) if descending
        else np.sort(x, axis=dim))
    tl.debug_barrier = lambda: None

    def associative_scan(x, axis, combine_fn, reverse=False):
        # Triton's scan with a @triton.jit combine function, in order
        assert not reverse
        fn = getattr(combine_fn, "fn", combine_fn)
        a = np.moveaxis(np.array(x), axis, 0)
        for i in range(1, a.shape[0]):
            a[i] = np.asarray(fn(_arr(a[i - 1]), _arr(a[i])))
        return _arr(np.moveaxis(a, 0, axis))

    tl.associative_scan = associative_scan
    tl.sin, tl.cos = (lambda x: _arr(np.sin(x))), (lambda x: _arr(np.cos(x)))
    tl.rsqrt = lambda x: _arr(1.0 / np.sqrt(x))
    tl.erf = lambda x: _arr(_erf(x))
    tl.sigmoid = lambda x: _arr(1.0 / (1.0 + np.exp(-np.asarray(x))))
    tl.floor, tl.ceil = (lambda x: _arr(np.floor(x))), \
        (lambda x: _arr(np.ceil(x)))
    tl.max = lambda x, axis: _arr(np.max(x, axis=axis))
    tl.min = lambda x, axis: _arr(np.min(x, axis=axis))
    tl.zeros = lambda shape, dt: _arr(np.zeros(shape, dtype=dt))
    tl.reshape = lambda x, shape: _arr(np.reshape(np.asarray(x), shape))
    tl.broadcast_to = lambda x, shape: _arr(np.broadcast_to(x, shape))

    def dot(a, b, acc=None, input_precision=None):
        # tl.dot's shape rules, and a float32 accumulator; float32
        # operands state their precision (3xTF32 computed here in float32)
        assert np.ndim(a) == np.ndim(b) == 2 and min(*np.shape(a),
                                                     *np.shape(b)) >= 16
        assert input_precision in ("ieee", "tf32x3") or np.asarray(
            a).dtype in (np.float16,)
        out = np.matmul(np.asarray(a, np.float32), np.asarray(b, np.float32))
        return _arr(out if acc is None else np.asarray(acc) + out)

    tl.dot = dot

    def range_(lo, hi, step=1, num_stages=None):
        assert num_stages is None or num_stages >= 1
        return range(lo, hi, step)

    tl.range = range_

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

        def __call__(self, *args):          # one jit function calls another
            return self.fn(*args)

        def __getitem__(self, grid):
            def run(*args, num_warps=4, num_stages=3):
                ptrs = [_Ptr(t.numpy().reshape(-1)) for t in args]
                for pid in range(grid[0]):
                    state["pid"] = pid
                    self.fn(*ptrs)
            return run

    triton = types.ModuleType("triton")
    triton.jit = _Jit
    triton.language = tl
    # CUDA's libdevice, as the generated source imports it
    ld = types.ModuleType("triton.language.extra.libdevice")
    for name, fn in (("tan", np.tan), ("tanh", np.tanh), ("log1p", np.log1p),
                     ("expm1", np.expm1), ("rint", np.rint),
                     ("pow", np.power)):
        setattr(ld, name, lambda *a, fn=fn: _arr(fn(*(np.asarray(x)
                                                     for x in a))))
    extra = types.ModuleType("triton.language.extra")
    extra.libdevice = ld
    tl.extra = extra
    return triton, tl


def _erf(x):
    """float32 ``erf`` (NumPy has none): torch's, on the array's values."""
    return torch.erf(torch.as_tensor(np.asarray(x))).numpy()


def emulate(source, windows, env_repl, fill=0.0):
    """Run a generated one-stage span kernel on CPU tensors, as
    ``launch`` would on the card (outputs start as ``fill``)."""
    return emulate_span(source, [(windows, env_repl)], fill)[0]


def emulate_span(source, stage_io, fill=0.0):
    """Run a generated span kernel of any number of stages on CPU
    tensors, as ``launch_span`` would on the card; ``stage_io`` holds
    ``(windows, env_repl)`` per stage.  Returns each stage's values."""
    state = {"pid": 0}
    triton, tl = _fake_modules(state)
    names = ("triton", "triton.language", "triton.language.extra")
    saved = {k: sys.modules.get(k) for k in names}
    sys.modules.update(zip(names, (triton, tl, tl.extra)))
    try:
        ns: dict = {}
        exec(compile(source.text, f"<{source.fn_name}>", "exec"), ns)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    from repro_torch.kernels import span_kernel

    args = span_kernel.kernel_args(source, stage_io)
    outs = [{} for _ in stage_io]
    for si, key, shape, dtype in source.outputs:
        # an integer output cannot hold a NaN fill: its least value instead
        f = fill if dtype.is_floating_point or np.isfinite(fill) \
            else torch.iinfo(dtype).min
        outs[si][key] = torch.full(shape, f, dtype=dtype)
    ns[source.fn_name][(source.n_programs,)](
        *args, *(outs[si][key] for si, key, _, _ in source.outputs))
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
        if not want[k].is_floating_point():     # integers: bit for bit
            np.testing.assert_array_equal(got[k][mask].numpy(),
                                          want[k][mask].numpy(),
                                          err_msg=f"{prog.name} key={k}")
            continue
        np.testing.assert_allclose(got[k][mask].numpy(),
                                   want[k][mask].numpy(), **tol,
                                   err_msg=f"{prog.name} key={k}")
        if got[k].is_floating_point():
            # the NaN fill marks an unwritten lane, so a lane whose plain
            # value is NaN itself is held by the value check above only
            written = ~torch.isnan(got[k]).reshape(mask.shape + (-1,))
            seen = ~torch.isnan(want[k]).reshape(mask.shape + (-1,))
            live = _live_slot_lanes(comp.plan)
            assert bool(((written == live[..., None]) | ~seen).all()), \
                prog.name


GENERATED_KERNEL_MATCHES_PLAIN_RANK1_FAMILY = td.BLOCK_FAMILIES
GENERATED_KERNEL_MATCHES_PLAIN_RANK1_P = [1, 3]
GENERATED_KERNEL_MATCHES_PLAIN_RANK1_SHARD = ["replicate", "slice"]


def generated_kernel_matches_plain_rank1(family, p, shard):
    for seed in (11, 12):
        _check_family(td.make_case(seed, family), (p,), ("data",), shard)


GENERATED_KERNEL_MATCHES_PLAIN_RANK2_FAMILY = td.BLOCK_FAMILIES2
GENERATED_KERNEL_MATCHES_PLAIN_RANK2_SHAPE = [(1, 1), (2, 2)]
GENERATED_KERNEL_MATCHES_PLAIN_RANK2_SHARD = ["replicate", "slice"]


def generated_kernel_matches_plain_rank2(family, shape, shard):
    for seed in (21, 22):
        _check_family(td.make_case2(seed, family), shape, ("i", "j"), shard)


GENERATED_KERNEL_WITH_64BIT_OFFSETS_FAMILY = ["stencil", "combo", "matmul2"]


def generated_kernel_with_64bit_offsets(family, monkeypatch):
    """Buffers past 2^29 elements switch the offsets to 64 bits; lowering
    the threshold runs that variant of the template on small inputs."""
    from repro_torch.kernels import span_kernel

    monkeypatch.setattr(span_kernel, "_WIDE_ELEMS", 1)
    if family == "matmul2":
        _check_family(td.make_case2(41, family), (2, 2), ("i", "j"), "slice")
    else:
        _check_family(td.make_case(41, family), (3,), ("data",), "slice")


def generated_kernel_heat2d_halo_windows():
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
    """A rank-2 ``torch.dot(A[i], B[:, j])`` body (``aten.mm`` of an
    i-row and a j-column) is no longer outside the template: the kernel
    lowering compiles it to the outer tile ``A[tile_i, K] @ B[K, tile_j]``
    on ``tl.dot``, equal to the collective lowering; the generated
    kernel equals the plain version on 1x1 and 2x2 meshes."""
    from repro_torch import omp

    @omp.parallel_for(stop=(3, 4), collapse=2)
    def mm(i, j, env):
        return {"C": omp.at((i, j), torch.dot(env["A"][i], env["B"][:, j]))}

    env = {"A": torch.ones(3, 5), "B": torch.ones(5, 4),
           "C": torch.zeros(3, 4)}
    mesh = omp.make_mesh((1, 1), ("i", "j"), device="cpu")
    comp = omp.compile(mm, mesh, lowering="kernel", env_like=env)
    assert "tl.dot(" in comp.kernel_plan.spans[0].source.text
    out = omp.compile(mm, mesh, lowering="collective")(env)
    np.testing.assert_allclose(out["C"].numpy(), np.full((3, 4), 5.0))
    np.testing.assert_allclose(comp(env)["C"].numpy(), out["C"].numpy())

    @omp.parallel_for(start=(1, 0), stop=(21, 19), collapse=2)
    def mm2(i, j, env):
        return {"C": omp.at((i, j), torch.dot(env["A"][i], env["B"][:, j]))}

    g = np.random.default_rng(3)
    env = {"A": torch.tensor(g.standard_normal((22, 37), np.float32)),
           "B": torch.tensor(g.standard_normal((37, 19), np.float32)),
           "C": torch.zeros(22, 19)}
    for shape in ((1, 1), (2, 2)):
        _check_family((mm2, env), shape, ("i", "j"), "slice")


def generated_product_forms(monkeypatch):
    """Products the generator lays out otherwise than PolyBench's: a
    computed per-lane row times a slice ``W[1]`` of a 3-D array read
    transposed, a matrix times the row (``M @ row``), a product reduced
    over its own output (the K-loop inside the sum's loop), a mean, and
    one position of a computed row — each equal to the plain version,
    with the register-tile cap at its default and lowered to 16, and
    under 3xTF32 and IEEE float32.  A matrix whose tiles run the other
    way than the dot reads them fastest is handed over as a copy with its
    last two dims swapped: under 3xTF32 (K-major tiles) ``B``, which runs
    along N; in IEEE (N-major tiles) ``W[1].T`` and ``M``, which run along
    K."""
    from repro_torch import omp
    from repro_torch.kernels import span_kernel

    @omp.parallel_for(stop=23, reduction={"s": "+"})
    def forms(i, env):
        row = 2.0 * env["A"][i] + 1.0
        v = row @ env["W"][1].T + env["M"] @ env["A"][i]
        return {"y": omp.at(i, v - torch.mean(v)),
                "s": omp.red((env["A"][i] @ env["B"]).sum() + row[3])}

    g = np.random.default_rng(4)
    env = {"A": torch.tensor(g.standard_normal((23, 37), np.float32)),
           "W": torch.tensor(g.standard_normal((2, 29, 37), np.float32)),
           "M": torch.tensor(g.standard_normal((29, 37), np.float32)),
           "B": torch.tensor(g.standard_normal((37, 19), np.float32)),
           "y": torch.zeros(23, 29), "s": torch.zeros(())}
    cap0 = span_kernel._MAX_TILE_ELEMS
    for cap, precision in ((cap0, "tf32x3"), (16, "tf32x3"), (16, "ieee")):
        monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", cap)
        monkeypatch.setattr(span_kernel, "_F32_PRECISION", precision)
        omp.clear_compile_cache()       # compiles are cached by structure
        comp = omp.compile(forms, omp.make_mesh((2,), ("data",),
                                                device="cpu"),
                           lowering="kernel", env_like=env)
        source = comp.kernel_plan.spans[0].source
        # one dot per product, emitted again in each tiling that reads it
        assert source.text.count("tl.dot(") == source.text.count(
            f'input_precision="{precision}"') >= 3
        copied = {key for kind, _, key in source.inputs if kind == "replT"}
        assert copied == ({"B"} if precision == "tf32x3" else {"W", "M"})
        for p in (1, 3):
            _check_family((forms, env), (p,), ("data",), "replicate")


def test_op_outside_the_template_raises_compile_error_naming_it():
    """An op the template cannot express (the indices of ``cummax`` along
    the row: its values, ``cumsum``, ``cumprod`` and ``logcumsumexp`` are
    in the template, the indices have no ``jnp`` twin in the reference)
    is refused at compile time by the kernel lowering, naming the op; the
    collective lowering still runs it."""
    from repro_torch import omp

    @omp.parallel_for(stop=6)
    def scan(i, env):
        return {"Y": omp.at(i, torch.cummax(env["X"][i], 0).indices)}

    env = {"X": torch.arange(5.0).repeat(6, 1),
           "Y": torch.zeros(6, 5, dtype=torch.int64)}
    mesh = omp.make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(omp.CompileError,
                       match="aten.cummax.default's indices"):
        omp.compile(scan, mesh, lowering="kernel", env_like=env)
    out = omp.compile(scan, mesh, lowering="collective")(env)
    np.testing.assert_array_equal(out["Y"].numpy(),
                                  np.tile(np.arange(5), (6, 1)))


def _roll_bodies(s):
    """Rank-1 and rank-2 bodies that roll per-lane rows by ``s``: a row
    load, a computed row, a product's output (its matrix's columns
    wrapped), a replicated vector, a reduction and one position of a
    rolled row."""
    from repro_torch import omp

    @omp.parallel_for(start=1, stop=22, reduction={"s": "+"}, name="roll1")
    def roll1(i, env):
        row = env["A"][i]
        v = (torch.roll(row, s) + torch.roll(2.0 * row - env["w"], s)
             * torch.roll(env["w"], s))
        p = torch.roll(row @ env["M"], s)
        return {"Y": omp.at(i, v), "P": omp.at(i, p - torch.roll(row, s)[0]),
                "s": omp.red(torch.roll(row, s).sum() * torch.roll(row, s)[3])}

    @omp.parallel_for(stop=(5, 6), collapse=2, name="roll2")
    def roll2(i, j, env):
        v = torch.roll(env["A"][i] * env["B"][j], s)
        return {"Z": omp.at((i, j), v + torch.roll(env["A"][j], s)),
                "T": omp.at((i, j), (v * env["w"]).sum())}

    g = np.random.default_rng(6)

    def t(*shape):
        return torch.tensor(g.standard_normal(shape).astype(np.float32))

    n = 19
    env1 = {"A": t(23, n), "w": t(n), "M": t(n, n), "Y": torch.zeros(23, n),
            "P": torch.zeros(23, n), "s": torch.zeros(())}
    env2 = {"A": t(6, n), "B": t(6, n), "w": t(n), "Z": torch.zeros(5, 6, n),
            "T": torch.zeros(5, 6)}
    return n, (roll1, env1), (roll2, env2)


GENERATED_ROW_SUM_PRODUCTS_MATCH_PLAIN_DTYPE = ["float32", "int32"]


def generated_row_sum_products_match_plain(dtype, monkeypatch):
    """Products without ``tl.dot``, emulated against the plain version on
    1 and 3 ranks, the register-tile cap at its default and at 16: a
    product one position wide (a one-column matrix, a one-column slice,
    a one-row slice of a transposed matrix times the row) is a
    matrix-vector row sum, with no ``tl.dot`` in the span; int32
    operands (a matrix, a one-column slice) are row sums in int32 whose
    products and sums wrap past 2^31 — bit for bit — with no flops on
    ``tl.dot``."""
    from repro_torch import omp
    from repro_torch.kernels import span_kernel

    g = np.random.default_rng(41)
    if dtype == "int32":
        draw = lambda *s: torch.tensor(g.integers(-60000, 60000, size=s),
                                       dtype=torch.int32)
    else:
        draw = lambda *s: torch.tensor(g.standard_normal(s, np.float32))

    @omp.parallel_for(stop=23, reduction={"s": "+"})
    def rows(i, env):
        row = env["A"][i]
        one = row @ env["M"][:, 1:2] + env["M"].t()[3:4] @ row
        return {"y": omp.at(i, row @ env["V"] - one),
                "Z": omp.at(i, (row * 2) @ env["M"] if dtype == "int32"
                            else row @ env["V"] * row),
                "s": omp.red((row @ env["V"]).sum())}

    dt = getattr(torch, dtype)
    env = {"A": draw(23, 37), "M": draw(37, 5), "V": draw(37, 1),
           "y": torch.zeros(23, 1, dtype=dt), "s": torch.zeros((), dtype=dt),
           "Z": torch.zeros(23, 5 if dtype == "int32" else 37, dtype=dt)}
    for cap in (span_kernel._MAX_TILE_ELEMS, 16):
        monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", cap)
        omp.clear_compile_cache()       # compiles are cached by structure
        comp = omp.compile(rows, omp.make_mesh((2,), ("data",),
                                               device="cpu"),
                           lowering="kernel", env_like=env)
        source = comp.kernel_plan.spans[0].source
        assert "tl.dot(" not in source.text, source.text
        assert source.dot_flops_per_lane == 0
        for p in (1, 3):
            _check_family((rows, env), (p,), ("data",), "replicate")
    omp.clear_compile_cache()


GENERATED_ROLL_MATCHES_PLAIN_SHIFT = [-1, 1, 0, "n+2"]


def generated_roll_matches_plain(shift, monkeypatch):
    """``torch.roll`` along a per-lane value axis (``aten.roll``): the
    rolled value is emitted again at the wrapped positions ``(r - s) mod
    n``, on rank-1 and rank-2 nests, with the value axis whole and in
    tiles (register-tile cap 16); the generated source, emulated, equals
    the plain version, and the kernel lowering equals ``prog(env)``."""
    from repro_torch import omp
    from repro_torch.kernels import span_kernel

    n = _roll_bodies(0)[0]
    s = n + 2 if shift == "n+2" else shift
    _, case1, case2 = _roll_bodies(s)
    for cap in (span_kernel._MAX_TILE_ELEMS, 16):
        monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", cap)
        omp.clear_compile_cache()       # compiles are cached by structure
        for p in (1, 3):
            _check_family(case1, (p,), ("data",), "replicate")
        _check_family(case2, (2, 2), ("i", "j"), "replicate")
    for (prog, env), shape, axes in ((case1, (2,), ("data",)),
                                     (case2, (2, 1), ("i", "j"))):
        mesh = omp.make_mesh(shape, axes, device="cpu")
        comp = omp.compile(prog, mesh, lowering="kernel", env_like=env)
        text = comp.kernel_plan.spans[0].source.text
        assert (f"+ {n - s % n}) % {n})" in text) == (s % n != 0), text
        out, ref = comp(env), prog(env)
        for k in ref:
            np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(),
                                       **REDUCING)


def test_roll_across_lanes_or_of_a_register_tile_raises_naming_it(
        monkeypatch):
    """The rolls the template still refuses, at compile time, naming
    ``aten.roll``: a flattened roll of a value of several axes (a
    replicated matrix rolled as one vector), which the collective
    lowering still runs; and a roll across lanes of a value with a value
    axis.  vmap rolls a body's row along its value axis, so the second
    is shown by marking the rolled row's axes the other way round (its
    value axis a lane axis).  A lane scalar's roll (the identity) and a
    roll of a register tile an earlier stage forwards now compile
    (``tests/test_torch_repairs.py``)."""
    from repro_torch import omp
    from repro_torch.kernels import span_kernel

    @omp.parallel_for(stop=6)
    def flat(i, env):
        return {"y": omp.at(i, torch.roll(env["M"], 1)[0, 0] * env["x"][i])}

    env = {"M": torch.arange(12.0).reshape(3, 4), "x": torch.arange(6.0),
           "y": torch.zeros(6)}
    mesh = omp.make_mesh((2,), ("data",), device="cpu")
    with pytest.raises(omp.CompileError,
                       match="aten.roll.*flattened value of several axes"):
        omp.compile(flat, mesh, lowering="kernel", env_like=env)
    out = omp.compile(flat, mesh, lowering="collective")(env)
    np.testing.assert_allclose(out["y"].numpy(), 11.0 * np.arange(6.0))

    @omp.parallel_for(stop=6)
    def row(i, env):
        return {"Y": omp.at(i, torch.roll(env["X"][i], 1))}

    roles = span_kernel._roles

    def swapped(ta, tb, name):
        out = roles(ta, tb, name)
        for n in ta.graph.nodes:
            if n.target is torch.ops.aten.roll.default:
                out[n.args[0]] = tuple(
                    {"lane": "v", "v": "lane"}.get(r, r)
                    for r in out[n.args[0]])
        return out

    monkeypatch.setattr(span_kernel, "_roles", swapped)
    env = {"X": torch.ones(6, 5), "Y": torch.zeros(6, 5)}
    with pytest.raises(omp.CompileError,
                       match="aten.roll.*rolls a row across lanes"):
        omp.compile(row, mesh, lowering="kernel", env_like=env)


def test_cuda_tensor_never_reaches_the_plain_version(monkeypatch):
    """The wrapper the executor runs picks the plain version only for CPU
    tensors; any other device launches the kernel or raises."""
    from repro_torch import omp
    from repro_torch.core import kernel_lower
    from repro_torch.kernels import span_kernel

    mesh = omp.make_mesh((2,), ("data",), device="cpu")
    calls = []
    monkeypatch.setattr(span_kernel, "span_values_plain_stages",
                        lambda *a: calls.append("plain") or [{}])
    monkeypatch.setattr(span_kernel, "launch_span",
                        lambda *a, **k: calls.append("launch") or [{}])

    def stages(comp, prog, slabs, repl):
        return [kernel_lower.SpanStage(plan=comp.plan, program=prog,
                                       ext_windows=slabs, env_repl=repl)]

    prog, env = td.make_case(5, "map")[:2]
    comp = omp.compile(prog, mesh, lowering="kernel", env_like=env)
    source = comp.kernel_plan.spans[0].source
    repl, slabs = _span_inputs(comp, env)
    one = stages(comp, prog, slabs, repl)
    span_kernel.span_stage_values(one, source, "cpu")
    assert calls == ["plain"]
    with pytest.raises(ValueError, match="lie on cpu"):
        span_kernel.span_stage_values(one, source, "cuda")

    # the put family reads no env: its span has no input tensors at all
    prog, env = td.make_case(5, "put")[:2]
    comp = omp.compile(prog, mesh, lowering="kernel", env_like=env)
    source = comp.kernel_plan.spans[0].source
    assert source.inputs == ()
    empty = stages(comp, prog, {}, {})
    span_kernel.span_stage_values(empty, source, "cuda")
    assert calls == ["plain", "launch"]
    with pytest.raises(ValueError, match="CUDA"):
        span_kernel.span_stage_values(empty, source, "meta")
    with pytest.raises(ValueError, match="lowering='kernel'"):
        span_kernel.span_stage_values(empty, None, "cuda")
    assert calls == ["plain", "launch"]


# ---------------------------------------------------------------------------
# K1 over a span of several region stages
# ---------------------------------------------------------------------------


def _forwarding_regions():
    """Regions whose stages fuse into multi-stage spans: a partial-write
    chain whose stages start at different iterations and forward a
    per-lane vector (read whole and at a constant index), and a rank-2
    chain (one span each); plus the region families' twins."""
    from repro_torch import omp

    n = 23

    @omp.parallel_for(stop=n - 2, name="f1")
    def f1(i, env):
        return {"u": omp.at(i + 1, env["x"][i + 1] * 2.0 - 0.5)}

    @omp.parallel_for(start=1, stop=n - 1, name="f2")
    def f2(i, env):
        return {"V": omp.at(i, env["u"][i] * env["w"] + env["x"][i])}

    @omp.parallel_for(start=1, stop=n - 1, reduction={"s": "+"}, name="f3")
    def f3(i, env):
        v = env["V"][i]
        return {"y": omp.at(i, v[0] - v.sum() + env["u"][i]),
                "s": omp.red(v[-1] * env["u"][i])}

    g = np.random.default_rng(5)
    env1 = {"x": torch.tensor(g.standard_normal(n).astype(np.float32)),
            "w": torch.tensor([0.5, -1.0, 2.0]), "u": torch.zeros(n),
            "V": torch.zeros(n, 3), "y": torch.zeros(n),
            "s": torch.tensor(1.0)}

    @omp.parallel_for(stop=(7, 9), collapse=2, name="r1")
    def r1(i, j, env):
        return {"t": omp.at((i, j), env["x"][i, j] * 2.0)}

    @omp.parallel_for(stop=(7, 9), collapse=2, reduction={"m": "max"},
                      name="r2")
    def r2(i, j, env):
        return {"y": omp.at((i, j), env["t"][i, j] + 1.0),
                "m": omp.red(env["t"][i, j])}

    env2 = {"x": torch.tensor(g.standard_normal((7, 9)).astype(np.float32)),
            "t": torch.zeros(7, 9), "y": torch.zeros(7, 9)}
    return [(omp.region(f1, f2, f3, name="fwd"), env1, ("data",)),
            (omp.region(r1, r2, name="fwd2"), env2, ("i", "j"))]


def _span_calls(prog, env, mesh, monkeypatch):
    """Run ``prog`` under the kernel lowering on the CPU, recording every
    span's stage feeds as the fused executor hands them over."""
    from repro_torch import omp
    from repro_torch.kernels import span_kernel

    calls = []
    wrapper = span_kernel.span_stage_values

    def spy(stages, source, device, window=None):
        calls.append((list(stages), source))
        return wrapper(stages, source, device, window=window)

    monkeypatch.setattr(span_kernel, "span_stage_values", spy)
    comp = omp.compile(prog, mesh, lowering="kernel")
    ref = prog(env)
    out = comp(env)
    for k in ref:
        np.testing.assert_allclose(out[k].numpy(), ref[k].numpy(),
                                   rtol=1e-4, atol=1e-4)
    return comp, calls


def _check_span_calls(comp, calls):
    """The generated multi-stage source, emulated, equals the plain
    multi-stage version on every stage's lanes that hold an iteration."""
    from repro_torch.core import kernel_lower
    from repro_torch.kernels import span_kernel

    assert [len(st) for st, _ in calls] == [
        len(s.stage_indices) for s in comp.kernel_plan.spans]
    for stages, source in calls:
        got = emulate_span(source, [(st.ext_windows, st.env_repl)
                                    for st in stages], fill=float("nan"))
        want = span_kernel.span_values_plain_stages(stages, "cpu")
        tol = REDUCING if "tl.sum(" in source.text else POINTWISE
        for st, g, w in zip(stages, got, want):
            mask = kernel_lower.lane_mask(st.plan, "cpu")
            assert set(g) == set(w)
            for k in w:
                np.testing.assert_allclose(g[k][mask].numpy(),
                                           w[k][mask].numpy(), **tol,
                                           err_msg=f"{st.plan.name} {k}")


GENERATED_MULTI_STAGE_SPAN_MATCHES_PLAIN_P = [1, 3]


def generated_multi_stage_span_matches_plain(p, monkeypatch):
    """Forwarded tiles (scalar and per-lane vector values, partial
    writes, stages starting at different iterations, rank 2): one
    generated kernel per span, equal to the stages' plain values."""
    from repro_torch import omp

    for prog, env, axes in _forwarding_regions():
        shape = (p,) if len(axes) == 1 else (p, 2)
        comp, calls = _span_calls(
            prog, env, omp.make_mesh(shape, axes, device="cpu"), monkeypatch)
        (span,) = comp.kernel_plan.spans
        assert len(span.stage_indices) == len(prog.stages)
        fwd = {"fwd": {(1, "u"), (2, "V"), (2, "u")},
               "fwd2": {(1, "t")}}[prog.name]
        assert set(span.source.forwarded) == fwd
        _check_span_calls(comp, calls)


GENERATED_REGION_FAMILY_SPANS_MATCH_PLAIN_FAMILY = [
    "chain", "pingpong", "glue", "heat2d", "transpose2"]


def generated_region_family_spans_match_plain(family, monkeypatch):
    from repro_torch import omp
    from tests import test_torch_region as tr

    for p in (1, 2):
        (prog, env, *_), shape, axes = tr._case(family, p, 70 + p)
        comp, calls = _span_calls(
            prog, env, omp.make_mesh(shape, axes, device="cpu"), monkeypatch)
        _check_span_calls(comp, calls)


def test_forwarded_read_of_another_lane_raises_compile_error():
    """A stage that reads a forwarded key one row off its own lane cannot
    take the register tile: the generator refuses it at compile time."""
    from repro_torch import omp
    from repro_torch.core.region import plan_region
    from repro_torch.kernels import span_kernel

    @omp.parallel_for(stop=9, name="a1")
    def a1(i, env):
        return {"tmp": omp.at(i, env["x"][i] * 2.0)}

    @omp.parallel_for(stop=9, name="a2")
    def a2(i, env):
        return {"y": omp.at(i, env["tmp"][i + 1])}

    @omp.parallel_for(stop=8, name="a4")
    def a4(i, env):
        return {"y": omp.at(i, env["tmp"][i])}

    env = {"x": torch.arange(10.0), "tmp": torch.zeros(10),
           "y": torch.zeros(10)}
    rp = plan_region(omp.region(a1, a2), env, 1)
    plans = [se.plan for se in rp.stages]
    with pytest.raises(omp.CompileError, match="lane's own row"):
        span_kernel.generate_span([(plans[0], a1, ()),
                                   (plans[1], a2, ("tmp",))])
    # nor do stages of another geometry share a launch
    plan4 = plan_region(omp.region(a1, a4), env, 1).stages[1].plan
    with pytest.raises(omp.CompileError, match="chunk geometry"):
        span_kernel.generate_span([(plans[0], a1, ()),
                                   (plan4, a4, ("tmp",))])
    # the lane's own row is forwarded
    @omp.parallel_for(stop=9, name="a3")
    def a3(i, env):
        return {"y": omp.at(i, env["tmp"][i] + 1.0)}

    plan3 = plan_region(omp.region(a1, a3), env, 1).stages[1].plan
    src = span_kernel.generate_span([(plans[0], a1, ()),
                                     (plan3, a3, ("tmp",))])
    assert src.forwarded == ((1, "tmp"),)
