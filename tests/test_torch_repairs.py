"""Programs the reference runs and K1's template once refused, held
against the JAX package on the CPU.

The reference's Pallas lowering refuses no op, so each body below is
written once for both packages (``o`` the ``omp`` facade, ``lib`` torch
or ``jax.numpy``) and run on an env drawn from a numpy seed:

* ``cumsum`` along a per-lane row, of a loaded and of a computed row,
  consumed whole, rolled, by a product, reduced and at one position, on
  rank-1 and rank-2 nests;
* ``roll`` of a lane scalar (a 0-d roll is the identity in both
  packages; ``vmap``'s batching rule rolls it across the lanes);
* ``roll`` of a row an earlier stage of the same span hands over in one
  register tile (the later stage emits the producer's value again at the
  wrapped positions).

Each compiles under ``lowering="kernel"``; the port's shared-memory run
and its kernel and collective lowerings on 1 and 2 ranks equal the
reference's ``run_reference`` (or the region's shared-memory run) and,
on one rank,
its ``lowering="pallas"`` (interpret mode), at rtol = atol = 1e-4; the
generated K1 source, under the NumPy emulation of ``triton.language``
(``tests/test_torch_span_kernel.py``), equals the plain version — also
with the register-tile cap lowered, so that a scan's running sum is
carried from tile to tile.

The repairs of scans, sort indices and integer pow, and of the
one-column and integer products, are in
``tests/test_torch_repairs_scan.py`` and
``tests/test_torch_repairs_products.py``, which use this file's bodies
and checks.
"""
import re

import numpy as np
import pytest
import torch

from tests import test_torch_span_kernel as tsk

TOL = dict(rtol=1e-4, atol=1e-4)


def _cumsum_bodies(o, lib):
    @o.parallel_for(start=1, stop=22, reduction={"s": "+"}, name="cs1")
    def cs1(i, env):
        row = env["A"][i]
        c = lib.cumsum(row, 0)
        d = lib.cumsum(2.0 * row - env["w"], 0)
        return {"Y": o.at(i, c - lib.roll(d, 2)), "P": o.at(i, c @ env["M"]),
                "s": o.red(c[3] + d.sum())}

    @o.parallel_for(stop=(5, 6), collapse=2, name="cs2")
    def cs2(i, j, env):
        v = lib.cumsum(env["A"][i] * env["B"][j], 0)
        return {"Z": o.at((i, j), v + lib.cumsum(env["A"][j], 0)),
                "T": o.at((i, j), (v * env["w"]).sum())}
    return cs1, cs2


def _rolled_scan_body(o, lib):
    @o.parallel_for(stop=21, reduction={"s": "+"}, name="rs1")
    def rs1(i, env):
        row = env["A"][i]
        c = lib.cumsum(row, 0)
        return {"Y": o.at(i, lib.roll(c, 3)
                          - lib.roll(lib.cumsum(row * env["w"], 0), -1)),
                "s": o.red(lib.roll(c, 2)[0])}
    return rs1


def _lane_roll_bodies(o, lib):
    @o.parallel_for(stop=6, name="rl1")
    def rl1(i, env):
        return {"y": o.at(i, lib.roll(env["x"][i], 1) * 2.0)}

    @o.parallel_for(stop=(3, 4), collapse=2, name="rl2")
    def rl2(i, j, env):
        return {"z": o.at((i, j), lib.roll(env["X"][i, j], 1)
                          + env["X"][i, j])}
    return rl1, rl2


def _forward_roll_regions(o, lib):
    @o.parallel_for(stop=9, name="w1")
    def w1(i, env):
        return {"V": o.at(i, env["X"][i] * 2.0)}

    @o.parallel_for(stop=9, name="w2")
    def w2(i, env):
        return {"y": o.at(i, lib.roll(env["V"][i], 1).sum())}

    @o.parallel_for(stop=9, name="w3")
    def w3(i, env):
        return {"Z": o.at(i, lib.roll(env["V"][i], 2) - env["V"][i]
                          * env["w"])}
    return (o.region(w1, w2, name="rollfwd"),
            o.region(w1, w3, name="rollfwd2"))


def _normal(g, *shape):
    return g.standard_normal(shape).astype(np.float32)


def _cumsum_envs():
    g = np.random.default_rng(19)
    n = 19
    return ({"A": _normal(g, 23, n), "w": _normal(g, n), "M": _normal(g, n, n),
             "Y": np.zeros((23, n), np.float32),
             "P": np.zeros((23, n), np.float32),
             "s": np.zeros((), np.float32)},
            {"A": _normal(g, 6, n), "B": _normal(g, 6, n), "w": _normal(g, n),
             "Z": np.zeros((5, 6, n), np.float32),
             "T": np.zeros((5, 6), np.float32)})


def _rolled_scan_env():
    g = np.random.default_rng(22)
    return {"A": _normal(g, 21, 19), "w": _normal(g, 19),
            "Y": np.zeros((21, 19), np.float32), "s": np.zeros((), np.float32)}


def _lane_roll_envs():
    g = np.random.default_rng(20)
    return ({"x": _normal(g, 6), "y": np.zeros(6, np.float32)},
            {"X": _normal(g, 3, 4), "z": np.zeros((3, 4), np.float32)})


def _forward_roll_env():
    g = np.random.default_rng(21)
    return {"X": _normal(g, 9, 4), "V": np.zeros((9, 4), np.float32),
            "y": np.zeros(9, np.float32), "Z": np.zeros((9, 4), np.float32),
            "w": _normal(g, 4)}


def _jax_block(prog, env_np, pallas=False):
    """The reference's ``run_reference`` of a block, or its Pallas
    lowering (interpret mode) on a one-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro import omp as jomp
    from repro.compat import make_mesh as jmake_mesh
    from repro.core import transform as jt

    env = {k: jnp.asarray(v) for k, v in env_np.items()}
    if not pallas:
        out = jax.jit(lambda e: jt.run_reference(prog, e))(env)
    else:
        mesh = (Mesh(np.asarray(jax.devices()[:1]), ("data",))
                if prog.rank == 1 else jmake_mesh((1, 1), ("i", "j")))
        comp = jomp.compile(prog, mesh, lowering="pallas")
        out = jax.jit(lambda e: comp(e))(env)
    return {k: np.asarray(v) for k, v in out.items()}


def _assert_env(got, want, label):
    from repro_torch import convert

    got = convert.env_to_numpy(got)
    assert set(got) == set(want), label
    for k in want:
        if np.issubdtype(np.asarray(want[k]).dtype, np.integer):
            # indices and wrapped integer products: bit for bit
            np.testing.assert_array_equal(got[k], want[k],
                                          err_msg=f"{label} key={k!r}")
            continue
        np.testing.assert_allclose(got[k], want[k], **TOL,
                                   err_msg=f"{label} key={k!r}")


def _mesh(rank, p):
    from repro_torch import omp

    shape, axes = ((p,), ("data",)) if rank == 1 else ((p, 1), ("i", "j"))
    return omp.make_mesh(shape, axes, device="cpu"), shape, axes


def _check_block(prog, jprog, env_np):
    """Both block lowerings on 1 and 2 ranks == the reference's
    ``run_reference``; the kernel lowering on one rank == its Pallas
    lowering; the generated source, emulated, == the plain version."""
    from repro_torch import convert, omp

    env = convert.env_from_numpy(env_np, "cpu")
    want = _jax_block(jprog, env_np)
    _assert_env(prog(env), want, f"{prog.name} shared memory")
    for p in (1, 2):
        mesh, shape, axes = _mesh(prog.rank, p)
        for lowering in ("collective", "kernel"):
            _assert_env(omp.compile(prog, mesh, lowering=lowering,
                                    env_like=env)(env), want,
                        f"{prog.name} P={p} {lowering}")
        tsk._check_family((prog, env), shape, axes, "replicate")
    _assert_env(omp.compile(prog, _mesh(prog.rank, 1)[0],
                            lowering="kernel")(env),
                _jax_block(jprog, env_np, pallas=True),
                f"{prog.name} kernel-vs-pallas")


CUMSUM_ALONG_A_ROW_MATCHES_REFERENCE_RANK = [1, 2]


def cumsum_along_a_row_matches_reference(rank, monkeypatch):
    """``aten.cumsum`` along a per-lane row compiles to ``tl.cumsum``
    over the row's register tile, summed in float32; with the register-
    tile cap lowered to 16 the row is swept tile by tile and the running
    sum carried between tiles (a store's loop, a product's K loop, a
    reduction's pass); the grid's value tile scans its own positions from
    the sum of those before it, a rolled read there in two segments, and
    only one position takes the sum of the positions at or before it."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import convert, omp
    from repro_torch.kernels import span_kernel

    prog = _cumsum_bodies(omp, torch)[rank - 1]
    jprog = _cumsum_bodies(jomp, jnp)[rank - 1]
    env_np = _cumsum_envs()[rank - 1]
    _check_block(prog, jprog, env_np)
    env = convert.env_from_numpy(env_np, "cpu")
    monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", 16)
    omp.clear_compile_cache()           # compiles are cached by structure
    text = omp.compile(prog, _mesh(rank, 2)[0], lowering="kernel",
                       env_like=env).kernel_plan.spans[0].source.text
    # carries (rank 1: also one position, summed over the positions at or
    # before it; the rolled read in the grid's value tile scans)
    assert "tl.cumsum(" in text and text.count("axis=2") == (rank == 1), text
    assert text.count(" = tl.zeros([") > text.count("acc"), text
    for p in (1, 2):
        _, shape, axes = _mesh(rank, p)
        tsk._check_family((prog, env), shape, axes, "replicate")


ROLL_OF_A_SCAN_MATCHES_REFERENCE_CAP = [None, 16]


def roll_of_a_scan_matches_reference(cap, monkeypatch):
    """``roll(cumsum(row), s)`` scans the rolled row once, in two
    segments (positions below ``s`` continue from the sum of the row
    before ``k - s``): in the whole row's tile, and, with the register-
    tile cap lowered to 16, in a store's loop with both segments carried
    from tile to tile.  Only the one position read of a tiled rolled scan
    sums the positions at or before it."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import convert, omp
    from repro_torch.kernels import span_kernel

    prog = _rolled_scan_body(omp, torch)
    env_np = _rolled_scan_env()
    if cap is not None:
        monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", cap)
        omp.clear_compile_cache()       # compiles are cached by structure
    _check_block(prog, _rolled_scan_body(jomp, jnp), env_np)
    env = convert.env_from_numpy(env_np, "cpu")
    text = omp.compile(prog, _mesh(1, 2)[0], lowering="kernel",
                       env_like=env).kernel_plan.spans[0].source.text
    # the one position is read from the whole tile where the row fits
    assert text.count("tl.cumsum(") >= 4, text
    assert text.count("axis=2") == (cap is not None), text
    if cap is not None:                 # the two segments' carries
        assert sum(line.strip().startswith("c") and " + tl.sum(" in line
                   for line in text.splitlines()) >= 4, text
    omp.clear_compile_cache()


def test_product_span_ring_fits_shared_memory(monkeypatch):
    """The generator fits a product span's operand ring (``[lanes, BK]``
    and ``[BK, N]`` tiles a stage) to ``_SMEM_BYTES`` at ``_DOT_STAGES``
    stages by halving its K tile, down to 16; the depth stays."""
    from repro_torch import convert, omp
    from repro_torch.kernels import span_kernel

    env = convert.env_from_numpy(_cumsum_envs()[0], "cpu")
    prog = _cumsum_bodies(omp, torch)[0]

    def source():
        omp.clear_compile_cache()       # compiles are cached by structure
        return omp.compile(prog, _mesh(1, 2)[0], lowering="kernel",
                           env_like=env).kernel_plan.spans[0].source

    def k_tile(src):
        return int(re.search(r"tl\.broadcast_to\(\w+, \[16, (\d+)\]\)",
                             src.text).group(1))

    # 16 lanes and a 32-wide output tile of float32: 192 B a K position
    stage = (16 + 32) * 4
    assert (k_tile(source()), source().num_stages) == (32, 3)
    for budget, bk in ((3 * stage * 32, 32), (3 * stage * 32 - 1, 16),
                       (3 * stage * 16 - 1, 16)):
        monkeypatch.setattr(span_kernel, "_SMEM_BYTES", budget)
        src = source()
        assert (k_tile(src), src.num_stages) == (bk, 3), budget
        # the tiles are what the emulation runs: still the plain values
        tsk._check_family((prog, env), (2,), ("data",), "replicate")
    omp.clear_compile_cache()


def test_roll_of_a_lane_scalar_is_the_identity():
    """``torch.roll`` of a lane scalar (0-d per lane) is the identity, as
    ``jnp.roll`` of a 0-d value is; vmap's batching rule rolls it across
    the lanes, so the port evaluates every body (its shared-memory run,
    the plain lane values, the kernel's trace) with a 0-d roll taken as
    the identity: the kernel emits no roll."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import convert, omp

    for prog, jprog, env_np in zip(_lane_roll_bodies(omp, torch),
                                   _lane_roll_bodies(jomp, jnp),
                                   _lane_roll_envs()):
        _check_block(prog, jprog, env_np)
        env = convert.env_from_numpy(env_np, "cpu")
        comp = omp.compile(prog, _mesh(prog.rank, 2)[0], lowering="kernel",
                           env_like=env)
        body = comp.kernel_plan.spans[0].source.text.split("# stage 0")[1]
        assert "%" not in body, body
        src = env["x"] if prog.rank == 1 else env["X"]
        key = "y" if prog.rank == 1 else "z"
        np.testing.assert_allclose(comp(env)[key].numpy(),
                                   (2.0 * src).numpy(), rtol=1e-6)


ROLL_OF_A_FORWARDED_REGISTER_TILE_MATCHES_REFERENCE_P = [1, 2]


def roll_of_a_forwarded_register_tile_matches_reference(p,
                                                             monkeypatch):
    """A stage that rolls a row the stage before it in the same span
    stored in one register tile (``V``, forwarded): the kernel emits the
    producer's value again at the wrapped positions.  One span, ``V``
    forwarded; the emulated source == the stages' plain values; the
    kernel lowering == the reference's shared-memory run and, on one
    rank, its Pallas lowering."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro import omp as jomp
    from repro_torch import convert, omp

    env_np = _forward_roll_env()
    env = convert.env_from_numpy(env_np, "cpu")
    jenv = {k: jnp.asarray(v) for k, v in env_np.items()}
    for reg, jreg in zip(_forward_roll_regions(omp, torch),
                         _forward_roll_regions(jomp, jnp)):
        keys = sorted(jreg(jenv))
        want = {k: np.asarray(v) for k, v in jax.jit(
            lambda e: jreg(e))(jenv).items()}
        comp, calls = tsk._span_calls(reg, env, _mesh(1, p)[0], monkeypatch)
        (span,) = comp.kernel_plan.spans
        assert (1, "V") in span.source.forwarded, span.source.forwarded
        # the later stage reads the wrapped positions of the producer's row
        assert "%" in span.source.text.split("# stage 1")[1]
        tsk._check_span_calls(comp, calls)
        _assert_env({k: v for k, v in comp(env).items() if k in keys},
                    want, f"{reg.name} P={p}")
        if p == 1:
            pal = jomp.compile(jreg, Mesh(np.asarray(jax.devices()[:1]),
                                          ("data",)), lowering="pallas")
            _assert_env(comp(env), {k: np.asarray(v) for k, v in jax.jit(
                lambda e: pal(e))(jenv).items()}, f"{reg.name} vs pallas")


# ---------------------------------------------------------------------------
# The template's former refusals: pointwise math, cumprod, gathers through
# a per-lane index vector, sorts, a row handed over tile by tile
# ---------------------------------------------------------------------------


def _fns(lib):
    """The ops each package spells its own way."""
    if lib is torch:
        return dict(sigmoid=torch.sigmoid, rsqrt=torch.rsqrt, erf=torch.erf,
                    clip=torch.clamp, clip_min=torch.clamp_min,
                    clip_max=torch.clamp_max, pow=torch.pow,
                    sort=lambda x, desc=False: torch.sort(
                        x, descending=desc).values)
    import jax

    return dict(sigmoid=jax.nn.sigmoid, rsqrt=jax.lax.rsqrt,
                erf=jax.scipy.special.erf, clip=lib.clip,
                clip_min=lib.maximum, clip_max=lib.minimum, pow=lib.power,
                sort=lambda x, desc=False: (lib.sort(x)[::-1] if desc
                                            else lib.sort(x)))


def _math_body(o, lib):
    f = _fns(lib)

    @o.parallel_for(stop=21, reduction={"s": "+"}, name="pm1")
    def pm1(i, env):
        x, r = env["x"][i], env["R"][i]
        a = (lib.sin(r) + lib.cos(x) * lib.tan(0.5 * r) + lib.tanh(r)
             + f["sigmoid"](r) + f["rsqrt"](lib.abs(r) + 1.0) + f["erf"](r))
        b = (f["pow"](r, 3.0) + r ** 2 + f["pow"](lib.abs(r) + 0.5, x)
             + f["pow"](2.0, r) + lib.floor(3.0 * r) + lib.ceil(3.0 * r)
             + lib.round(2.0 * r) + lib.sign(r))
        c = (f["clip"](r, -0.5, 0.5) + f["clip_min"](r, 0.1)
             + f["clip_max"](r, 0.2) + lib.log1p(lib.abs(r))
             + lib.expm1(0.5 * r))
        return {"Y": o.at(i, a + b * c), "s": o.red(lib.tanh(x) * x)}
    return pm1


def _nan_body(o, lib):
    f = _fns(lib)

    @o.parallel_for(stop=13, name="cn1")
    def cn1(i, env):
        r, w = env["R"][i], env["w"]
        return {"Y": o.at(i, f["clip"](r, -0.5, 0.5) + f["clip_min"](r, 0.1)
                          + f["clip_max"](r, 0.2) + lib.maximum(r, w)
                          + lib.minimum(w, r))}
    return cn1


def _cumprod_body(o, lib):
    @o.parallel_for(start=1, stop=22, reduction={"s": "+"}, name="cp1")
    def cp1(i, env):
        row = env["A"][i]
        c = lib.cumprod(row, 0)
        return {"Y": o.at(i, c - lib.roll(lib.cumprod(row * env["w"], 0), 2)),
                "P": o.at(i, c @ env["M"]),
                "s": o.red(c[3] + lib.roll(c, -1)[0] + c.sum())}
    return cp1


def _gather_body(o, lib):
    @o.parallel_for(stop=17, name="ga1")
    def ga1(i, env):
        g = env["x"][env["I"][i]]
        return {"Y": o.at(i, g * 2.0 + env["x"][env["I"][i] - 3]),
                "y": o.at(i, g.sum())}
    return ga1


def _sort_body(o, lib):
    f = _fns(lib)

    @o.parallel_for(stop=(5, 6), collapse=2, name="so2")
    def so2(i, j, env):
        s = f["sort"](env["A"][i] * env["B"][j])
        return {"Z": o.at((i, j), s - f["sort"](env["B"][j], True)),
                "T": o.at((i, j), s[0] + s[-1])}
    return so2


def _handoff_region(o, lib, lag=0):
    @o.parallel_for(stop=9, name="h1")
    def h1(i, env):
        return {"V": o.at(i, env["X"][i] * 2.0 + env["w"])}

    @o.parallel_for(stop=9, name="h2")
    def h2(i, env):
        v = env["V"][i + lag]
        return {"y": o.at(i, v.sum() + v[3]), "Z": o.at(i, v * env["w"])}
    return o.region(h1, h2, name=f"handoff{lag}")


def _math_env():
    g = np.random.default_rng(30)
    return {"x": _normal(g, 21), "R": _normal(g, 21, 19),
            "Y": np.zeros((21, 19), np.float32), "s": np.zeros((), np.float32)}


def _nan_env():
    g = np.random.default_rng(35)
    r, w = _normal(g, 13, 19), _normal(g, 19)
    r[g.random((13, 19)) < 0.2] = np.nan     # NaN on either side
    w[::5] = np.nan
    return {"R": r, "w": w, "Y": np.zeros((13, 19), np.float32)}


def _cumprod_env():
    g = np.random.default_rng(31)
    n = 19
    return {"A": (1.0 + 0.1 * _normal(g, 23, n)).astype(np.float32),
            "w": (1.0 + 0.1 * _normal(g, n)).astype(np.float32),
            "M": _normal(g, n, n), "Y": np.zeros((23, n), np.float32),
            "P": np.zeros((23, n), np.float32), "s": np.zeros((), np.float32)}


def _gather_env():
    g = np.random.default_rng(32)
    # in range, negative (wrapping once) and out of range either way
    idx = g.integers(-30, 30, size=(17, 9)).astype(np.int32)
    return {"x": _normal(g, 12), "I": idx, "Y": np.zeros((17, 9), np.float32),
            "y": np.zeros(17, np.float32)}


def _sort_env():
    g = np.random.default_rng(33)
    return {"A": _normal(g, 6, 21), "B": _normal(g, 6, 21),
            "Z": np.zeros((5, 6, 21), np.float32),
            "T": np.zeros((5, 6), np.float32)}


def _handoff_env():
    g = np.random.default_rng(34)
    return {"X": _normal(g, 10, 40), "w": _normal(g, 40),
            "V": np.zeros((10, 40), np.float32), "y": np.zeros(10, np.float32),
            "Z": np.zeros((10, 40), np.float32)}


def _text(prog, env, rank=1):
    from repro_torch import omp

    omp.clear_compile_cache()           # compiles are cached by structure
    return omp.compile(prog, _mesh(rank, 2)[0], lowering="kernel",
                       env_like=env).kernel_plan.spans[0].source.text


FORMER_REFUSALS_MATCH_REFERENCE_CAP = [None, 16]
FORMER_REFUSALS_MATCH_REFERENCE_BODY = ["math", "nan", "cumprod", "gather",
                                  "sort"]


def former_refusals_match_reference(body, cap, monkeypatch):
    """Pointwise math (Triton's functions and libdevice's; a NaN clamped
    or through ``maximum``/``minimum`` stays NaN), ``cumprod``
    along a row (whole, carried from tile to tile, rolled, in the grid's
    value tile, at one position), a gather through a per-lane index vector
    with negative and out-of-range entries (wrap once, then clamp) and the
    values of a sort (ascending and descending, rank 2) compile under the
    kernel lowering and equal the reference's ``run_reference`` and its
    Pallas lowering; the emulated source equals the plain version, also
    with the register-tile cap lowered to 16."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import convert, omp
    from repro_torch.kernels import span_kernel

    make, env_np = {"math": (_math_body, _math_env),
                    "nan": (_nan_body, _nan_env),
                    "cumprod": (_cumprod_body, _cumprod_env),
                    "gather": (_gather_body, _gather_env),
                    "sort": (_sort_body, _sort_env)}[body]
    env_np = env_np()
    prog, jprog = make(omp, torch), make(jomp, jnp)
    if cap is not None:
        if body == "sort":          # a row longer than one register tile
            monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", cap)
            env = convert.env_from_numpy(env_np, "cpu")
            with pytest.raises(omp.CompileError, match="aten.sort .* 21 "
                               "elements, longer than one register tile"):
                _text(prog, env, 2)
            omp.clear_compile_cache()
            return
        monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", cap)
    omp.clear_compile_cache()
    _check_block(prog, jprog, env_np)
    text = _text(prog, convert.env_from_numpy(env_np, "cpu"), prog.rank)
    marks = {"math": ("libdevice.pow(", "tl.sin(", "libdevice.rint("),
             "nan": ("tl.PropagateNan.ALL",),
             "cumprod": ("tl.cumprod(",),
             "gather": ("tl.where(",),
             "sort": ("tl.sort(",)}[body]
    assert all(m in text for m in marks), text
    if body == "math":
        assert "from triton.language.extra import libdevice" in text
    if body == "cumprod" and cap is not None:   # carried products
        assert sum(" * tl.sum(tl.where(tl.arange(" in line
                   for line in text.splitlines()) >= 2, text
    omp.clear_compile_cache()


def test_sort_indices_stay_refused_naming_themselves(monkeypatch):
    """The indices of a sort of a row held in one register tile compile
    and equal the reference's ``jnp.argsort`` (ties kept in order); what
    stays refused names itself: the indices of a row longer than one
    register tile, the indices of ``cummax``/``cummin`` (no ``jnp`` twin),
    and an integer ``pow`` by a tensor exponent."""
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import convert, omp
    from repro_torch.kernels import span_kernel

    def body(o, lib):
        @o.parallel_for(stop=5, name="si1")
        def si1(i, env):
            return {"Y": o.at(i, _scan_fns(lib)["argsort"](env["A"][i]))}
        return si1

    env_np = {"A": np.tile(np.asarray([2.0, 1.0, 2.0, 1.0], np.float32),
                           (5, 1)), "Y": np.zeros((5, 4), np.int32)}
    env = convert.env_from_numpy(env_np, "cpu")
    got = omp.compile(body(omp, torch), _mesh(1, 2)[0], lowering="kernel")(
        env)["Y"].numpy()
    np.testing.assert_array_equal(got, _jax_block(body(jomp, jnp),
                                                  env_np)["Y"])
    np.testing.assert_array_equal(got, np.tile([1, 3, 0, 2], (5, 1)))

    @omp.parallel_for(stop=5, name="ci1")
    def ci1(i, env):
        return {"Y": omp.at(i, torch.cummin(env["A"][i], 0).indices)}

    @omp.parallel_for(stop=5, name="tp1")
    def tp1(i, env):
        k = env["A"][i].to(torch.int32)
        return {"Y": omp.at(i, k ** k)}

    for prog, match in ((ci1, "aten.cummin.default's indices"),
                        (tp1, "of integers with a tensor exponent")):
        omp.clear_compile_cache()
        with pytest.raises(omp.CompileError, match=match):
            omp.compile(prog, _mesh(1, 2)[0], lowering="kernel",
                        env_like=env)
    monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", 16)
    omp.clear_compile_cache()
    with pytest.raises(omp.CompileError, match="aten.sort .* 21 elements, "
                       "longer than one register tile"):
        omp.compile(body(omp, torch), _mesh(1, 2)[0], lowering="kernel",
                    env_like={"A": torch.zeros(5, 21),
                              "Y": torch.zeros(5, 21, dtype=torch.int32)})
    omp.clear_compile_cache()


ROW_HANDED_OVER_TILE_BY_TILE_MATCHES_REFERENCE_P = [1, 2]


def row_handed_over_tile_by_tile_matches_reference(p, monkeypatch):
    """A later span stage reads a row an earlier stage stored tile by tile
    (the register-tile cap lowered to 16, rows of 40): it re-loads the
    lane's own stored rows after a block-wide barrier.  One span, the key
    forwarded; the emulated source == the stages' plain values; the kernel
    lowering == the reference's shared-memory run and, on one rank, its
    Pallas lowering.  A read of the next lane's row is still refused."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro import omp as jomp
    from repro_torch import convert, omp
    from repro_torch.core.region import plan_region
    from repro_torch.kernels import span_kernel

    monkeypatch.setattr(span_kernel, "_MAX_TILE_ELEMS", 16)
    omp.clear_compile_cache()
    env_np = _handoff_env()
    env = convert.env_from_numpy(env_np, "cpu")
    jenv = {k: jnp.asarray(v) for k, v in env_np.items()}
    reg, jreg = _handoff_region(omp, torch), _handoff_region(jomp, jnp)
    want = {k: np.asarray(v) for k, v in jax.jit(
        lambda e: jreg(e))(jenv).items()}
    comp, calls = tsk._span_calls(reg, env, _mesh(1, p)[0], monkeypatch)
    (span,) = comp.kernel_plan.spans
    assert (1, "V") in span.source.forwarded, span.source.forwarded
    later = span.source.text.split("# stage 1")[1]
    assert later.count("tl.debug_barrier()") == 1, later
    tsk._check_span_calls(comp, calls)
    _assert_env(comp(env), want, f"handoff P={p}")
    if p == 1:
        pal = jomp.compile(jreg, Mesh(np.asarray(jax.devices()[:1]),
                                      ("data",)), lowering="pallas")
        _assert_env(comp(env), {k: np.asarray(v) for k, v in jax.jit(
            lambda e: pal(e))(jenv).items()}, "handoff vs pallas")
    lagged = _handoff_region(omp, torch, lag=1)
    plans = [se.plan for se in plan_region(lagged, env, 1).stages]
    with pytest.raises(omp.CompileError, match="lane's own row"):
        span_kernel.generate_span([(plans[0], lagged.stages[0], ()),
                                   (plans[1], lagged.stages[1], ("V",))])
    omp.clear_compile_cache()


# ---------------------------------------------------------------------------
# The ninth slice's repairs: associative scans (logcumsumexp, the values of
# cummax/cummin), the indices of a sort, an integer pow by a constant
# ---------------------------------------------------------------------------


def _scan_fns(lib):
    if lib is torch:
        return dict(lse=lambda x: torch.logcumsumexp(x, 0),
                    cummax=lambda x: torch.cummax(x, 0).values,
                    cummin=lambda x: torch.cummin(x, 0).values,
                    argsort=lambda x, desc=False: torch.argsort(
                        x, descending=desc))
    import jax

    return dict(lse=lambda x: jax.lax.cumlogsumexp(x, axis=0),
                cummax=lambda x: jax.lax.cummax(x, axis=0),
                cummin=lambda x: jax.lax.cummin(x, axis=0),
                argsort=lambda x, desc=False: lib.argsort(x,
                                                          descending=desc))


def _assoc_scan_body(o, lib):
    f = _scan_fns(lib)

    @o.parallel_for(start=1, stop=22, reduction={"s": "+"}, name="as1")
    def as1(i, env):
        b = env["B"][i]
        mx, mn = f["cummax"](b), f["cummin"](b * env["w"])
        ln = f["cummax"](env["N"][i]) - f["cummin"](env["N"][i])
        return {"Y": o.at(i, f["lse"](env["A"][i])),
                "Z": o.at(i, lib.roll(mx, 2) + mn - lib.roll(
                    f["lse"](b), -3)),
                "W": o.at(i, ln),
                "P": o.at(i, f["lse"](b) @ env["M"]),
                "s": o.red(mx[3] + lib.roll(mn, -1)[0] + f["lse"](b)[5])}
    return as1


def _argsort_body(o, lib):
    f = _scan_fns(lib)

    @o.parallel_for(stop=(5, 6), collapse=2, name="ag2")
    def ag2(i, j, env):
        row = env["A"][i] * env["B"][j]
        return {"I": o.at((i, j), f["argsort"](row)),
                "J": o.at((i, j), f["argsort"](env["K"][i] - env["L"][j],
                                               True)),
                "T": o.at((i, j), f["argsort"](env["B"][j], True)[0]
                          + f["argsort"](row)[-1])}
    return ag2


def _int_pow_body(o, lib):
    @o.parallel_for(stop=15, name="ip1")
    def ip1(i, env):
        k = env["K"][i]
        return {"Q": o.at(i, k ** 5 + k ** 0 - k ** 1 * k ** 2),
                "q": o.at(i, env["k"][i] ** 7 + (k ** 3).sum())}
    return ip1


def _assoc_scan_env():
    g = np.random.default_rng(36)
    n = 19
    a = _normal(g, 23, n)
    a[::4, 0] = -np.inf                 # -inf leading a row: -inf, not NaN
    a[1::5, 7] = -np.inf
    a[2::6, :3] = -np.inf
    nan = _normal(g, 23, n)
    nan[g.random((23, n)) < 0.1] = np.nan
    z = np.zeros((23, n), np.float32)
    return {"A": a, "B": _normal(g, 23, n), "N": nan, "w": _normal(g, n),
            "M": _normal(g, n, n), "Y": z, "Z": z, "W": z, "P": z,
            "s": np.zeros((), np.float32)}


def _argsort_env():
    g = np.random.default_rng(37)
    # few distinct values: many ties, signed zeros, and NaN
    a = g.integers(-2, 3, size=(6, 21)).astype(np.float32)
    b = g.integers(-1, 2, size=(6, 21)).astype(np.float32)
    a[1, ::4] = np.nan
    b[2, 3] = -0.0
    return {"A": a, "B": b,
            "K": g.integers(-3, 3, size=(6, 21)).astype(np.int32),
            "L": g.integers(-3, 3, size=(6, 21)).astype(np.int32),
            "I": np.zeros((5, 6, 21), np.int32),
            "J": np.zeros((5, 6, 21), np.int32),
            "T": np.zeros((5, 6), np.int32)}


def _int_pow_env():
    g = np.random.default_rng(38)
    # |k|^5 passes 2^31: the products wrap, as int32's do in both packages
    return {"K": g.integers(-400, 400, size=(15, 9)).astype(np.int32),
            "k": g.integers(-30, 30, size=15).astype(np.int32),
            "Q": np.zeros((15, 9), np.int32), "q": np.zeros(15, np.int32)}


# ---------------------------------------------------------------------------
# Products one position wide and products of integers (row sums)
# ---------------------------------------------------------------------------


def _one_column_body(o, lib):
    @o.parallel_for(start=1, stop=22, reduction={"s": "+"}, name="oc1")
    def oc1(i, env):
        row = env["A"][i]
        return {"Y": o.at(i, (row @ env["M"][:, 2:3]) * 2.0 + row @ env["V"]),
                "Z": o.at(i, lib.cumsum(row, 0) @ env["M"][:, -1:]),
                "W": o.at(i, (row @ env["M"])[3] - env["U"] @ row),
                "s": o.red((row @ env["V"]).sum())}
    return oc1


def _int_product_bodies(o, lib):
    def as_float(x):                # jnp.dot promotes; torch's @ wants a cast
        return x.float() if lib is torch else x

    @o.parallel_for(stop=15, name="ip2")
    def ip2(i, env):
        k = env["K"][i]
        return {"Q": o.at(i, k @ env["L"]),
                "q": o.at(i, k @ env["L"][:, 1] + (k * 3) @ env["L"][:, 2:3]),
                "F": o.at(i, env["A"][i] @ as_float(env["S"]))}

    @o.parallel_for(stop=(5, 6), collapse=2, name="ip3")
    def ip3(i, j, env):
        return {"T": o.at((i, j), env["K"][i] @ env["KT"][j])}
    return ip2, ip3


def _one_column_env():
    g = np.random.default_rng(39)
    n = 19
    z = np.zeros((23, 1), np.float32)
    return {"A": _normal(g, 23, n), "M": _normal(g, n, 5),
            "V": _normal(g, n, 1),
            "U": _normal(g, 1, n), "Y": z, "Z": z, "W": z,
            "s": np.zeros((), np.float32)}


def _int_product_env():
    g = np.random.default_rng(40)
    n = 19
    # |K L| passes 2^31: the products and their sums wrap in int32
    big = lambda *s: g.integers(-60000, 60000, size=s).astype(np.int32)
    return {"K": big(15, n), "L": big(n, 3), "KT": big(6, n),
            "A": _normal(g, 15, n),
            "S": g.integers(-5, 6, size=(n, 4)).astype(np.int32),
            "Q": np.zeros((15, 3), np.int32), "q": np.zeros((15, 1), np.int32),
            "F": np.zeros((15, 4), np.float32),
            "T": np.zeros((5, 6), np.int32)}


