"""The port's boundary communication — cost model, ``ppermute``, halo
emitters and payload packing — held against the JAX package and numpy.

* **Cost model**: on the cases of ``tests/test_comm.py`` the port's
  ``plan_boundary`` / ``plan_boundary2`` choose the reference's op with
  the reference's modeled bytes, hops, shift, alternatives and reason.
* **ppermute and halo exchanges** on the stacked-rank mesh equal a numpy
  ring on P = 2, 4 and 8 (and the 2-D meshes 2x1, 2x2, 4x2), for
  one-sided and two-sided halos, with and without a prior copy; the
  packed (aggregated) exchange equals the per-buffer one bit for bit in
  fewer launches and the same bytes.
* **Payload packing** round-trips mixed dtypes bit for bit.
"""
import dataclasses
import re

import numpy as np
import pytest
import torch

TYPES = ("float32", "bfloat16", "float16", "int32", "int8", "bool")


# ---------------------------------------------------------------------------
# The cost model against the reference
# ---------------------------------------------------------------------------


def _layouts(mod, c=8, p=8, n_loc=2, base=0, cover=None, has_prior=False):
    padded = n_loc * p * c
    return mod.SlabLayout(chunk=c, num_devices=p, local_chunks=n_loc,
                          padded_trip=padded, base=base,
                          cover=padded if cover is None else cover,
                          has_prior=has_prior)


def _chunks(sched_mod, lay):
    return sched_mod.ChunkPlan(
        trip_count=lay.cover, num_devices=lay.num_devices, chunk=lay.chunk,
        num_chunks=lay.local_chunks * lay.num_devices,
        local_chunks=lay.local_chunks, padded_trip=lay.padded_trip)


def _both(fn):
    """``fn(comm, schedule, spec)`` for the port and for the reference."""
    import jax
    import jax.numpy as jnp
    from repro.core import comm as jcomm, schedule as jsched
    from repro_torch.core import comm, schedule
    from repro_torch.core.context import TensorSpec

    mine = fn(comm, schedule,
              lambda shape: TensorSpec(tuple(shape), torch.float32))
    ref = fn(jcomm, jsched,
             lambda shape: jax.ShapeDtypeStruct(tuple(shape), jnp.float32))
    return mine, ref


def same_reason(text: str) -> str:
    """A boundary's reason, with the one wording the port words otherwise
    (the gather mode's baseline) brought to one form."""
    return re.sub(r"comm mode 'gather' pins the [^)]*baseline",
                  "comm mode 'gather' pins the baseline", text)


def _as_dict(bc):
    d = dataclasses.asdict(bc)
    d["alternatives"] = {k: dataclasses.asdict(v)
                         for k, v in bc.alternatives.items()}
    d["reason"] = same_reason(bc.reason)
    return d


# (layout kwargs, trip, n, plan kwargs) — the rank-1 cases of test_comm.py
CASES1 = [
    (dict(c=8, p=8, n_loc=2, has_prior=True), None, 257, dict(halo=(0, 1))),
    (dict(c=1, p=2, n_loc=4, has_prior=True), None, 9, dict(halo=(0, 1))),
    (dict(c=4, p=2, n_loc=2, has_prior=True), None, 19, dict(halo=(0, 3))),
    (dict(c=8, p=8, n_loc=2), None, 256, dict(halo=(0, 0))),
    (dict(c=8, p=8, n_loc=2, base=2, cover=100, has_prior=True), 100, 128,
     dict(halo=(2, 2))),
    (dict(c=8, p=8, n_loc=2), None, 256,
     dict(in_strategy="shard", halo=None)),
    (dict(c=8, p=8, n_loc=2), None, 256,
     dict(in_strategy="replicate", halo=None)),
    (dict(c=8, p=8, n_loc=2), None, 256,
     dict(halo=(0, 1), needs_replicated=True)),
    (dict(c=2, p=4, n_loc=2, has_prior=True), None, 19, dict(halo=(0, 3))),
    (dict(c=8, p=8, n_loc=2, base=1, cover=100), 100, 128,
     dict(halo=(0, 2))),
    (dict(c=8, p=8, n_loc=2, base=1, cover=100, has_prior=True), 100, 128,
     dict(halo=(0, 2))),
    (dict(c=8, p=8, n_loc=2, has_prior=True), None, 257,
     dict(halo=(0, 1), mode="gather")),
    (dict(c=8, p=8, n_loc=2, has_prior=True), None, 256,
     dict(halo=(0, 0), mode="gather")),
    (dict(c=8, p=8, n_loc=2, base=0, cover=120, has_prior=False), 120, 128,
     dict(halo=(-1, 1))),
]


@pytest.mark.parametrize("case", range(len(CASES1)))
def test_plan_boundary_equals_reference(case):
    lay_kw, trip, n, kw = CASES1[case]
    kw = {"in_strategy": "shard_halo", "needs_replicated": False,
          "mode": "auto", **kw}

    def plan(comm, sched, spec):
        lay = _layouts(comm, **lay_kw)
        return comm.plan_boundary(
            stage="s", key="k", layout=lay, chunks=_chunks(sched, lay),
            trip=lay.cover if trip is None else trip, aval=spec((n,)), **kw)

    mine, ref = _both(plan)
    assert _as_dict(mine) == _as_dict(ref)
    assert mine.describe() == ref.describe()


def test_plan_boundary_geometry_mismatch_and_bad_mode():
    def plan(comm, sched, spec):
        lay = _layouts(comm, c=4, p=8, n_loc=2)
        other = _layouts(comm, c=8, p=8)
        return comm.plan_boundary(
            stage="s", key="k", layout=lay, chunks=_chunks(sched, other),
            trip=64, aval=spec((64,)), in_strategy="shard_halo",
            halo=(0, 1), needs_replicated=False)

    mine, ref = _both(plan)
    assert _as_dict(mine) == _as_dict(ref) and "geometry" in mine.reason
    from repro_torch.core import comm

    with pytest.raises(ValueError, match="unknown comm mode"):
        comm.plan_boundary(stage="s", key="k", layout=_layouts(comm),
                           chunks=None, trip=1, aval=None,
                           in_strategy="shard", halo=None,
                           needs_replicated=False, mode="bogus")


def _layouts2(mod, ci=8, cj=8, pi=2, pj=2, ni=2, nj=2, bases=(0, 0),
              covers=None, has_prior=False):
    axes = []
    for c, p, n, b, cv in zip((ci, cj), (pi, pj), (ni, nj), bases,
                              covers or (ni * pi * ci, nj * pj * cj)):
        axes.append(mod.AxisSlab(chunk=c, num_devices=p, local_chunks=n,
                                 padded_trip=n * p * c, base=b, cover=cv))
    return mod.SlabLayout2(tuple(axes), has_prior)


def _chunks2(sched_mod, lay):
    return tuple(sched_mod.ChunkPlan(
        trip_count=a.cover, num_devices=a.num_devices, chunk=a.chunk,
        num_chunks=a.local_chunks * a.num_devices,
        local_chunks=a.local_chunks, padded_trip=a.padded_trip)
        for a in lay.axes)


# (layout kwargs, trips, shape, plan kwargs) — the rank-2 cases
CASES2 = [
    (dict(has_prior=True), None, (34, 34), dict(halo_axes=((0, 2), (0, 2)))),
    (dict(ci=1, cj=1, ni=4, nj=4, has_prior=True), None, (9, 9),
     dict(halo_axes=((0, 1), (0, 1)))),
    (dict(), None, (32, 32), dict(halo_axes=((0, 0), (0, 0)))),
    (dict(), None, (32, 32), dict(in_strategy="replicate", halo_axes=None,
                                  shard_ndim=0)),
    (dict(), None, (32, 32), dict(needs_replicated=True)),
    (dict(), None, (32, 32), dict(halo_axes=((0, 1),), shard_ndim=1)),
    (dict(cj=2, has_prior=True), None, (36, 12),
     dict(halo_axes=((0, 1), (0, 3)))),
    (dict(bases=(1, 1), covers=(20, 20)), (20, 20), (24, 24),
     dict(halo_axes=((0, 2), (0, 2)))),
    (dict(bases=(1, 1), covers=(20, 20), has_prior=True), (20, 20), (24, 24),
     dict(halo_axes=((0, 2), (0, 2)))),
    (dict(bases=(1, 1), covers=(20, 20), has_prior=True), (20, 20), (24, 24),
     dict(halo_axes=((0, 2), (0, 2)), mode="gather")),
    (dict(ci=4, cj=6, has_prior=True), None, (64, 64),
     dict(halo_axes=((-1, 1), (-1, 2)))),
]


@pytest.mark.parametrize("case", range(len(CASES2)))
def test_plan_boundary2_equals_reference(case):
    lay_kw, trips, shape, kw = CASES2[case]
    kw = {"in_strategy": "shard_halo", "halo_axes": ((0, 1), (0, 1)),
          "shard_ndim": 2, "needs_replicated": False, "mode": "auto", **kw}

    def plan(comm, sched, spec):
        lay = _layouts2(comm, **lay_kw)
        return comm.plan_boundary2(
            stage="s2", key="k", layout=lay, chunks_axes=_chunks2(sched, lay),
            trips=lay.covers if trips is None else trips, aval=spec(shape),
            **kw)

    mine, ref = _both(plan)
    assert _as_dict(mine) == _as_dict(ref)


def test_cost_functions_and_alpha_model_equal_reference():
    def costs(comm, sched, spec):
        lay = _layouts(comm, c=8, p=8, n_loc=2, has_prior=True)
        lay2 = _layouts2(comm, ci=4, cj=6, has_prior=True)
        a, a2 = spec((128,)), spec((64, 64))
        return [comm.gather_cost(lay, a), comm.halo_cost(lay, a, -1, 2),
                comm.halo_cost(lay, a, 0, 2), comm.gather_cost2(lay2, a2),
                comm.halo_cost2(lay2, a2, ((-1, 1), (-1, 2))),
                comm.modeled_cost_bytes(1000, 3), comm.ALPHA_LAUNCH_BYTES]

    mine, ref = _both(costs)
    assert [dataclasses.asdict(c) if dataclasses.is_dataclass(c) else c
            for c in mine] == [dataclasses.asdict(c)
                               if dataclasses.is_dataclass(c) else c
                               for c in ref]


# ---------------------------------------------------------------------------
# ppermute and the halo emitters against a numpy ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("p", [2, 4, 8])
def test_ppermute_equals_numpy_and_counts(p):
    from repro_torch import omp

    mesh = omp.make_mesh((p,), ("data",), device="cpu")
    x = torch.arange(p * 6, dtype=torch.float32).reshape(p, 2, 3)
    xn = x.numpy()
    for step in (1, -1, 3):
        perm = [((i + step) % p, i) for i in range(p)]
        want = np.stack([xn[(i + step) % p] for i in range(p)])
        np.testing.assert_array_equal(mesh.ppermute(x, "data", perm).numpy(),
                                      want)
    # a rank no pair targets receives zeros (JAX's rule), NaN or not
    x[0] = float("nan")
    got = mesh.ppermute(x, "data", [(0, 1)]).numpy()
    assert np.isnan(got[1]).all() and (got[np.arange(p) != 1] == 0).all()
    assert mesh.launches["ppermute"] == 4
    assert mesh.bytes["ppermute"] == 3 * x.numel() * 4 + 6 * 4
    with pytest.raises(ValueError, match="repeated"):
        mesh.ppermute(x, "data", [(0, 1), (2, 1)])


def _slab(n_loc, p, c, rest=(), seed=0):
    g = np.random.default_rng(seed)
    flat = g.standard_normal((n_loc * p * c,) + rest).astype(np.float32)
    return flat, torch.tensor(flat.reshape((n_loc, p, c) + rest))


def _want_windows(flat, n_loc, p, c, dmin, dmax, prior=None, base=0,
                  cover=None):
    """Window row r of chunk j holds slab row j*c + dmin + r; rows outside
    [0, cover) come from the prior copy (or are left NaN: unchecked)."""
    width = c + dmax - dmin
    cover = len(flat) if cover is None else cover
    out = np.full((n_loc, p, width) + flat.shape[1:], np.nan, np.float32)
    for q in range(n_loc):
        for d in range(p):
            j = q * p + d
            for r in range(width):
                pos = j * c + dmin + r
                if 0 <= pos < cover:
                    out[q, d, r] = flat[pos]
                elif prior is not None:
                    out[q, d, r] = prior[min(max(base + pos, 0),
                                             len(prior) - 1)]
    return out


def _close_where_defined(got, want):
    mask = ~np.isnan(want)
    np.testing.assert_array_equal(got[mask], want[mask])


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("shift", [(-1, 0), (0, 2), (-1, 2), (-3, 3)])
def test_halo_exchange_equals_numpy_ring(p, shift):
    from repro_torch import omp
    from repro_torch.core import comm

    mesh = omp.make_mesh((p,), ("data",), device="cpu")
    n_loc, c = 3, 4
    dmin, dmax = shift
    flat, stacks = _slab(n_loc, p, c, rest=(2,), seed=p)
    got = comm.halo_exchange(mesh, stacks, axis="data", num_devices=p,
                             chunk=c, delta_min=dmin, delta_max=dmax)
    _close_where_defined(got.numpy(),
                         _want_windows(flat, n_loc, p, c, dmin, dmax))
    assert mesh.launches["ppermute"] == (dmin < 0) + (dmax > 0)
    # a partial producer's prior copy fills the rows outside its cover
    base, cover = 2, n_loc * p * c - 5
    prior = np.random.default_rng(1).standard_normal(
        (cover + 7, 2)).astype(np.float32)
    got = comm.halo_exchange(mesh, stacks, axis="data", num_devices=p,
                             chunk=c, delta_min=dmin, delta_max=dmax,
                             prior=torch.tensor(prior), base=base,
                             cover=cover, dtype=torch.float64)
    assert got.dtype == torch.float64
    want = _want_windows(flat, n_loc, p, c, dmin, dmax, prior, base, cover)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float64))


@pytest.mark.parametrize("shape", [(2, 1), (2, 2), (4, 2)])
def test_halo_exchange2_equals_numpy_ring(shape):
    from repro_torch import omp
    from repro_torch.core import comm

    mesh = omp.make_mesh(shape, ("i", "j"), device="cpu")
    (pi, pj), (ni, nj), (ci, cj) = shape, (2, 3), (3, 2)
    deltas = ((-1, 1), (0, 2))
    g = np.random.default_rng(3)
    full = g.standard_normal((ni * pi * ci, nj * pj * cj)).astype(np.float32)
    stacks = torch.tensor(full.reshape(ni, pi, ci, nj, pj, cj))
    prior = g.standard_normal((full.shape[0] + 1, full.shape[1] + 2)).astype(
        np.float32)
    got = comm.halo_exchange2(
        mesh, stacks, axes=("i", "j"), num_devices=shape, chunks=(ci, cj),
        deltas=deltas, prior=torch.tensor(prior), bases=(1, 0),
        covers=full.shape).numpy()
    wi, wj = ci + 2, cj + 2
    for qi in range(ni):
        for di in range(pi):
            for qj in range(nj):
                for dj in range(pj):
                    for r in range(wi):
                        for s in range(wj):
                            x = (qi * pi + di) * ci - 1 + r
                            y = (qj * pj + dj) * cj + s
                            if 0 <= x < full.shape[0] and \
                                    0 <= y < full.shape[1]:
                                want = full[x, y]
                            else:
                                want = prior[min(max(x + 1, 0),
                                                 prior.shape[0] - 1),
                                             min(max(y, 0),
                                                 prior.shape[1] - 1)]
                            assert got[qi, di, r, qj, dj, s] == want
    assert mesh.launches["ppermute"] == 3     # left+right on i, right on j


@pytest.mark.parametrize("p", [2, 4, 8])
def test_aggregated_exchange_equals_per_buffer_in_fewer_launches(p):
    """Mixed dtypes and unequal halo widths on one boundary: one packed
    ppermute per direction, windows identical, wire bytes unchanged."""
    from repro_torch import omp
    from repro_torch.core import comm, comm_schedule as cs

    n_loc, c = 2, 4
    items = []
    for k, (dt, shift) in enumerate([(torch.float32, (-1, 1)),
                                     (torch.bfloat16, (0, 2)),
                                     (torch.int32, (-2, 0))]):
        _, stacks = _slab(n_loc, p, c, rest=(3,) if k == 1 else (), seed=k)
        items.append(cs.HaloItem(stacks=(stacks * 7).to(dt), chunks=(c,),
                                 shifts=(shift,)))
    inline = omp.make_mesh((p,), ("data",), device="cpu")
    want = [comm.halo_exchange(inline, it.stacks, axis="data",
                               num_devices=p, chunk=c,
                               delta_min=it.shifts[0][0],
                               delta_max=it.shifts[0][1]) for it in items]
    packed = omp.make_mesh((p,), ("data",), device="cpu")
    got = cs.aggregated_halo_exchange(packed, items, axis="data",
                                      num_devices=p)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and torch.equal(g, w)
    assert inline.launches["ppermute"] == 4
    assert packed.launches["ppermute"] == 2
    assert packed.bytes["ppermute"] == inline.bytes["ppermute"]


# ---------------------------------------------------------------------------
# Payload packing
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lead", [0, 1])
def test_pack_unpack_roundtrip_bit_exact(lead):
    from repro_torch.core import comm_schedule as cs

    g = torch.Generator().manual_seed(0)
    arrs = []
    for k, name in enumerate(TYPES):
        dt = getattr(torch, name)
        shape = (4,) * lead + ((2, 3), (5,), (1, 2, 2), (), (3,), (3, 2))[k]
        if dt.is_floating_point:
            a = torch.randn(shape, generator=g).to(dt)
            if a.numel():
                a.view(-1)[0] = float("nan")       # NaN bits survive too
        elif dt == torch.bool:
            a = torch.rand(shape, generator=g) > 0.5
        else:
            a = torch.randint(-100, 100, shape, generator=g).to(dt)
        arrs.append(a)
    flat, specs = cs.pack_payloads(arrs, lead=lead)
    assert flat.dtype == torch.uint8
    assert flat.shape[-1] == sum(sp[3] for sp in specs)
    back = cs.unpack_payloads(flat, specs)
    for a, b in zip(arrs, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype == torch.bool:
            assert torch.equal(a, b)
        else:
            ai = a.contiguous().view(-1)
            assert torch.equal(ai.view(torch.uint8) if ai.numel() else ai,
                               b.contiguous().view(-1).view(torch.uint8)
                               if b.numel() else b.view(-1))
