"""Plan artifacts of the PyTorch port held against the JAX package: the
heaviest cases of ``tests/test_torch_core.py``, in a file of their own so
that the suite's ``loadfile`` scheduler runs them beside
``tests/test_differential.py`` rather than ahead of it.

* ``ChunkPlan``, ``ContextInfo`` and ``DistPlan`` of every block family
  equal the reference planner's on 1/2/4/8 ranks (structurally equal);
* the nest staging geometry (``pad_reshape``, ``halo_slabs``,
  ``local_slabs``, ``halo_slabs2``) equals the reference's bit for bit;
* ``merge_chunk_values`` equals the reference's per-device merge rank by
  rank (values bit for bit, reduction carries rtol 1e-5 / 1e-6).
"""
import numpy as np
import pytest
import torch

from tests import test_torch_differential as td
from tests.test_torch_core import _norm, _plans


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_dist_plans_and_contexts_equal_reference(p):
    """ChunkPlans, ContextInfo and DistPlan strategies of every block
    family (plus random draws: zero-trip, trip < ranks) equal the JAX
    planner's, shard replicate and slice."""
    cases = [td.make_case(40 * p + s, f)
             for s, f in enumerate(td.BLOCK_FAMILIES * 2)]
    cases += [td.make_case2(60 * p + s, f)
              for s, f in enumerate(td.BLOCK_FAMILIES2 * 2)]
    for case in cases:
        for shard in (False, True):
            mine, ref = _plans(case, p, shard)
            assert _norm(mine) == _norm(ref), (case[0].name, p, shard)
        if case[0].rank == 1 and p >= 2:
            # the master/worker schedule (rank 0 excluded from the deal)
            mine, ref = _plans(case, p, False, "master_worker")
            assert _norm(mine) == _norm(ref), (case[0].name, p)


def test_nest_staging_matches_reference_geometry():
    import jax.numpy as jnp

    from repro.core import nest as jnest
    from repro.core import loop as jloop, pragma as jpragma
    from repro.core import schedule as jsched
    from repro_torch.core import nest, loop, pragma, schedule

    x = np.arange(60, dtype=np.float32).reshape(20, 3)
    for t, p, c, w in ((20, 3, 2, None), (17, 4, 3, [1.0, 3.0, 2.0, 1.0])):
        ch = schedule.make_chunk_plan(loop.analyze_loop(0, t, 1),
                                      pragma.Schedule("dynamic", c), p,
                                      weights=w)
        jch = jsched.make_chunk_plan(jloop.analyze_loop(0, t, 1),
                                     jpragma.Schedule("dynamic", c), p,
                                     weights=w)
        xt, xj = torch.tensor(x[:t]), jnp.asarray(x[:t])
        for mine, ref in (
                (nest.pad_reshape(xt, ch), jnest.pad_reshape(xj, jch)),
                (nest.halo_slabs(torch.tensor(x), ch, (-1, 2)),
                 jnest.halo_slabs(jnp.asarray(x), jch, (-1, 2))),
                (nest.local_slabs(torch.tensor(x), ch, (0, 1), 1),
                 jnest.local_slabs(jnp.asarray(x), jch, (0, 1), 1))):
            np.testing.assert_array_equal(mine.numpy(), np.asarray(ref))
        slabs = nest.pad_reshape(xt, ch)
        np.testing.assert_array_equal(
            nest.unpad_flat(slabs, ch, t).numpy(), x[:t])
    chs = tuple(schedule.make_chunk_plan(loop.analyze_loop(0, n, 1),
                                         pragma.Schedule("static", 2), p)
                for n, p in ((5, 2), (4, 2)))
    jchs = tuple(jsched.make_chunk_plan(jloop.analyze_loop(0, n, 1),
                                        jpragma.Schedule("static", 2), p)
                 for n, p in ((5, 2), (4, 2)))
    a = np.arange(30, dtype=np.float32).reshape(6, 5)
    np.testing.assert_array_equal(
        nest.halo_slabs2(torch.tensor(a), chs, ((-1, 1), (0, 1))).numpy(),
        np.asarray(jnest.halo_slabs2(jnp.asarray(a), jchs,
                                     ((-1, 1), (0, 1)))))


def test_merges_match_reference_merge_chunk_values():
    """``merge_chunk_values`` on the port's all-rank dense values equals
    the reference's per-device merge, rank by rank."""
    import jax.numpy as jnp

    from repro.core import pallas_lower as jpl
    from repro_torch.core import kernel_lower as kl

    for s, family in enumerate(("strided", "put", "reduce", "combo")):
        for p in (1, 3):
            case = td.make_case(300 + 10 * s + p, family)
            mine_plan, ref_plan = _plans(case, p, False)
            ch = mine_plan.chunks
            g = np.random.default_rng(s)
            vals = {}
            for key, dec in mine_plan.vars.items():
                if dec.out_strategy != "none":
                    vshape = mine_plan.context.vars[key].write.value_shape
                    vals[key] = g.standard_normal(
                        (ch.local_chunks, p, ch.chunk) + tuple(vshape)
                    ).astype(np.float32)
            carry, ys = kl.merge_chunk_values(
                mine_plan, {k: torch.tensor(v) for k, v in vals.items()})
            for d in range(p):
                jcarry, jys = jpl.merge_chunk_values(
                    ref_plan, {k: jnp.asarray(v[:, d])
                               for k, v in vals.items()}, d)
                for k, v in jys.items():
                    np.testing.assert_array_equal(ys[k][:, d].numpy(),
                                                  np.asarray(v))
                for k, v in jcarry.items():
                    mine = carry[k]
                    if isinstance(v, tuple):
                        for a, b in zip(mine, v):
                            np.testing.assert_allclose(
                                a[d].numpy(), np.asarray(b), rtol=1e-6)
                    else:
                        np.testing.assert_allclose(
                            mine[d].numpy(), np.asarray(v), rtol=1e-5)
