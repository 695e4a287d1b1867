"""Whole programs (``omp.region``) in the PyTorch port against the JAX
package: the heaviest cases of ``tests/test_torch_region.py``, in a file
of their own so that the suite's ``loadfile`` scheduler runs them beside
``tests/test_differential.py`` rather than ahead of it.

* residency plans, boundary comms, comm schedules and kernel spans of
  every region family equal the reference's on 1/2/4/8 ranks;
* ``lowering="kernel"`` equals JAX ``lowering="pallas"`` (interpret mode)
  on a 1-device mesh at rtol = atol = 1e-4;
* scatter + put, reshard and partial-cover regions equal the reference's
  outputs (rtol = atol = 1e-4) and plans.
"""
import numpy as np
import pytest
import torch

from tests import test_torch_differential as td
from tests.test_torch_region import (FAMILIES, FAMILIES2, _both_plans, _case,
                                     _jax_env, _more_regions, check_region)


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_region_plans_equal_reference(p):
    """Residency plans, boundary comms, comm schedules and kernel spans
    of every region family (comm auto; gather on the halo families)."""
    for j, family in enumerate(FAMILIES + FAMILIES2):
        case, num, axis = _case(family, p, 3000 + 10 * p + j)
        if family not in FAMILIES2:
            num, axis = num[0], axis[0]
        _both_plans(case, num, axis)
        if family in ("pingpong", "heat2d"):
            _both_plans(case, num, axis, comm="gather")


def test_kernel_lowering_matches_jax_pallas_every_region_family():
    """Each region family through the port's kernel lowering and through
    the JAX pallas lowering (interpret mode) on a 1-device mesh."""
    import jax
    from jax.sharding import Mesh

    from repro import omp as jomp
    from repro.compat import make_mesh as jmake_mesh
    from repro_torch import omp

    jmeshes = {1: Mesh(np.asarray(jax.devices()[:1]), ("data",)),
               2: jmake_mesh((1, 1), ("i", "j"))}
    for j, family in enumerate(FAMILIES + FAMILIES2):
        (prog, env, jprog, jenv, _), shape, axes = _case(family, 1, 500 + j)
        pal = jomp.compile(jprog, jmeshes[prog.rank], lowering="pallas")
        want = {k: np.asarray(v)
                for k, v in jax.jit(lambda e: pal(e))(jenv).items()}
        got = omp.compile(prog, omp.make_mesh(shape, axes, device="cpu"),
                          lowering="kernel")(env)
        td._assert_matches(got, want, f"{family} kernel-vs-pallas")


@pytest.mark.parametrize("p", [1, 3])
def test_scatter_put_reshard_and_partial_regions_match_jax(p):
    import jax.numpy as jnp

    from repro import omp as jomp
    from repro_torch import omp

    for (prog, env), (jprog, _) in zip(_more_regions(omp, torch),
                                       _more_regions(jomp, jnp)):
        case = (prog, td._env_of(env), jprog, _jax_env(env), prog.name)
        check_region(case, (p,), ("data",))
        _both_plans(case, p, "data")
