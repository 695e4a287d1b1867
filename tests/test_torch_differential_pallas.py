"""The differential wall's two heaviest cases, kept in a file of their own
so that the suite's ``loadfile`` scheduler (which hands out files with
more tests first) runs them beside ``tests/test_differential.py`` rather
than ahead of it.  The cases and their helpers are
``tests/test_torch_differential.py``'s:

* random seeds and schedules through every lowering against JAX
  ``run_reference`` at rtol = atol = 1e-4;
* ``lowering="kernel"`` against JAX ``lowering="pallas"`` (interpret
  mode) on the 1-device mesh, at the same tolerance.
"""
import numpy as np

from tests._hypothesis_compat import given, settings, strategies as st
from tests.test_torch_differential import (BLOCK_FAMILIES, BLOCK_FAMILIES2,
                                           _assert_matches, check_case,
                                           make_case, make_case2)


@settings(max_examples=8, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), p=st.sampled_from([1, 2, 3, 4]))
def test_random_block_draws_match_jax_reference(seed, p):
    """Random seeds and schedules (zero-trip and trip < ranks draws
    included) through every lowering."""
    from repro_torch import omp

    family = BLOCK_FAMILIES[seed % len(BLOCK_FAMILIES)]
    check_case(make_case(seed, family),
               omp.make_mesh((p,), ("data",), device="cpu"))


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
