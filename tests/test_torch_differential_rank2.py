"""The rank-2 block families of the differential wall on the 2-D meshes
1x1/2x1/2x2/4x2 against JAX ``run_reference`` at rtol = atol = 1e-4
(``tests/test_torch_differential.py``'s twins), in a file of their own
so that the suite's ``loadfile`` scheduler runs them beside
``tests/test_differential.py`` rather than ahead of it."""
import pytest

from tests.test_torch_differential import (BLOCK_FAMILIES2, check_case2,
                                           make_case2)


@pytest.mark.parametrize("shape", [(1, 1), (2, 1), (2, 2), (4, 2)])
@pytest.mark.parametrize("family", BLOCK_FAMILIES2)
def test_every_rank2_block_family_matches_jax_reference(family, shape):
    from repro_torch import omp

    mesh = omp.make_mesh(shape, ("i", "j"), device="cpu")
    j = BLOCK_FAMILIES2.index(family)
    check_case2(make_case2(7000 + 100 * shape[0] + 10 * shape[1] + j,
                           family), mesh)
