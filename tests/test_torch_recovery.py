"""Recovery in the port's runtime: a run that loses a rank is replanned
onto the survivors and equals the healthy run (``tests/
test_torch_runtime.py``'s helpers and tolerances), in a file of its own
so that the suite's ``loadfile`` scheduler runs it beside
``tests/test_differential.py`` rather than ahead of it."""
import pytest

from tests import test_torch_differential as td
from tests import test_torch_region as tr
from tests.test_torch_runtime import _mesh, _recovers


@pytest.mark.parametrize("lost", [1, 2])
@pytest.mark.parametrize("lowering", ["collective", "kernel"])
def test_recovered_run_equals_healthy_run(lowering, lost):
    """P = 4 -> 3 for every block family and a region; a rank-2 block on
    (2, 2) -> (3, 1)."""
    from repro_torch import omp

    for fam in td.BLOCK_FAMILIES:
        prog, env = td.make_case(9100 + td.BLOCK_FAMILIES.index(fam),
                                 fam)[:2]
        _recovers(prog, env, _mesh(4), lowering, lost)
    reg, renv = tr.make_case(9150, "chain")[:2]
    _recovers(reg, renv, _mesh(4), lowering, lost)
    prog2, env2 = td.make_case2(9200, "matmul2")[:2]
    rex, plans = _recovers(prog2, env2, omp.make_mesh(
        (2, 2), ("i", "j"), device="cpu"), lowering, lost)
    assert plans[0].new_shape == (3, 1)
