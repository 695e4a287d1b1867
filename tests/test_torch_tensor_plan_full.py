"""The tensor planner's specs of the five families' parameters,
optimizer states and caches at full size on four meshes, under both
plans, equal the reference's leaf by leaf: the heaviest case of
``tests/test_torch_tensor_plan.py``, whose helpers it uses, in a file
of its own so that the suite's ``loadfile`` scheduler runs it beside
``tests/test_differential.py`` rather than ahead of it."""
import pytest

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_tensor_plan import (ARCHS, MESHES, SERVE, TRAIN,
                                          _both, _same_specs, _trees)


@pytest.mark.parametrize("arch", ARCHS)
def test_tree_specs_match_reference_at_full_size(arch):
    (p, a, opts, c, ca), (jp, ja, jopts, jc, jca) = _trees(arch)
    leaves = 0
    for mesh, axes in MESHES.items():
        for kw in TRAIN:
            port, ref = _both("train", axes, mesh, **kw)
            leaves += _same_specs(port.tree_specs(p, a),
                                  ref.tree_specs(jp, ja))
            for o, (state, st_axes) in opts.items():
                jstate, jst_axes = jopts[o]
                leaves += _same_specs(port.tree_specs(state, st_axes),
                                      ref.tree_specs(jstate, jst_axes))
        for kw in SERVE:
            port, ref = _both("serve", axes, mesh, **kw)
            leaves += _same_specs(port.tree_specs(p, a),
                                  ref.tree_specs(jp, ja))
            leaves += _same_specs(port.tree_specs(c, ca),
                                  ref.tree_specs(jc, jca))
    assert leaves > 100
