"""``KernelPlan`` span partitions and the chunk dims of the grid, held
against the reference's Pallas planner on 1/2/4/8 ranks (structurally
equal): a case of ``tests/test_torch_core.py``, whose helpers it uses,
in a file of its own so that the suite's ``loadfile`` scheduler runs it
beside ``tests/test_differential.py`` rather than ahead of it."""
import pytest

from tests import test_torch_differential as td
from tests.test_torch_core import _plans


@pytest.mark.parametrize("p", [1, 2, 4, 8])
def test_kernel_plans_equal_reference_spans_and_chunk_grid(p):
    """One span per block with the reference's stage partition and the
    chunk dims of its grid; the port's launch adds the ranks to it."""
    from repro.core import pallas_lower as jpl
    from repro_torch.core import kernel_lower as kl

    cases = [td.make_case(80 * p + s, f)
             for s, f in enumerate(td.BLOCK_FAMILIES * 2)]
    cases += [td.make_case2(90 * p + s, f)
              for s, f in enumerate(td.BLOCK_FAMILIES2 * 2)]
    for case in cases:
        mine, ref = _plans(case, p, True)
        kmine = kl.plan_block_kernel(mine, case[0], name=case[0].name)
        kref = jpl.plan_block_kernel(ref, name=case[0].name)
        assert (kmine.name, kmine.rank, kmine.n_loop_stages, kmine.n_kernels) \
            == (kref.name, kref.rank, kref.n_loop_stages, kref.n_kernels)
        for sm, sr in zip(kmine.spans, kref.spans):
            assert (sm.stage_names, sm.stage_indices, sm.forwarded,
                    sm.n_outputs) == (sr.stage_names, sr.stage_indices,
                                      sr.forwarded, sr.n_outputs)
            rank = sm.rank
            assert sm.grid[:rank] == sr.grid[:rank]          # chunk dims
            assert sm.grid[rank:] == tuple(t.n_tiles for t in sm.tiles)
            assert sm.ranks == tuple(ch.num_devices
                                     for ch in mine.chunks_axes)
            assert sm.source.n_programs == sm.launch_programs
            assert sm.slots == tuple(
                -(-lp.trip_count // ch.chunk)
                for lp, ch in zip(mine.nest.axes, mine.chunks_axes))
            assert all(s <= ch.num_chunks
                       for s, ch in zip(sm.slots, mine.chunks_axes))
