"""The master/worker lowering's messages against the reference's
executor: the stacked mesh's ``ppermute`` launches and bytes, the report
and ``cost_summary()`` equal those of
``repro.core.transform._execute_master_worker`` traced on 8 virtual
devices in a subprocess (exactly).  Kept apart from
``tests/test_torch_master_worker.py`` so that the suite's ``loadfile``
scheduler runs it beside ``tests/test_differential.py`` rather than
ahead of it."""
import json

from tests import test_torch_differential as td
from tests.test_torch_master_worker import (COUNT_CASES, COUNT_SEED,
                                            _REFERENCE_COUNTS)


def test_messages_report_and_cost_equal_the_reference_executor(multidevice):
    import chip_smoke
    from repro_torch import omp

    code = (f"CASES = {COUNT_CASES!r}\nSEED = {COUNT_SEED}\n"
            + _REFERENCE_COUNTS)
    line = next(ln for ln in multidevice(code, 8).splitlines()
                if ln.startswith("JSON"))
    ref = json.loads(line[4:])
    for fam, p, ex in COUNT_CASES:
        prog, env, *_ = td.make_case(COUNT_SEED, fam)
        mesh = omp.make_mesh((p,), ("data",), device="cpu")
        c = omp.compile(prog, mesh, lowering="master_worker",
                        paper_master_excluded=ex)
        c(env)
        want = ref[f"{fam}/{p}/{ex}"]
        got = dict(launches=mesh.launches["ppermute"],
                   bytes=mesh.bytes["ppermute"])
        assert got == {k: want[k] for k in got}, (fam, p, ex, got)
        # the count chip_smoke.py holds the card's run to
        assert chip_smoke.mw_messages(c.plan, p) == (want["launches"],
                                                     want["bytes"])
        # the reference lists a block's variables in the order of a set of
        # names (it varies with the process's hash seed); the port's order
        # is fixed, so the lines are compared as a multiset
        assert (sorted(c.report().splitlines())
                == sorted(want["report"].splitlines())), (fam, p, ex)
        assert c.cost_summary() == want["cost"], (fam, p, ex)
