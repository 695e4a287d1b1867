"""The facade's leftovers: the reference's deprecated shims
``omp.to_mpi`` / ``omp.region_to_mpi`` (``src/repro/core/transform.py``,
``src/repro/core/region.py``) and the twins of its top-level examples
under ``repro_torch.examples``, on the CPU at small sizes.

Each shim warns with the reference's ``DeprecationWarning`` text,
translates its keywords to ``omp.Options`` as the reference does, and
returns what ``omp.compile`` returns for them (equal reports, outputs
equal bit for bit).  Each example's ``main`` runs to its own checks.
"""
import warnings

import pytest
import torch

from tests import test_torch_polybench as tpb


def _reference_warning(shim) -> str:
    """The text the reference's shim warns with (its compile of nothing
    then fails, after the warning)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        with pytest.raises(Exception):
            shim(None, None)
    (w,) = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    return str(w.message)


def test_to_mpi_warns_and_equals_compile():
    from repro.core import transform as jt
    from repro_torch import omp, polybench

    k = polybench.make("gemm", tpb.DIMS["gemm"])
    env = k.env_fn("cpu")
    mesh = omp.make_mesh((4,), ("data",), device="cpu")
    for kw, opts in (({}, {"lowering": "collective"}),
                     ({"shard_inputs": True},
                      {"lowering": "collective", "shard": "slice"}),
                     ({"lowering": "master_worker",
                       "paper_master_excluded": True},
                      {"lowering": "master_worker",
                       "paper_master_excluded": True}),
                     ({"lowering": "kernel"}, {"lowering": "kernel"})):
        with pytest.warns(DeprecationWarning) as rec:
            legacy = omp.to_mpi(k.programs[0], mesh, env_like=env, **kw)
        assert str(rec[0].message) == _reference_warning(jt.to_mpi)
        assert isinstance(legacy, omp.Compiled)
        want = omp.compile(k.programs[0], mesh, env_like=env, **opts)
        assert legacy.options == want.options
        assert legacy.report() == want.report()
        assert torch.equal(legacy(env)["C"], want(env)["C"])


def test_region_to_mpi_warns_and_translates_its_keywords():
    from repro.core import region as jr
    from repro_torch import omp
    from repro_torch.examples.region_pipeline import pipeline

    program = pipeline(40)
    env = {k: torch.zeros(s) for k, s in (("a", 40), ("u", 40), ("v", 40),
                                          ("scale", 1), ("y", 40))}
    env["a"] = torch.arange(40, dtype=torch.float32)
    env["ss"] = torch.zeros(())
    mesh = omp.make_mesh((4,), ("data",), device="cpu")
    text = _reference_warning(jr.region_to_mpi)
    for kw, lowering in (({}, omp.Lowering.FUSED),
                         ({"fuse": False}, omp.Lowering.COLLECTIVE),
                         ({"lowering": "master_worker"},
                          omp.Lowering.MASTER_WORKER),
                         ({"comm": "gather"}, omp.Lowering.FUSED)):
        with pytest.warns(DeprecationWarning) as rec:
            legacy = omp.region_to_mpi(program, mesh, env_like=env, **kw)
        assert str(rec[0].message) == text
        assert legacy.options.lowering is lowering
        want = omp.compile(program, mesh, legacy.options, env_like=env)
        assert legacy.report() == want.report()
        got, ref = legacy(env), want(env)
        for key in ref:
            assert torch.equal(got[key], ref[key]), (kw, key)
    # a single block is wrapped into a region; an unknown lowering raises
    block = program.stages[0]
    with pytest.warns(DeprecationWarning):
        c = omp.region_to_mpi(block, mesh)
    assert isinstance(c.program, omp.ParallelRegion)
    with pytest.warns(DeprecationWarning), pytest.raises(omp.CompileError):
        omp.region_to_mpi(program, mesh, lowering="pallas")


@pytest.mark.parametrize("name,argv", [
    ("quickstart", ["--n", "200", "--ranks", "4"]),
    ("region_pipeline", ["--n", "96", "--ranks", "4"]),
    ("serve_lm", ["--requests", "3", "--new-tokens", "4"]),
    ("polybench_transform", ["--n", "24", "--ranks", "4"]),
])
def test_examples_run_on_the_cpu(name, argv, capsys):
    import importlib

    mod = importlib.import_module(f"repro_torch.examples.{name}")
    got = mod.main(argv + ["--device", "cpu"])
    text = capsys.readouterr().out
    if name == "serve_lm":
        assert all(r.done and len(r.output) == 4 for r in got)
        assert "served 3 requests / 12 tokens" in text
    else:
        assert "OK" in text
