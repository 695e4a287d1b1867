"""The runtime around a compiled program in the port, held against the
reference's (``repro.runtime``, ``repro.serving.compile_service``):
seeded fault plans, the elastic remesh plan and the weighted chunk deal
on a sweep, the injector's hook sites, the compile service's
single-flight compiles and escalation order, and the resilient
executor's retry, validation and recovery on a stacked mesh one rank
smaller, equal to the healthy run.

Recovery onto fewer ranks (== the healthy run) is in
``tests/test_torch_recovery.py``, which uses this file's helpers.
"""
import itertools
import threading
import time

import numpy as np
import pytest
import torch

from tests import test_torch_differential as td
from tests import test_torch_region as tr


def _block(tag, n=16):
    from repro_torch import omp

    scale = float(sum(ord(ch) for ch in str(tag)))

    @omp.parallel_for(stop=n, name=f"svc{tag}")
    def block(i, env):
        return {"y": omp.at(i, env["x"][i] * scale + 1.0)}

    env = {"x": torch.arange(n, dtype=torch.float32),
           "y": torch.zeros(n, dtype=torch.float32)}
    return block, env


def _mesh(p=4):
    from repro_torch import omp

    return omp.make_mesh((p,), ("data",), device="cpu")


# ---------------------------------------------------------------------------
# Pure pieces against the reference
# ---------------------------------------------------------------------------


def test_seeded_fault_plans_equal_reference():
    from repro.runtime import fault_injection as jfi
    from repro_torch.runtime import fault_injection as fi

    for seed, rate, sites, n_ranks in itertools.product(
            range(12), (0.1, 0.25, 0.9), (("run",), fi.SITES), (1, 3, 8)):
        kw = dict(calls=40, rate=rate, sites=sites, n_ranks=n_ranks)
        mine = fi.FaultPlan.seeded(seed, **kw)
        ref = jfi.FaultPlan.seeded(seed, **kw)
        assert ([tuple(vars(s).values()) for s in mine.specs]
                == [tuple(vars(s).values()) for s in ref.specs])
    for bad in (dict(call=0, kind="boom"), dict(call=0, site="nowhere"),
                dict(call=-1), dict(call=0, kind="nan", site="collective"),
                dict(call=0, kind="delay", delay_s=-1.0)):
        with pytest.raises(ValueError) as ref:
            jfi.FaultSpec(**bad)
        with pytest.raises(ValueError) as mine:
            fi.FaultSpec(**bad)
        assert str(mine.value) == str(ref.value)


def test_remesh_plans_and_weighted_deals_equal_reference():
    from repro.runtime import elastic as jel
    from repro.runtime import straggler as jst
    from repro_torch.runtime import elastic, straggler

    for n, mp in itertools.product(range(0, 17), (1, 2, 4, 8)):
        try:
            ref = jel.plan_elastic_remesh(n, model_parallel=mp)
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)):
                elastic.plan_elastic_remesh(n, model_parallel=mp)
            continue
        got = elastic.plan_elastic_remesh(n, model_parallel=mp)
        assert vars(got) == vars(ref)
    rng = np.random.default_rng(3)
    for num_chunks in (1, 2, 3, 7, 8, 13, 40, 97):
        for p in (1, 2, 3, 5, 8):
            w = [float(x) for x in rng.uniform(0.1, 4.0, size=p)]
            assert (straggler.rebalance_chunks(num_chunks, w)
                    == jst.rebalance_chunks(num_chunks, w))
    for bad in ((0, [1.0]), (3, []), (3, [1.0, 0.0]),
                (3, [float("inf")])):
        with pytest.raises(ValueError) as ref:
            jst.rebalance_chunks(*bad)
        with pytest.raises(ValueError) as mine:
            straggler.rebalance_chunks(*bad)
        assert str(mine.value) == str(ref.value)
    mon, jmon = straggler.StragglerMonitor(spike_budget=3), \
        jst.StragglerMonitor(spike_budget=3)
    for dt in [0.01] * 5 + [0.1] * 4 + [0.01] * 3 + [0.5] * 4:
        assert mon.observe(dt) == jmon.observe(dt)
    assert (mon.ewma, mon.spikes, mon.steps) == (jmon.ewma, jmon.spikes,
                                                 jmon.steps)


def test_retry_policy_messages_equal_reference():
    from repro.runtime import resilient as jres
    from repro_torch.runtime import resilient

    for bad in (dict(max_retries=-1), dict(backoff_s=-0.1),
                dict(jitter_s=-1.0), dict(backoff_factor=0.5)):
        with pytest.raises(ValueError) as ref:
            jres.RetryPolicy(**bad)
        with pytest.raises(ValueError) as mine:
            resilient.RetryPolicy(**bad)
        assert str(mine.value) == str(ref.value)


# ---------------------------------------------------------------------------
# Fault injection at every hook site
# ---------------------------------------------------------------------------


def test_injector_fires_at_each_site_and_restores_hooks():
    from repro_torch import omp
    from repro_torch.core import api, transform
    from repro_torch.runtime import (DeviceLossError, FaultPlan, FaultSpec,
                                     inject)

    blk, env = _block("inj")
    mesh = _mesh(2)
    c = omp.compile(blk, mesh, env_like=env)
    with inject(FaultPlan((FaultSpec(call=1, rank=1),))) as inj:
        c.run(env)
        with pytest.raises(DeviceLossError, match="rank 1 at call 1"):
            c.run(env)
        c.run(env)
    assert [k for k, _ in inj.fired] == [1] and inj.call_count() == 3
    assert api._fault_hook is None and transform._fault_hook is None

    with inject(FaultPlan((FaultSpec(call=0, kind="nan"),))):
        out = c.run(env)
    assert torch.isnan(out["y"][0]) and torch.isfinite(out["y"][1:]).all()
    with inject(FaultPlan((FaultSpec(call=0, kind="delay", delay_s=0.05),))):
        t0 = time.perf_counter()
        c.run(env)
        assert time.perf_counter() - t0 >= 0.05
    with inject(FaultPlan()) as inj:
        torch.testing.assert_close(c.run(env)["y"], blk(env)["y"])
    assert inj.fired == []

    # the executor sites: the block executors (the kernel lowering's
    # blocks too) and the fused region executors, rank 1 and rank 2
    prog2, env2 = td.make_case2(5, "rowreduce2")[:2]
    reg, renv = tr.make_case(5, "chain")[:2]
    reg2, renv2 = tr.make_case2(5, "heat2d")[:2]
    mesh2 = omp.make_mesh((2, 1), ("i", "j"), device="cpu")
    for site, prog, e, m, low in (
            ("collective", blk, env, mesh, "collective"),
            ("collective", blk, env, mesh, "kernel"),
            ("collective2", prog2, env2, mesh2, "collective"),
            ("region", reg, renv, mesh, "fused"),
            ("region2", reg2, renv2, mesh2, "fused")):
        comp = omp.compile(prog, m, lowering=low)
        with inject(FaultPlan((FaultSpec(call=0, site=site),))) as inj:
            with pytest.raises(DeviceLossError, match=repr(site)):
                comp.run(e)
        assert len(inj.fired) == 1, (site, low)


# ---------------------------------------------------------------------------
# The compile service
# ---------------------------------------------------------------------------


def test_sixteen_threads_one_cold_compile(tmp_path):
    from repro_torch import omp
    from repro_torch.serving import CompileService

    omp.clear_compile_cache()
    blk, env = _block("flight")
    want = blk(env)["y"]
    svc = CompileService(_mesh())
    barrier = threading.Barrier(16)
    outs, errors = [None] * 16, []

    def client(tid):
        try:
            barrier.wait()
            outs[tid] = svc.run(blk, env)["y"]
        except Exception as e:            # pragma: no cover - failure path
            errors.append(e)

    threads = [threading.Thread(target=client, args=(t,)) for t in range(16)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert all(torch.equal(o, want) for o in outs)
    assert svc.stats.cold_compiles == 1 and svc.stats.requests == 16
    assert svc.stats.warm_hits + svc.stats.coalesced == 15
    assert omp.compile_cache_stats()["misses"] == 1
    assert svc.warmup([blk], env) == 0
    assert svc.stats.as_dict()["requests"] == 16

    @omp.parallel_for(stop=16, name="svcbad")
    def bad(i, env):
        return {"y": omp.at(i, env["missing_key"][i])}

    with pytest.raises(Exception):
        svc.run(bad, env)
    assert len(svc._compiled) == 1 and svc._inflight == {}
    with CompileService(_mesh(), max_workers=2) as svc2:
        futs = [svc2.submit(blk, env) for _ in range(3)]
        assert all(torch.equal(f.result(timeout=60)["y"], want)
                   for f in futs)
    # persistent_dir turns the store on: the cold compile lands on disk
    try:
        with CompileService(_mesh(), persistent_dir=str(tmp_path)) as svc3:
            assert omp.compile_cache_stats()["persistent_dir"] == str(
                tmp_path)
            omp.clear_compile_cache()
            assert torch.equal(svc3.run(blk, env)["y"], want)
        assert list(tmp_path.glob("*.aot"))
        assert omp.compile_cache_stats()["disk_bytes_written"] > 0
    finally:
        omp.disable_persistent_cache()


def test_straggler_escalates_to_weights_then_to_a_degraded_plan():
    from repro_torch import omp
    from repro_torch.runtime import StragglerMonitor
    from repro_torch.serving import CompileService

    def straggle(svc, slow, n=10):
        # the run's own (host-dependent) time is not part of the script
        for _ in range(20 if svc.monitor.steps == 0 else 0):
            svc._observe(0.010)
        for _ in range(n):
            svc._observe(slow)

    omp.clear_compile_cache()
    blk, env = _block("esc")
    for lowering in ("collective", "kernel"):
        plans = []
        svc = CompileService(
            _mesh(), options=omp.Options(lowering=lowering),
            monitor=StragglerMonitor(spike_factor=2.0, spike_budget=3),
            on_evict=plans.append, device_weights=[2.0, 1.0, 1.0, 1.0])
        ref = svc.run(blk, env)
        svc.monitor = StragglerMonitor(spike_factor=2.0, spike_budget=3)
        straggle(svc, 0.200)
        if lowering == "kernel":
            # weights need the plain chunk executor: the span kernel
            # keeps its lowering and goes straight to the degraded plan
            assert svc.stats.rebalances == 0 and svc.stats.evictions == 1
            assert svc.options.lowering is omp.Lowering.KERNEL
            assert svc.options.chunk_weights is None
            assert plans == [svc.remesh_plan]
            assert not svc.health()["rebalanced"]
            assert torch.equal(svc.run(blk, env)["y"], ref["y"])
            continue
        # first exhaustion: one weighted recompile, still COLLECTIVE
        assert svc.stats.rebalances == 1 and svc.stats.evictions == 0
        assert svc.options.lowering is omp.Lowering.COLLECTIVE
        assert svc.options.chunk_weights == (2.0, 1.0, 1.0, 1.0)
        h = svc.health()
        assert h["rebalanced"] and not h["degraded"] and plans == []
        cold = svc.stats.cold_compiles
        out = svc.run(blk, env)
        assert svc.stats.cold_compiles == cold + 1
        assert torch.equal(out["y"], ref["y"])
        straggle(svc, 2.0)
        assert svc.stats.evictions == 1 and plans == [svc.remesh_plan]
        assert svc.health()["remesh_plan"]["new_shape"] == (3, 1)

    bare = CompileService(_mesh(), monitor=StragglerMonitor(spike_budget=3))
    for dt in [0.01] * 20 + [0.2] * 10:
        bare._observe(dt)
    assert bare.stats.rebalances == 0 and bare.stats.evictions == 1
    assert bare.suggest_rebalance(8, [1.0, 3.0]).count(1) > 4


# ---------------------------------------------------------------------------
# The resilient executor
# ---------------------------------------------------------------------------


def _reduce_keys(prog):
    loops = [s for s in getattr(prog, "stages", (prog,))
             if hasattr(s, "reduction")]
    return set().union(*(set(lp.reduction) for lp in loops))


def _recovers(prog, env, mesh, lowering, lost):
    from repro_torch import omp
    from repro_torch.runtime import (FaultPlan, FaultSpec, ResilientExecutor,
                                     RetryPolicy, inject)

    compiled = omp.compile(prog, mesh, lowering=lowering)
    healthy = compiled.run(env)
    plans = []
    rex = ResilientExecutor(compiled, policy=RetryPolicy(max_retries=2),
                            on_recover=plans.append)
    with inject(FaultPlan(tuple(FaultSpec(call=k, rank=lost)
                                for k in range(3)))):
        got = rex.run(env)
    assert rex.degraded and rex.stats["recoveries"] == 1
    assert rex.stats["retries"] == 2
    survivors = rex._degraded[1]
    assert survivors.device == mesh.device
    assert (np.prod(list(survivors.shape.values()))
            == np.prod(list(mesh.shape.values())) - 1)
    reds = _reduce_keys(prog)
    for k in healthy:
        if k in reds:
            torch.testing.assert_close(got[k], healthy[k], rtol=1e-5,
                                       atol=1e-6)
        else:
            assert torch.equal(got[k], healthy[k]), (prog.name, k)
    return rex, plans


def test_recovery_is_sticky_until_reset_and_validation_retries():
    from repro_torch import omp
    from repro_torch.runtime import (CorruptOutputError, FaultPlan,
                                     FaultSpec, ResilientExecutor,
                                     RetryPolicy, inject)

    blk, env = _block("sticky")
    want = blk(env)["y"]
    compiled = omp.compile(blk, _mesh(4), env_like=env)
    rex = ResilientExecutor(compiled, policy=RetryPolicy(max_retries=1))
    with inject(FaultPlan(tuple(FaultSpec(call=k) for k in range(2)))):
        assert torch.equal(rex.run(env)["y"], want)
    assert rex.degraded and rex.remesh_plan.new_shape == (3, 1)
    with inject(FaultPlan()) as inj:
        assert torch.equal(rex.run(env)["y"], want)   # the shrunk mesh
        assert inj.call_count() == 1
    rex.reset()
    assert not rex.degraded and rex.remesh_plan is None
    assert torch.equal(rex.run(env)["y"], want)

    # a NaN at run_exit is caught and absorbed by a retry
    rex = ResilientExecutor(compiled, policy=RetryPolicy(max_retries=1))
    with inject(FaultPlan((FaultSpec(call=0, kind="nan"),))):
        assert torch.equal(rex.run(env)["y"], want)
    assert rex.stats["validation_failures"] == 1
    assert rex.stats["retries"] == 1 and not rex.degraded
    # poison on every attempt, the recovery's too, surfaces
    rex = ResilientExecutor(compiled, policy=RetryPolicy(max_retries=1))
    with inject(FaultPlan(tuple(FaultSpec(call=k, kind="nan")
                                for k in range(9)))):
        with pytest.raises(CorruptOutputError):
            rex.run(env)
    rex = ResilientExecutor(compiled, policy=RetryPolicy(
        max_retries=0, validate_outputs=False))
    with inject(FaultPlan((FaultSpec(call=0, kind="nan"),))):
        assert torch.isnan(rex.run(env)["y"]).any()
    pol = RetryPolicy(max_retries=3, backoff_s=0.01, jitter_s=0.005, seed=7)
    a, b = (ResilientExecutor(compiled, policy=pol) for _ in range(2))
    assert ([a._rng.uniform(0, 1) for _ in range(4)]
            == [b._rng.uniform(0, 1) for _ in range(4)])
