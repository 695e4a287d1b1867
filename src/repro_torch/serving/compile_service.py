"""Concurrent compile-and-run service over the port's ``omp.compile``
(counterpart of :mod:`repro.serving.compile_service`).

The paper's master/worker split, one level up: the service is the
master — it owns admission, scheduling and the compile cache — and the
compiled SPMD executables are the workers.  Many independent client
programs (the MPI-rical / MPIrigen load shape: a sustained stream of
translation requests) submit concurrently; the service

* serves **warm keys lock-free** — a structurally-seen program is a
  plain dict probe straight into the cached
  :class:`~repro_torch.core.api.Compiled` artifact,
* **single-flights cold compiles** — N clients racing the same new
  structural key produce exactly ONE compile; the rest park on an event
  and reuse the winner's artifact (pinned in
  ``tests/test_compile_service.py``),
* runs distinct cold keys concurrently on a thread pool,
* wires the :mod:`repro_torch.runtime.straggler` /
  :mod:`repro_torch.runtime.elastic` hooks: per-request wall time feeds a
  :class:`~repro_torch.runtime.straggler.StragglerMonitor`; when the spike
  budget is exhausted the service escalates — first (given operator
  ``device_weights``) it recompiles with a straggler-weighted chunk
  schedule (``Options.chunk_weights``, counted in ``rebalances``;
  ``Lowering.KERNEL`` skips this rung and keeps its span kernel);
  only if the straggler persists does it plan a degraded-mesh restart
  (:func:`~repro_torch.runtime.elastic.plan_elastic_remesh`) and surface
  it via :meth:`CompileService.health` / the ``on_evict`` callback.

``persistent_dir`` turns on the persistent store
(:func:`~repro_torch.core.api.enable_persistent_cache`), as the
reference's does: a fresh service process restores compiles instead of
planning them (and, on the card, of compiling their span kernels).

Over a :class:`~repro_torch.mesh.ProcessMesh` every process runs a service
of its own on its own ranks, and the requests of a run meet their peers'
collectives: each service runs its requests (compile and run) one at a
time on one worker thread, whose queue is first in, first out, in the
order :meth:`CompileService.submit` (and :meth:`CompileService.run` and
:meth:`CompileService.warmup`, which queue there too) received them.
That order must be the same on every process; requests of one cold key
still make one compile.  The escalations are decided alike on every
process (one process's exhausted spike budget escalates them all), so
that their plans stay the same.
"""
from __future__ import annotations

import dataclasses
import math
import threading
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, Mapping

from repro_torch.core import api as api_mod
from repro_torch.runtime.elastic import RemeshPlan, plan_elastic_remesh
from repro_torch.runtime.straggler import StragglerMonitor, rebalance_chunks


class _Flight:
    """One in-progress cold compile; followers park on the event."""

    __slots__ = ("event", "compiled", "error")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.compiled: Any = None
        self.error: BaseException | None = None


class ServiceStats:
    """Request counters.  Bumps on the lock-free warm path use the
    GIL-atomic counter from the compile cache (a bare ``+= 1`` is a
    read-modify-write that loses counts under threads — the same bug
    family as the engine's dropped results)."""

    _FIELDS = ("requests", "warm_hits", "cold_compiles", "coalesced",
               "errors", "rebalances", "evictions")

    def __init__(self) -> None:
        for f in self._FIELDS:
            setattr(self, "_" + f, api_mod._Counter())
        self.run_seconds = 0.0    # guarded by the monitor lock

    def inc(self, field: str) -> None:
        getattr(self, "_" + field).inc()

    def __getattr__(self, name: str):
        if name in self._FIELDS:
            return getattr(self, "_" + name).value
        raise AttributeError(name)

    def as_dict(self) -> dict:
        d = {f: getattr(self, f) for f in self._FIELDS}
        d["run_seconds"] = self.run_seconds
        d["compile_cache"] = api_mod.compile_cache_stats()
        return d


class CompileService:
    """Admit, compile (deduplicated), and run client programs.

    Thread-safety contract: the warm path touches only GIL-atomic
    operations (dict probe, counter bumps); ``_lock`` guards flight
    registration and the publish of a finished compile.  The compile
    itself — and the client's execution — run outside the lock.
    """

    def __init__(self, mesh, *, options=None, max_workers: int = 8,
                 persistent_dir: str | None = None,
                 monitor: StragglerMonitor | None = None,
                 on_evict: Callable[[RemeshPlan], None] | None = None,
                 model_parallel: int = 1,
                 device_weights=None) -> None:
        self.mesh = mesh
        self.options = options if options is not None else api_mod.Options()
        if persistent_dir is not None:
            api_mod.enable_persistent_cache(persistent_dir)
        self._compiled: dict[tuple, Any] = {}     # key -> Compiled (warm)
        self._inflight: dict[tuple, _Flight] = {}
        self._lock = threading.Lock()
        self._pool: ThreadPoolExecutor | None = None
        self._max_workers = max_workers
        self.stats = ServiceStats()
        self.monitor = monitor if monitor is not None else StragglerMonitor()
        self._monitor_lock = threading.Lock()
        self._on_evict = on_evict
        self._model_parallel = model_parallel
        self._device_weights = (tuple(device_weights)
                                if device_weights is not None else None)
        self._weighted_options: Any = None
        self.remesh_plan: RemeshPlan | None = None
        #: over a process mesh: one worker, so the same order everywhere
        self._across = api_mod._is_process_mesh(mesh)

    # ------------------------------------------------------------- keys --
    def _key(self, program, options) -> tuple:
        """The in-process structural identity — the same key the
        compile cache uses, so service dedup and cache residency agree."""
        return (api_mod._program_signature(program),
                api_mod._mesh_signature(self.mesh), options)

    # -------------------------------------------------------- admission --
    def run(self, program, env: Mapping[str, Any],
            options=None) -> dict:
        """Compile (or reuse) ``program`` and run it on ``env``.
        Blocking; safe to call from many client threads at once."""
        if self._across:
            return self.submit(program, env, options).result()
        return self._run(program, env, options)

    def _run(self, program, env: Mapping[str, Any], options) -> dict:
        options = options if options is not None else self.options
        self.stats.inc("requests")
        compiled = self._get_compiled(program, env, options)
        t0 = time.perf_counter()
        try:
            out = compiled.run(env)
        except BaseException:
            self.stats.inc("errors")
            raise
        self._observe(time.perf_counter() - t0)
        return out

    def submit(self, program, env: Mapping[str, Any],
               options=None) -> Future:
        """Async variant of :meth:`run`: returns a Future resolving to
        the output environment."""
        return self._queue(self._run, program, env, options)

    def _queue(self, fn, *args) -> Future:
        with self._lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(
                    max_workers=1 if self._across else self._max_workers,
                    thread_name_prefix="compile-service")
        return self._pool.submit(fn, *args)

    def warmup(self, programs, env_like: Mapping[str, Any],
               options=None) -> int:
        """Pre-compile ``programs`` (shapes only); returns how many
        cold compiles that took."""
        options = options if options is not None else self.options
        before = self.stats.cold_compiles
        for p in programs:
            if self._across:
                self._queue(self._get_compiled, p, env_like, options).result()
            else:
                self._get_compiled(p, env_like, options)
        return self.stats.cold_compiles - before

    # ------------------------------------------------------ single-flight --
    def _get_compiled(self, program, env, options):
        key = self._key(program, options)
        compiled = self._compiled.get(key)       # warm: lock-free
        if compiled is not None:
            self.stats.inc("warm_hits")
            return compiled
        follower = False
        with self._lock:
            compiled = self._compiled.get(key)   # published while racing
            if compiled is not None:
                self.stats.inc("warm_hits")
                return compiled
            flight = self._inflight.get(key)
            if flight is None:
                flight = _Flight()
                self._inflight[key] = flight
            else:
                follower = True
        if follower:
            flight.event.wait()
            self.stats.inc("coalesced")
            if flight.error is not None:
                raise flight.error
            return flight.compiled
        try:
            compiled = api_mod.compile(program, self.mesh, options,
                                       env_like=env)
            compiled._ensure(env)                # plan + build now
            self.stats.inc("cold_compiles")
            flight.compiled = compiled
            with self._lock:
                self._compiled[key] = compiled
        except BaseException as e:
            flight.error = e
            raise
        finally:
            with self._lock:
                self._inflight.pop(key, None)
            flight.event.set()
        return compiled

    # ------------------------------------------- degraded-mesh operation --
    def _observe(self, dt: float) -> None:
        with self._monitor_lock:
            self.stats.run_seconds += dt
            status = self.monitor.observe(dt)
            if self._across and self.mesh.total(int(status == "evict")):
                status = "evict"        # some process's budget ran out
            if status != "evict" or self.remesh_plan is not None:
                return
            if (self._device_weights is not None
                    and self._weighted_options is None
                    and self.options.lowering
                    is not api_mod.Lowering.KERNEL):
                self._escalate_weighted()
            else:
                self._plan_degraded()

    def _escalate_weighted(self) -> None:
        """First escalation rung: keep every device but re-deal its
        chunk share to the operator-supplied ``device_weights`` — a
        recompile (through the cache) with a straggler-weighted
        schedule, cheaper than evicting the slow device outright.  The
        spike budget resets; if the straggler persists through the
        rebalanced schedule, the next exhaustion falls through to
        :meth:`_plan_degraded`.  A ``Lowering.KERNEL`` service skips
        this rung: weights need the plain collective chunk executor, and
        the span kernel never gives way to it, so a straggler there goes
        straight to the degraded plan."""
        self.stats.inc("rebalances")
        opts = self.options
        lowering = opts.lowering
        if lowering is not api_mod.Lowering.COLLECTIVE:
            # weighted schedules live in the collective chunk executor
            lowering = api_mod.Lowering.COLLECTIVE
        self._weighted_options = dataclasses.replace(
            opts, lowering=lowering, chunk_weights=self._device_weights)
        self.options = self._weighted_options
        self.monitor.spikes = 0

    def _plan_degraded(self) -> None:
        """The elastic escalation path: a persistent straggler means
        running degraded — plan the nearest valid mesh for one fewer
        device (floor 1) so the restart is a lookup, not a scramble."""
        self.stats.inc("evictions")
        n = max(1, math.prod(self.mesh.shape.values()) - 1)
        self.remesh_plan = plan_elastic_remesh(
            n, model_parallel=self._model_parallel)
        if self._on_evict is not None:
            self._on_evict(self.remesh_plan)

    def suggest_rebalance(self, num_chunks: int,
                          weights: list[float]) -> list[int]:
        """Straggler mitigation short of eviction: re-deal the cyclic
        chunks proportionally to observed per-device speed (the
        paper's dynamic-schedule over-decomposition answer), via
        :func:`repro_torch.runtime.straggler.rebalance_chunks`."""
        return rebalance_chunks(num_chunks, weights)

    def health(self) -> dict:
        """Liveness/degradation snapshot for an external supervisor."""
        return {
            "ewma_step_s": self.monitor.ewma,
            "spikes": self.monitor.spikes,
            "steps": self.monitor.steps,
            "degraded": self.remesh_plan is not None,
            "rebalanced": self._weighted_options is not None,
            "device_weights": self._device_weights,
            "remesh_plan": (dataclasses.asdict(self.remesh_plan)
                            if self.remesh_plan is not None else None),
            "inflight": len(self._inflight),
            "resident_programs": len(self._compiled),
        }

    # ---------------------------------------------------------- lifecycle --
    def shutdown(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None

    def __enter__(self) -> "CompileService":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
