"""Fault-tolerant wrapper around :class:`~repro_torch.core.api.Compiled`
(counterpart of :mod:`repro.runtime.resilient`).

The generated MPI programs of the paper assume a healthy, fixed-size
communicator; a single lost rank kills the job.  The
:class:`ResilientExecutor` closes that gap at the runtime layer:

* **retry** — per-call retry with exponential backoff and seeded
  jitter absorbs transient faults (spurious device errors, injected
  delays, one-off NaN outputs when validation is on);
* **validation** — optional NaN/Inf screening of every inexact output
  leaf turns silent corruption into a retryable failure;
* **degraded-mesh recovery** — when a call fails persistently, the
  executor plans the nearest valid factoring for one fewer rank
  (:func:`~repro_torch.runtime.elastic.plan_elastic_remesh`).  The
  stacked mesh's virtual ranks are interchangeable, so whichever rank
  was lost the survivors are renumbered 0..n-2.  It builds the shrunk mesh on the same device, recompiles the *same*
  program through a single-flighted
  :class:`~repro_torch.serving.compile_service.CompileService` (hitting
  the structural cache when warm; under ``Lowering.KERNEL`` that
  generates and launches a new span kernel for the new mesh), re-places
  the inputs for the new mesh
  (:func:`~repro_torch.runtime.elastic.reshard_tree`) and re-runs.

Recovery is sticky: after a successful degraded run the executor keeps
serving from the shrunk mesh (the lost device is presumed gone) until
:meth:`ResilientExecutor.reset`.

Chunk-cyclic layouts make the recompile semantically a no-op for
element-wise and stencil outputs (bit-identical); reductions regroup
their per-device partial folds, so reduce keys match to float
tolerance — pinned by the differential tests in
``tests/test_torch_runtime.py``.
"""
from __future__ import annotations

import dataclasses
import math
import random
import time
from typing import Any, Callable, Mapping

import torch

from repro_torch.runtime.elastic import plan_elastic_remesh, reshard_tree


class CorruptOutputError(RuntimeError):
    """Output validation found non-finite values."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """How hard to try before declaring the mesh degraded.

    ``backoff_s`` is the first sleep; each further retry multiplies it
    by ``backoff_factor`` and adds uniform jitter in ``[0, jitter_s)``
    drawn from ``random.Random(seed)`` — deterministic, so a CI replay
    sleeps the same schedule."""

    max_retries: int = 2
    backoff_s: float = 0.0
    backoff_factor: float = 2.0
    jitter_s: float = 0.0
    seed: int = 0
    validate_outputs: bool = True

    def __post_init__(self) -> None:
        if self.max_retries < 0:
            raise ValueError(f"max_retries must be >= 0, got {self.max_retries}")
        if self.backoff_s < 0 or self.jitter_s < 0:
            raise ValueError("backoff_s and jitter_s must be >= 0")
        if self.backoff_factor < 1.0:
            raise ValueError(
                f"backoff_factor must be >= 1, got {self.backoff_factor}")


class ResilientExecutor:
    """Wrap a :class:`~repro_torch.core.api.Compiled` with retry, output
    validation and degraded-mesh recovery.

    ``on_recover`` (optional) is called with the
    :class:`~repro_torch.runtime.elastic.RemeshPlan` when recovery
    engages.
    ``stats`` counts ``calls`` / ``retries`` / ``validation_failures``
    / ``recoveries``.
    """

    def __init__(self, compiled, *, policy: RetryPolicy | None = None,
                 on_recover: Callable[..., None] | None = None) -> None:
        self.compiled = compiled
        self.policy = policy if policy is not None else RetryPolicy()
        self._rng = random.Random(self.policy.seed)
        self._on_recover = on_recover
        self.stats = {"calls": 0, "retries": 0, "validation_failures": 0,
                      "recoveries": 0}
        self.remesh_plan = None
        self._degraded: Any = None       # (CompileService, Mesh) once set

    # ------------------------------------------------------------- api --
    def run(self, env: Mapping[str, Any]) -> dict:
        self.stats["calls"] += 1
        if self._degraded is not None:
            return self._run_degraded(env)
        pol = self.policy
        delay = pol.backoff_s
        for attempt in range(pol.max_retries + 1):
            try:
                out = self.compiled.run(env)
                if pol.validate_outputs:
                    self._validate(out)
                return out
            except Exception:                # noqa: BLE001 — retry scope
                if attempt < pol.max_retries:
                    self.stats["retries"] += 1
                    sleep = delay
                    if pol.jitter_s:
                        sleep += self._rng.uniform(0.0, pol.jitter_s)
                    if sleep > 0:
                        time.sleep(sleep)
                    delay *= pol.backoff_factor
        return self._recover(env)

    __call__ = run

    @property
    def degraded(self) -> bool:
        return self._degraded is not None

    def reset(self) -> None:
        """Forget the degraded mesh (e.g. the fleet healed): the next
        call goes back to the original compiled artifact."""
        if self._degraded is not None:
            self._degraded[0].shutdown()
        self._degraded = None
        self.remesh_plan = None

    # ------------------------------------------------------ validation --
    def _validate(self, out: Mapping[str, Any]) -> None:
        bad = [k for k, v in out.items()
               if isinstance(v, torch.Tensor)
               and (v.is_floating_point() or v.is_complex())
               and not bool(torch.isfinite(v).all())]
        if bad:
            self.stats["validation_failures"] += 1
            raise CorruptOutputError(
                f"non-finite values in output keys {bad}")

    # -------------------------------------------------------- recovery --
    def _recover(self, env) -> dict:
        """Persistent failure: drop one rank, recompile on the shrunk
        mesh, re-place inputs, re-run.  A process mesh raises: its
        survivors would have to re-split the first axis over the
        processes, which is not built."""
        from repro_torch.mesh import ProcessMesh, make_mesh

        mesh = self.compiled.mesh
        if isinstance(mesh, ProcessMesh):
            raise NotImplementedError(
                f"degraded-mesh recovery on {mesh!r}: recovery across "
                "processes, where the survivors' first axis must still "
                "divide over the world, is ROADMAP.md §1 item 2 "
                "(\"Recovery across processes\"); a stacked mesh recovers")
        old_shape = tuple(mesh.shape[a] for a in mesh.axis_names)
        # a single-rank mesh has nothing to drop
        n_alive = max(1, math.prod(old_shape) - 1)

        mp = old_shape[1] if len(old_shape) > 1 else 1
        plan = plan_elastic_remesh(n_alive, model_parallel=mp,
                                   axes=mesh.axis_names)
        self.remesh_plan = plan
        new_shape = (plan.new_shape if len(old_shape) > 1
                     else (plan.new_shape[0] * plan.new_shape[1],))
        # the stacked mesh's virtual ranks are interchangeable: the
        # survivors are renumbered 0..n-1 on the same device, whichever
        # rank was lost
        new_mesh = make_mesh(new_shape, mesh.axis_names, device=mesh.device)

        options = self.compiled.options
        if options.chunk_weights is not None:
            # weights are per-rank of the *old* mesh — drop them
            options = dataclasses.replace(options, chunk_weights=None)

        from repro_torch.serving.compile_service import CompileService
        service = CompileService(new_mesh, options=options)
        out = service.run(self.compiled.program,
                          self._replace_env(env, new_mesh))
        # only now (recovery succeeded) commit to the degraded mesh
        self._degraded = (service, new_mesh, options)
        self.stats["recoveries"] += 1
        if self._on_recover is not None:
            self._on_recover(plan)
        if self.policy.validate_outputs:
            self._validate(out)
        return out

    def _run_degraded(self, env) -> dict:
        service, new_mesh, options = self._degraded
        return service.run(self.compiled.program,
                           self._replace_env(env, new_mesh), options)

    @staticmethod
    def _replace_env(env, new_mesh) -> dict:
        """Re-place every input leaf replicated for the new mesh — the
        elastic invariant: a restore under a different mesh is a
        re-placement, not a reshape."""
        return reshard_tree(dict(env), new_mesh)
