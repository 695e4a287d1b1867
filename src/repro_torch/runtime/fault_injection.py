"""Deterministic fault injection for the distributed executors
(counterpart of :mod:`repro.runtime.fault_injection`).

The paper's pipeline stops at code generation — it never asks what
happens when a generated rank *dies* mid-run.  This module makes that
question testable: a :class:`FaultPlan` is a seeded, reproducible
script of faults (device loss, output corruption, artificial delay)
pinned to exact call indices and hook sites, and :func:`inject`
installs it into the hook points the executors already carry
(``repro_torch.core.api._fault_hook`` /
``repro_torch.core.transform._fault_hook``).

Hook sites (fired per :meth:`Compiled.run
<repro_torch.core.api.Compiled.run>` call):

* ``"run"``        — entry of ``Compiled.run`` (also advances the call
  counter),
* ``"run_exit"``   — exit of ``Compiled.run``; the hook's return value
  replaces the output dict, which is how ``"nan"`` corruption lands,
* ``"collective"`` / ``"collective2"`` — entry of the rank-1 / rank-2
  chunk-cyclic collective executors (the kernel lowering's blocks pass
  through them too),
* ``"region"`` / ``"region2"``         — entry of the rank-1 / rank-2
  fused region executors.

Injection is process-local and
scoped: :func:`inject` is a context manager that restores the previous
hooks on exit, so a crashed test cannot leak faults into the next one.
"""
from __future__ import annotations

import contextlib
import dataclasses
import random
import time
from typing import Iterator

KINDS = ("device_loss", "nan", "delay")
SITES = ("run", "collective", "collective2", "region", "region2")


class DeviceLossError(RuntimeError):
    """An injected (or detected) loss of a device mid-execution."""


@dataclasses.dataclass(frozen=True)
class FaultSpec:
    """One scripted fault: at ``Compiled.run`` call number ``call``
    (0-based), at hook ``site``, do ``kind``.

    ``rank`` is bookkeeping — which device is deemed to have failed —
    consumed by recovery logic, not by the injector.  ``"nan"`` faults
    always land at ``run_exit`` of their call (output corruption has no
    executor-interior analogue), so they require ``site == "run"``.
    """

    call: int
    kind: str = "device_loss"
    site: str = "run"
    rank: int = 0
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.kind not in KINDS:
            raise ValueError(f"kind must be one of {KINDS}, got {self.kind!r}")
        if self.site not in SITES:
            raise ValueError(f"site must be one of {SITES}, got {self.site!r}")
        if self.call < 0:
            raise ValueError(f"call must be >= 0, got {self.call}")
        if self.kind == "nan" and self.site != "run":
            raise ValueError(
                "kind='nan' corrupts outputs at run_exit; site must be 'run'")
        if self.kind == "delay" and self.delay_s < 0:
            raise ValueError(f"delay_s must be >= 0, got {self.delay_s}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """An immutable script of :class:`FaultSpec`\\ s.  Two plans built
    from the same seed are identical, so a failure seen in CI replays
    bit-for-bit locally."""

    specs: tuple[FaultSpec, ...] = ()

    @classmethod
    def seeded(cls, seed: int, *, calls: int, rate: float = 0.25,
               kinds=KINDS, sites=("run",), n_ranks: int = 1,
               delay_s: float = 0.005) -> "FaultPlan":
        """Draw a reproducible plan: each of ``calls`` run() calls
        faults with probability ``rate``; kind/site/rank drawn from the
        given pools with ``random.Random(seed)``."""
        rng = random.Random(seed)
        specs = []
        for call in range(calls):
            if rng.random() >= rate:
                continue
            kind = rng.choice(tuple(kinds))
            site = "run" if kind == "nan" else rng.choice(tuple(sites))
            specs.append(FaultSpec(
                call=call, kind=kind, site=site,
                rank=rng.randrange(max(1, n_ranks)),
                delay_s=delay_s if kind == "delay" else 0.0))
        return cls(specs=tuple(specs))

    def at_call(self, call: int) -> tuple[FaultSpec, ...]:
        return tuple(s for s in self.specs if s.call == call)


def _poison(out):
    """Corrupt every floating leaf of an output env with one NaN — the
    signature of a silently-misbehaving device."""
    import torch

    def bad(x):
        if not (isinstance(x, torch.Tensor) and (
                x.is_floating_point() or x.is_complex())):
            return x
        x = x.clone(memory_format=torch.contiguous_format)
        x.view(-1)[:1] = float("nan")
        return x

    return {k: bad(v) for k, v in dict(out).items()}


class Injector:
    """The installed hook: counts ``Compiled.run`` calls and fires the
    plan's matching specs.  ``fired`` records ``(call, spec)`` in order
    — tests assert the script executed exactly as written."""

    def __init__(self, plan: FaultPlan) -> None:
        self.plan = plan
        self.calls = 0                  # completed "run" entries seen
        self.fired: list[tuple[int, FaultSpec]] = []

    def call_count(self) -> int:
        return self.calls

    def __call__(self, site: str, out=None):
        if site == "run":
            self.calls += 1
        cur = self.calls - 1
        if cur < 0:           # executor fired outside any run() (warmup)
            return out if site == "run_exit" else None
        for spec in self.plan.at_call(cur):
            if site == "run_exit":
                if spec.kind == "nan":
                    self.fired.append((cur, spec))
                    out = _poison(out)
                continue
            if spec.site != site:
                continue
            if spec.kind == "delay":
                self.fired.append((cur, spec))
                time.sleep(spec.delay_s)
            elif spec.kind == "device_loss":
                self.fired.append((cur, spec))
                raise DeviceLossError(
                    f"injected device loss: rank {spec.rank} at call "
                    f"{cur} (site {site!r})")
        return out if site == "run_exit" else None


@contextlib.contextmanager
def inject(plan: FaultPlan) -> Iterator[Injector]:
    """Install ``plan`` into the executor hook points for the duration
    of the ``with`` block; previous hooks are restored on exit."""
    from repro_torch.core import api, transform

    inj = Injector(plan)
    prev_api, prev_tf = api._fault_hook, transform._fault_hook
    api._fault_hook = inj
    transform._fault_hook = inj
    try:
        yield inj
    finally:
        api._fault_hook = prev_api
        transform._fault_hook = prev_tf
