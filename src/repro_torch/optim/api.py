"""Uniform optimizer facade used by the train step
(:mod:`repro_torch.launch.steps`)."""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.optim.adafactor import (_factored_dims, adafactor_init,
                                         adafactor_update)
from repro_torch.optim.adamw import adamw_init, adamw_update


@dataclasses.dataclass(frozen=True)
class Optimizer:
    name: str
    init: Callable[[Any], Any]
    update: Callable[..., tuple]      # (grads, state, params, lr=) -> (p, s)


def make_optimizer(name: str, *, weight_decay: float = 0.1) -> Optimizer:
    if name == "adamw":
        return Optimizer(
            "adamw", adamw_init,
            lambda g, s, p, lr: adamw_update(
                g, s, p, lr=lr, weight_decay=weight_decay))
    if name == "adafactor":
        return Optimizer(
            "adafactor", adafactor_init,
            lambda g, s, p, lr: adafactor_update(
                g, s, p, lr=lr, weight_decay=0.0))
    raise ValueError(f"unknown optimizer {name!r}")


def opt_state_axes(name: str, params_shapes, params_axes):
    """Logical-axes tree matching the optimizer state's structure (each
    state leaf takes its parameter's axes, less a factored-out dim).
    ``params_shapes``: a tree of anything with ``.shape``."""
    if name == "adamw":
        return {"m": params_axes, "v": params_axes, "count": ()}
    if name == "adafactor":
        def per_param(shape_struct, axes):
            dims = _factored_dims(shape_struct.shape)
            if dims is None:
                return {"v": axes}
            d0, d1 = dims
            return {"vr": tuple(a for i, a in enumerate(axes) if i != d1),
                    "vc": tuple(a for i, a in enumerate(axes) if i != d0)}
        return {"per_param": _axes_map(per_param, params_shapes,
                                       params_axes), "count": ()}
    raise ValueError(f"unknown optimizer {name!r}")


def _axes_map(fn, shapes, axes):
    """``fn(shape, axes)`` per parameter (an axes tree's leaves are
    tuples, which :func:`repro_torch.pytree.tree_map` would walk
    into)."""
    if isinstance(shapes, dict):
        return {k: _axes_map(fn, shapes[k], axes[k]) for k in shapes}
    return fn(shapes, axes)
