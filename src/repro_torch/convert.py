"""Carry an environment, a parameter tree or a cache across between the
JAX package and the port.

The JAX package's envs are dicts of arrays; given as numpy, they map
into the port with :func:`env_from_numpy` and back with
:func:`env_to_numpy`.  Its model parameter and cache trees (nested dicts
of arrays, the same keys and shapes in both packages: an MoE layer's
``router``, ``w_gate``/``w_up``/``w_down``, ``shared``, ``shared_gate``
and ``dense`` as well, and a hybrid's SSM ``h``/``conv`` caches beside
the KV caches; an encoder-decoder's ``encoder``/``decoder`` stacks with
their ``cross`` sub-trees, and its ``self``/``cross_k``/``cross_v``
cache) map in with :func:`params_from_numpy` / :func:`cache_from_numpy`
and back with :func:`tree_to_numpy`; so do the optimizers' states
(AdamW's ``m``/``v``/``count``, Adafactor's ``per_param`` ``v`` or
``vr``/``vc`` and bfloat16 ``m``).  JAX computes in 32 bits by default (float32,
int32), so 64-bit numpy values narrow to 32 bits on the way in, as
``jnp.asarray`` would narrow them; a 0-d value stays a 0-d tensor.
"""
from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from repro_torch.mesh import resolve_device

_NARROW = {np.dtype(np.float64): np.dtype(np.float32),
           np.dtype(np.int64): np.dtype(np.int32),
           np.dtype(np.uint64): np.dtype(np.uint32)}


def to_tensor(value: Any, device) -> torch.Tensor:
    """One env value as a tensor on ``device`` with JAX's default
    widths (Python floats -> float32, ints -> int32)."""
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":    # JAX's numpy bfloat16: by its bits
        bits = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16).to(device)
    arr = arr.astype(_NARROW.get(arr.dtype, arr.dtype), copy=False)
    return torch.as_tensor(arr.copy(order="C"), device=device)


def env_from_numpy(env_np: Mapping[str, Any], device) -> dict:
    """``{name: array-like}`` -> ``{name: tensor on device}``."""
    return {k: to_tensor(v, device) for k, v in env_np.items()}


def env_to_numpy(env: Mapping[str, Any]) -> dict:
    """``{name: tensor}`` -> ``{name: numpy array}`` (on the host)."""
    return {k: (v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v)) for k, v in env.items()}


def _tree_from_numpy(tree, device):
    if isinstance(tree, Mapping):
        return {k: _tree_from_numpy(v, device) for k, v in tree.items()}
    return to_tensor(tree, device)


def params_from_numpy(tree, device=None) -> dict:
    """The JAX package's parameter tree (numpy leaves) as the port's:
    the same keys, every leaf a tensor on ``device`` (``None``: the CUDA
    card, as :func:`repro_torch.mesh.resolve_device` says)."""
    return _tree_from_numpy(tree, resolve_device(device))


def cache_from_numpy(tree, device=None) -> dict:
    """The JAX package's KV-cache tree (numpy leaves: k, v and the int32
    positions) as the port's, name for name, on ``device`` (``None``:
    the CUDA card)."""
    return _tree_from_numpy(tree, resolve_device(device))


def tree_to_numpy(tree):
    """A nested dict of tensors as the same dict of numpy arrays (a
    bfloat16 tensor, which numpy has no type for, as its float32
    values)."""
    if isinstance(tree, Mapping):
        return {k: tree_to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
