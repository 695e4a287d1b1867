"""Checkpointing substrate (fault-tolerance backbone), in the
reference's on-disk layout, so each package restores a checkpoint that
the other wrote:

* a checkpoint is a directory ``step_<N>/`` (N zero-padded to 8 digits)
  holding one ``shard_<host>.npz`` per host plus a ``manifest.json``
  (leaf names, shapes, dtypes, step, host count, extra);
* a leaf's name is its path in the tree, the reference's
  (``jax.tree_util.tree_flatten_with_path``: dict keys in sorted order,
  tuple indices), e.g. ``0/slots/slot0/attn/wq`` for a (params, opt
  state) pair;
* every host writes its shard into ``step_<N>.tmp/``; after a barrier
  (every shard written) host 0 writes the manifest and atomically
  renames the directory, and a second barrier holds every host until the
  step is committed — a crash mid-save never corrupts the latest good
  checkpoint, a torn ``.tmp`` directory is never listed, and no host
  removes another's shard (hosts that share the directory must pass
  ``barrier``);
* ``save_async`` copies the leaves to host memory, then serialises them
  in a background thread (one outstanding save at a time);
* ``restore_latest`` finds the newest complete step;
* ``keep`` bounds disk use (older steps are removed after a save).

bfloat16 leaves (which numpy has no type for) are stored as their 16-bit
patterns and the manifest names them ``bfloat16``.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any

import numpy as np
import torch

from repro_torch.pytree import flatten_with_paths, unflatten_like


def _to_numpy(leaf) -> tuple[np.ndarray, str]:
    """(array to store, dtype name for the manifest)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        a = t.numpy()
    else:
        a = np.asarray(leaf)
    return a, str(a.dtype)


def _from_numpy(arr: np.ndarray, dtype_name: str, like) -> Any:
    if dtype_name == "bfloat16":
        bits = np.ascontiguousarray(arr).view(np.int16)
        t = torch.from_numpy(bits.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 host_id: int = 0, num_hosts: int = 1,
                 barrier=None) -> None:
        if num_hosts > 1 and barrier is None:
            raise ValueError(
                f"{num_hosts} hosts that share a checkpoint directory need a "
                "barrier: the step is committed once every shard is written")
        self.directory = directory
        self.keep = keep
        self.host_id = host_id
        self.num_hosts = num_hosts
        #: called by every host at once (``None``: one host)
        self.barrier = barrier
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ----------------------------------------------------------- saving --
    def save(self, step: int, tree: Any, *, extra: dict | None = None) -> str:
        self.wait()
        names, leaves = flatten_with_paths(tree)
        return self._write(step, names, [_to_numpy(l) for l in leaves],
                           extra or {})

    def save_async(self, step: int, tree: Any,
                   *, extra: dict | None = None) -> None:
        """Snapshot to host memory, serialise in the background."""
        self.wait()
        names, leaves = flatten_with_paths(tree)
        host = [_to_numpy(l) for l in leaves]
        self._thread = threading.Thread(
            target=self._write, args=(step, names, host, extra or {}),
            daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _write(self, step: int, names, host, extra: dict) -> str:
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + ".tmp"
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, f"shard_{self.host_id}.npz"),
                 **{n: a for n, (a, _) in zip(names, host)})
        if self.barrier is not None:
            self.barrier()                  # every host's shard is written
        if self.host_id == 0:
            self._commit(step, names, host, extra, tmp, final)
        if self.barrier is not None:
            self.barrier()                  # committed before anyone goes on
        return final

    def _commit(self, step, names, host, extra, tmp, final) -> None:
        """The manifest, and the step directory renamed into place."""
        manifest = {
            "step": step,
            "num_hosts": self.num_hosts,
            "names": names,
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [d for _, d in host],
            "extra": extra,
        }
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.replace(tmp, final)
        self._gc()

    def _gc(self) -> None:
        steps = self.list_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # --------------------------------------------------------- restoring --
    def list_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_") and "tmp" not in name:
                path = os.path.join(self.directory, name, "manifest.json")
                if os.path.exists(path):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def manifest(self, step: int) -> dict:
        with open(os.path.join(self.directory, f"step_{step:08d}",
                               "manifest.json")) as f:
            return json.load(f)

    def restore(self, step: int, like: Any, *, shard: int | None = None
                ) -> Any:
        """Restore into the structure of ``like`` (names and shapes
        checked), each leaf on ``like``'s device in its type, from this
        host's shard (or ``shard``'s)."""
        final = os.path.join(self.directory, f"step_{step:08d}")
        manifest = self.manifest(step)
        names, leaves = flatten_with_paths(like)
        if names != manifest["names"]:
            raise ValueError("checkpoint/model tree mismatch")
        dtypes = dict(zip(manifest["names"], manifest["dtypes"]))
        restored = []
        shard = self.host_id if shard is None else shard
        with np.load(os.path.join(final, f"shard_{shard}.npz")) as data:
            for n, l in zip(names, leaves):
                arr = data[n]
                if tuple(arr.shape) != tuple(np.shape(l)):
                    raise ValueError(
                        f"shape mismatch for {n}: ckpt {arr.shape} vs model "
                        f"{tuple(np.shape(l))}")
                restored.append(_from_numpy(arr, dtypes[n], l))
        return unflatten_like(like, restored)

    def restore_latest(self, like: Any) -> tuple[int, Any] | None:
        steps = self.list_steps()
        if not steps:
            return None
        step = steps[-1]
        return step, self.restore(step, like)
