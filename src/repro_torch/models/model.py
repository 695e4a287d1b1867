"""The decoder-only LM — counterpart of :mod:`repro.models.model`'s
``DecoderLM``, for the dense, SSM, MoE and hybrid families (its training
loss and the encoder-decoder model belong to later slices of the port).

The parameter tree has the reference's keys and shapes: ``embed``,
``final_norm``, ``head`` (untied), ``slots/slot<s>`` with every leaf
stacked over a leading LAYERS dim (one entry per period), ``tail/tail<i>``
for the remainder.  The reference scans over periods; here a Python loop
walks the leading dim.

API (used by :mod:`repro_torch.serving` and :mod:`repro_torch.launch`):

* ``model.init(generator, dtype=float32) -> (params, axes)`` — the
  tensors lie on the generator's device; axes are the logical-axis
  twins;
* ``model.forward(params, batch) -> (hidden, aux)``;
* ``model.init_cache(batch, cache_len, dtype, device) -> cache``;
* ``model.prefill(params, batch, cache) -> (logits, cache)``;
* ``model.decode_step(params, cache, tokens, pos) -> (logits, cache)``.

Caches are returned new (the caller's are left as they were), as the
reference's functional updates leave them.
"""
from __future__ import annotations

import torch

from repro_torch.core import tensor_plan as tp
from repro_torch.mesh import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    is_param_leaf,
    make_param,
    rms_norm,
    split_tree,
    zeros_param,
)


def _stack_trees(trees):
    """Stack (tensor, axes) trees over a new leading LAYERS dim."""
    first = trees[0]
    if is_param_leaf(first):
        return (torch.stack([t[0] for t in trees]), (tp.LAYERS,) + first[1])
    return {k: _stack_trees([t[k] for t in trees]) for k in first}


def _cast_tree(tree, dtype):
    """An init tree's (tensor, axes) leaves as ``dtype``."""
    if is_param_leaf(tree):
        return (tree[0] if tree[0].dtype == dtype else tree[0].to(dtype),
                tree[1])
    return {k: _cast_tree(v, dtype) for k, v in tree.items()}


def _stack_caches(caches):
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _index(tree, i):
    """Entry ``i`` of the leading dim of every leaf of a dict tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


class DecoderLM:
    def __init__(self, cfg):
        self.cfg = cfg
        (self.period, self.slot_kinds, self.n_periods,
         self.tail_kinds) = blk.period_structure(cfg)

    # ------------------------------------------------------------- init --
    def init(self, gen: torch.Generator, dtype=torch.float32):
        """Random parameters drawn from ``gen`` (in float32), on its
        device, stored as ``dtype``; layer by layer in order, then the
        embeddings.  Each layer is cast as soon as it is drawn, so a
        16-bit model never holds all its weights in float32 (qwen2-moe's
        14.3 B parameters fit the card in bfloat16)."""
        cfg = self.cfg
        layers = [_cast_tree(blk.init_block(gen, cfg,
                                            blk.kind_of_layer(cfg, i)), dtype)
                  for i in range(cfg.n_layers)]
        tree: dict = {
            "embed": _cast_tree(make_param(gen, (cfg.vocab_size, cfg.d_model),
                                           (tp.VOCAB, tp.D_MODEL),
                                           scale=0.02), dtype),
            "final_norm": zeros_param((cfg.d_model,), (tp.D_MODEL,),
                                      dtype=dtype, device=gen.device),
        }
        if not cfg.tie_embeddings:
            tree["head"] = _cast_tree(make_param(
                gen, (cfg.d_model, cfg.vocab_size), (tp.D_MODEL, tp.VOCAB),
                scale=0.02), dtype)
        tree["slots"] = {
            f"slot{s}": _stack_trees([layers[per * self.period + s]
                                      for per in range(self.n_periods)])
            for s in range(len(self.slot_kinds))}
        base = self.n_periods * self.period
        if self.tail_kinds:
            tree["tail"] = {f"tail{i}": layers[base + i]
                            for i in range(len(self.tail_kinds))}
        return split_tree(tree)

    # ----------------------------------------------------------- helpers --
    def _head_matrix(self, params):
        if self.cfg.tie_embeddings:
            return params["embed"].T
        return params["head"]

    def _embed(self, params, batch):
        if "embeds" in batch:
            return batch["embeds"]
        return params["embed"][batch["tokens"].long()]

    def _layers(self, params):
        """(kind, params, cache key, period index or None) of every layer
        in order; the cache of a slot layer is entry ``per`` of its
        slot's stack."""
        for per in range(self.n_periods):
            for s, kind in enumerate(self.slot_kinds):
                key = f"slot{s}"
                yield kind, _index(params["slots"][key], per), key, per
        for i, kind in enumerate(self.tail_kinds):
            key = f"tail{i}"
            yield kind, params["tail"][key], key, None

    # ----------------------------------------------------------- forward --
    def forward(self, params, batch, *, positions=None, impl="auto",
                compute_dtype=torch.bfloat16):
        """Full-sequence forward. Returns (hidden, aux)."""
        cfg = self.cfg
        x = self._embed(params, batch).to(compute_dtype)
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for kind, p, _, _ in self._layers(params):
            x, _, a = blk.block_apply(p, x, cfg, kind, positions=positions,
                                      impl=impl)
            aux = aux + a
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, aux

    # ------------------------------------------------------------- cache --
    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device=None):
        """Empty caches on ``device`` (``None``: the CUDA card)."""
        cfg = self.cfg
        device = resolve_device(device)
        caches = {}
        for s, kind in enumerate(self.slot_kinds):
            per = [blk.init_block_cache(cfg, kind, batch, cache_len, dtype,
                                        device)
                   for _ in range(self.n_periods)]
            caches[f"slot{s}"] = _stack_caches(per)
        for i, kind in enumerate(self.tail_kinds):
            caches[f"tail{i}"] = blk.init_block_cache(
                cfg, kind, batch, cache_len, dtype, device)
        return caches

    def _with_cache(self, params, x, caches, positions, decode_pos, impl):
        cfg = self.cfg
        new: dict = {}
        for kind, p, key, per in self._layers(params):
            cache = caches[key] if per is None else _index(caches[key], per)
            x, nc, _ = blk.block_apply(p, x, cfg, kind, positions=positions,
                                       cache=cache, decode_pos=decode_pos,
                                       impl=impl)
            if per is None:
                new[key] = nc
            else:
                new.setdefault(key, []).append(nc)
        new = {k: v if isinstance(v, dict) else _stack_caches(v)
               for k, v in new.items()}
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, new

    def prefill(self, params, batch, caches, *, impl="auto",
                compute_dtype=torch.bfloat16):
        """Process a prompt, fill caches, return last-token logits."""
        x = self._embed(params, batch).to(compute_dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        x, new_caches = self._with_cache(params, x, caches, positions, None,
                                         impl)
        logits = x[:, -1].float() @ self._head_matrix(params).float()
        return logits, new_caches

    def decode_step(self, params, caches, tokens, pos, *, impl="auto",
                    compute_dtype=torch.bfloat16):
        """One decode step. tokens: (B,), pos: (B,) current positions."""
        x = params["embed"][tokens.long()[:, None]].to(compute_dtype)
        pos = pos.to(torch.int32)
        x, new_caches = self._with_cache(params, x, caches, pos[:, None],
                                         pos, impl)
        logits = x[:, 0].float() @ self._head_matrix(params).float()
        return logits, new_caches


_MISSING = {"encdec": "repro_torch.models.model.EncDecLM"}


def build_model(cfg):
    if cfg.family in _MISSING:
        raise blk.not_ported(f"{cfg.name} (family {cfg.family!r})",
                             _MISSING[cfg.family])
    return DecoderLM(cfg)
