"""The models — counterpart of :mod:`repro.models.model`: ``DecoderLM``
for the dense, SSM, MoE and hybrid families, ``EncDecLM`` for the
encoder-decoder family (whisper).

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
* ``model.loss_fn(params, batch) -> (loss, {"ce", "aux"})`` (per block
  of rows with ``parts``: a train step's per-rank shares);
* ``model.init_cache(batch, cache_len, dtype, device) -> cache``;
* ``model.cache_axes()`` — the cache tree's logical-axis twins;
* ``model.prefill(params, batch, cache) -> (logits, cache)``;
* ``model.decode_step(params, cache, tokens, pos) -> (logits, cache)``.

Caches are returned new (the caller's are left as they were), as the
reference's functional updates leave them.
"""
from __future__ import annotations

import torch
import torch.utils.checkpoint

from repro_torch.core import tensor_plan as tp
from repro_torch.mesh import resolve_device
from repro_torch.models import blocks as blk
from repro_torch.models.layers import (
    chunked_ce_sum,
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


def _closest_divisor(n: int) -> int:
    """Divisor of n closest to sqrt(n) (for two-level remat)."""
    best, target = 1, n ** 0.5
    for d in range(1, n + 1):
        if n % d == 0 and abs(d - target) < abs(best - target):
            best = d
    return best


def _checkpointed(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward pass."""
    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False)


def _stack_caches(caches):
    return {k: torch.stack([c[k] for c in caches]) for k in caches[0]}


def _index(tree, i):
    """Entry ``i`` of the leading dim of every leaf of a dict tree."""
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def next_token_loss(x, head, batch, aux, aux_weight, *, parts=None,
                    tokens=None):
    """The LM loss of hidden states ``x`` (B, S, D): the next-token CE
    over the tokens the mask keeps, their mean, + ``aux_weight`` x
    ``aux``.  Returns (loss, {"ce", "aux"}).

    ``tokens`` replaces the mean's denominator, so that the CE of a part
    of a larger batch, divided by that batch's token count, adds up to
    the batch's mean.  With ``parts`` the rows split into that many
    contiguous blocks, and loss, ce and aux come back per block, (parts,)
    each, the aux term split evenly: summed over the blocks they are the
    whole rows' (a train step's per-rank shares of one forward)."""
    labels, mask = batch["labels"][:, 1:], batch.get("mask")
    mask = None if mask is None else mask[:, 1:]
    rows = x.shape[0] // (parts or 1)
    ces = []
    for j in range(parts or 1):
        sl = slice(j * rows, (j + 1) * rows) if parts else slice(None)
        tot, cnt = chunked_ce_sum(x[sl, :-1], head, labels[sl],
                                  mask=None if mask is None else mask[sl])
        ces.append(tot / (torch.clamp(cnt, min=1.0) if tokens is None
                          else tokens))
    if parts:
        ce, aux = torch.stack(ces), (aux / parts).expand(parts)
    else:
        ce = ces[0]
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


class DecoderLM:
    #: the MoE aux loss's weight in :meth:`loss_fn`
    AUX_WEIGHT = 0.01

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
                groups=1, remat=False, compute_dtype=torch.bfloat16,
                shard_fn=None):
        """Full-sequence forward (training). Returns (hidden, aux).

        ``groups``: the MoE dispatch groups (the data-parallel degree in
        a train step).  ``shard_fn`` is applied to the residual stream
        after the embedding and after every slot block, where the
        reference pins its activations' sharding; None is the identity.

        ``remat`` recomputes each period's activations in the backward
        pass (``torch.utils.checkpoint``, non-reentrant) instead of
        keeping them; from 8 periods on, in two levels as the reference's
        sqrt-remat: segments of periods (a divisor of the period count
        near its square root) are checkpointed, and each period inside
        them, so O(sqrt(L)) activations are kept."""
        cfg = self.cfg
        sf = shard_fn or (lambda t: t)
        x = sf(self._embed(params, batch).to(compute_dtype))
        b, s, _ = x.shape
        if positions is None:
            positions = torch.arange(s, dtype=torch.int32,
                                     device=x.device).expand(b, s)

        def period(per, x, aux):
            for sidx, kind in enumerate(self.slot_kinds):
                p = _index(params["slots"][f"slot{sidx}"], per)
                x, _, a = blk.block_apply(p, x, cfg, kind,
                                          positions=positions, impl=impl,
                                          groups=groups)
                x = sf(x)
                aux = aux + a
            return x, aux

        def segment(first, count, x, aux):
            for per in range(first, first + count):
                x, aux = _checkpointed(period, per, x, aux)
            return x, aux

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if remat and self.n_periods >= 8:
            per_seg = self.n_periods // _closest_divisor(self.n_periods)
            for first in range(0, self.n_periods, per_seg):
                x, aux = _checkpointed(segment, first, per_seg, x, aux)
        else:
            for per in range(self.n_periods):
                x, aux = (_checkpointed(period, per, x, aux) if remat
                          else period(per, x, aux))
        for i, kind in enumerate(self.tail_kinds):
            def tail(x, aux, p=params["tail"][f"tail{i}"], kind=kind):
                x, _, a = blk.block_apply(p, x, cfg, kind,
                                          positions=positions, impl=impl,
                                          groups=groups)
                return x, aux + a
            x, aux = _checkpointed(tail, x, aux) if remat else tail(x, aux)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, aux

    def loss_fn(self, params, batch, *, impl="auto", groups=1, remat=False,
                compute_dtype=torch.bfloat16, aux_weight=AUX_WEIGHT,
                shard_fn=None, parts=None, tokens=None):
        """Next-token CE (+ ``aux_weight`` x the MoE aux loss). batch:
        tokens/embeds + labels (+ mask). Returns (loss, {"ce", "aux"});
        ``parts`` and ``tokens`` as :func:`next_token_loss` takes them."""
        x, aux = self.forward(params, batch, impl=impl, groups=groups,
                              remat=remat, compute_dtype=compute_dtype,
                              shard_fn=shard_fn)
        return next_token_loss(x, self._head_matrix(params), batch, aux,
                               aux_weight, parts=parts, tokens=tokens)

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

    def cache_axes(self):
        """Logical-axes twin tree of :meth:`init_cache`'s output."""
        cfg = self.cfg
        axes = {}
        for s, kind in enumerate(self.slot_kinds):
            axes[f"slot{s}"] = {k: (None,) + a for k, a in
                                blk.block_cache_axes(cfg, kind).items()}
        for i, kind in enumerate(self.tail_kinds):
            axes[f"tail{i}"] = blk.block_cache_axes(cfg, kind)
        return axes

    def _with_cache(self, params, x, caches, positions, decode_pos, impl,
                    groups=1, shard_fn=None):
        """Every layer with its cache; ``shard_fn`` after each slot block
        (not the tail's), where the reference's period scan applies it."""
        cfg = self.cfg
        sf = shard_fn or (lambda t: t)
        new: dict = {}
        for kind, p, key, per in self._layers(params):
            cache = caches[key] if per is None else _index(caches[key], per)
            x, nc, _ = blk.block_apply(p, x, cfg, kind, positions=positions,
                                       cache=cache, decode_pos=decode_pos,
                                       impl=impl, groups=groups)
            if per is None:
                new[key] = nc
            else:
                x = sf(x)
                new.setdefault(key, []).append(nc)
        new = {k: v if isinstance(v, dict) else _stack_caches(v)
               for k, v in new.items()}
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, new

    def prefill(self, params, batch, caches, *, impl="auto", groups=1,
                compute_dtype=torch.bfloat16, shard_fn=None):
        """Process a prompt, fill caches, return last-token logits.
        ``shard_fn`` is applied to the embedded prompt and after every
        slot block, as in :meth:`forward`; None is the identity."""
        sf = shard_fn or (lambda t: t)
        x = sf(self._embed(params, batch).to(compute_dtype))
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)
        x, new_caches = self._with_cache(params, x, caches, positions, None,
                                         impl, groups, shard_fn=shard_fn)
        logits = x[:, -1].float() @ self._head_matrix(params).float()
        return logits, new_caches

    def decode_step(self, params, caches, tokens, pos, *, impl="auto",
                    groups=1, compute_dtype=torch.bfloat16, shard_fn=None):
        """One decode step. tokens: (B,), pos: (B,) current positions.
        ``shard_fn`` is applied after every slot block (not to the
        embedded token, as in the reference)."""
        x = params["embed"][tokens.long()[:, None]].to(compute_dtype)
        pos = pos.to(torch.int32)
        x, new_caches = self._with_cache(params, x, caches, pos[:, None],
                                         pos, impl, groups,
                                         shard_fn=shard_fn)
        logits = x[:, 0].float() @ self._head_matrix(params).float()
        return logits, new_caches


class EncDecLM:
    """Whisper-style encoder-decoder — counterpart of the reference's
    ``EncDecLM``; the audio frontend is a stub: encoder inputs are
    precomputed (B, frames, d_model) embeddings.

    The parameter tree has the reference's keys and shapes: ``embed``,
    ``head``, ``enc_final_norm``, ``final_norm``, ``encoder`` (the
    encoder blocks, every leaf stacked over a leading LAYERS dim) and
    ``decoder`` (the decoder blocks with their ``cross`` sub-tree,
    stacked alike).  The cache is ``self`` (the decoder's KV caches,
    stacked) and ``cross_k``/``cross_v`` of shape (L, B, F, KV, hd)."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.n_enc = cfg.encoder.n_layers
        self.n_dec = cfg.n_layers

    # ------------------------------------------------------------- init --
    def init(self, gen: torch.Generator, dtype=torch.float32):
        """Random parameters drawn from ``gen`` (in float32), on its
        device, stored as ``dtype``: the encoder's layers, then the
        decoder's, then the embeddings, each layer cast as it is drawn
        (as :meth:`DecoderLM.init`)."""
        cfg = self.cfg
        kind = "attn:global:dense"
        enc = [_cast_tree(blk.init_block(gen, cfg, kind), dtype)
               for _ in range(self.n_enc)]
        dec = [_cast_tree(blk.init_block(gen, cfg, kind, with_cross=True),
                          dtype) for _ in range(self.n_dec)]
        dev = gen.device
        tree: dict = {
            "embed": _cast_tree(make_param(gen, (cfg.vocab_size, cfg.d_model),
                                           (tp.VOCAB, tp.D_MODEL)), dtype),
            "head": _cast_tree(make_param(gen, (cfg.d_model, cfg.vocab_size),
                                          (tp.D_MODEL, tp.VOCAB)), dtype),
            "enc_final_norm": zeros_param((cfg.d_model,), (tp.D_MODEL,),
                                          dtype=dtype, device=dev),
            "final_norm": zeros_param((cfg.d_model,), (tp.D_MODEL,),
                                      dtype=dtype, device=dev),
            "encoder": _stack_trees(enc),
            "decoder": _stack_trees(dec),
        }
        return split_tree(tree)

    # ----------------------------------------------------------- encoder --
    def encode(self, params, frames, *, impl="auto",
               compute_dtype=torch.bfloat16, remat=False):
        """The encoder's bidirectional blocks over the frames, then
        ``enc_final_norm``; rope turns q and k by the frame positions."""
        cfg = self.cfg
        x = frames.to(compute_dtype)
        b, s, _ = x.shape
        positions = torch.arange(s, dtype=torch.int32,
                                 device=x.device).expand(b, s)

        def layer(p, x):
            return blk.block_apply(p, x, cfg, "attn:global:dense",
                                   positions=positions, impl=impl,
                                   attn_mode="bidir")[0]
        for i in range(self.n_enc):
            p = _index(params["encoder"], i)
            x = _checkpointed(layer, p, x) if remat else layer(p, x)
        return rms_norm(x, params["enc_final_norm"], cfg.norm_eps)

    def _cross_kv(self, params, enc_h):
        """Per-decoder-layer cross K/V, each (L, B, F, KV, hd)."""
        cross = params["decoder"]["cross"]
        dtype = enc_h.dtype
        k = torch.einsum("bsd,ldhk->lbshk", enc_h, cross["wk"].to(dtype))
        v = torch.einsum("bsd,ldhk->lbshk", enc_h, cross["wv"].to(dtype))
        return k, v

    def _decoder(self, params, x, positions, decode_pos, caches, enc_kv,
                 impl, remat=False, shard_fn=None):
        """The decoder's blocks (with a KV cache unless ``caches`` is
        None), ``shard_fn`` after each, then ``final_norm``; returns
        (hidden, new self caches)."""
        cfg = self.cfg
        sf = shard_fn or (lambda t: t)
        ck, cv = enc_kv
        new = []
        for i in range(self.n_dec):
            p = _index(params["decoder"], i)
            cache = None if caches is None else _index(caches, i)

            def layer(p, x, ck, cv, cache=cache):
                x, nc, _ = blk.block_apply(
                    p, x, cfg, "attn:global:dense", positions=positions,
                    cache=cache, decode_pos=decode_pos, impl=impl,
                    enc_kv=(ck, cv))
                return sf(x), nc
            if remat:
                x, nc = _checkpointed(layer, p, x, ck[i], cv[i])
            else:
                x, nc = layer(p, x, ck[i], cv[i])
            new.append(nc)
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        return x, (None if caches is None else _stack_caches(new))

    def _tokens_in(self, params, tokens, compute_dtype):
        x = params["embed"][tokens.long()].to(compute_dtype)
        b, s, _ = x.shape
        return x, torch.arange(s, dtype=torch.int32,
                               device=x.device).expand(b, s)

    def loss_fn(self, params, batch, *, impl="auto", groups=1, remat=False,
                compute_dtype=torch.bfloat16, shard_fn=None, parts=None,
                tokens=None):
        """Next-token CE of the decoder over ``batch["tokens"]`` given
        ``batch["frames"]``; returns (loss, {"ce", "aux"}), aux 0.
        ``groups`` is taken as the reference takes it (its blocks are
        dense, so nothing reads it); ``shard_fn`` is applied to the
        encoder's output and after every decoder block; ``parts`` and
        ``tokens`` as :func:`next_token_loss` takes them."""
        sf = shard_fn or (lambda t: t)
        enc_h = sf(self.encode(params, batch["frames"], impl=impl,
                               compute_dtype=compute_dtype, remat=remat))
        enc_kv = self._cross_kv(params, enc_h)
        x, positions = self._tokens_in(params, batch["tokens"],
                                       compute_dtype)
        x, _ = self._decoder(params, x, positions, None, None, enc_kv, impl,
                             remat=remat, shard_fn=shard_fn)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        return next_token_loss(x, params["head"], batch, aux, 0.0,
                               parts=parts, tokens=tokens)

    # ------------------------------------------------------------- cache --
    def init_cache(self, batch: int, cache_len: int, dtype=torch.bfloat16,
                   device=None):
        """Empty caches on ``device`` (``None``: the CUDA card)."""
        cfg = self.cfg
        device = resolve_device(device)
        per = [blk.init_block_cache(cfg, "attn:global:dense", batch,
                                    cache_len, dtype, device)
               for _ in range(self.n_dec)]
        shape = (self.n_dec, batch, cfg.encoder.n_frames, cfg.n_kv_heads,
                 cfg.head_dim)
        return {"self": _stack_caches(per),
                "cross_k": torch.zeros(shape, dtype=dtype, device=device),
                "cross_v": torch.zeros(shape, dtype=dtype, device=device)}

    def cache_axes(self):
        """Logical-axes twin tree of :meth:`init_cache`'s output."""
        cross = (None, tp.BATCH, tp.FRAMES, tp.KV_HEADS, tp.HEAD_DIM)
        return {"self": {k: (None,) + a for k, a in blk.block_cache_axes(
                    self.cfg, "attn:global:dense").items()},
                "cross_k": cross, "cross_v": cross}

    def prefill(self, params, batch, caches, *, impl="auto", groups=1,
                compute_dtype=torch.bfloat16, shard_fn=None):
        """Encode frames, precompute cross KV, prefill the decoder prompt;
        returns (last-token logits, caches).  ``groups`` as in
        :meth:`loss_fn`; ``shard_fn`` is applied to the encoder's output,
        to the embedded prompt and after every decoder block."""
        sf = shard_fn or (lambda t: t)
        enc_h = sf(self.encode(params, batch["frames"], impl=impl,
                               compute_dtype=compute_dtype))
        ck, cv = self._cross_kv(params, enc_h)
        x, positions = self._tokens_in(params, batch["tokens"],
                                       compute_dtype)
        x, new_self = self._decoder(params, sf(x), positions, None,
                                    caches["self"], (ck, cv), impl,
                                    shard_fn=shard_fn)
        logits = x[:, -1].float() @ params["head"].float()
        return logits, {"self": new_self,
                        "cross_k": ck.to(caches["cross_k"].dtype),
                        "cross_v": cv.to(caches["cross_v"].dtype)}

    def decode_step(self, params, caches, tokens, pos, *, impl="auto",
                    groups=1, compute_dtype=torch.bfloat16, shard_fn=None):
        """One decode step. tokens: (B,), pos: (B,) current positions.
        Cross-attention takes ``impl`` (K2 under "kernel"); the cached
        self-attention always takes the materialised path.  ``groups`` as
        in :meth:`loss_fn`; ``shard_fn`` is applied after every decoder
        block."""
        x = params["embed"][tokens.long()[:, None]].to(compute_dtype)
        pos = pos.to(torch.int32)
        enc_kv = (caches["cross_k"].to(compute_dtype),
                  caches["cross_v"].to(compute_dtype))
        x, new_self = self._decoder(params, x, pos[:, None], pos,
                                    caches["self"], enc_kv, impl,
                                    shard_fn=shard_fn)
        logits = x[:, 0].float() @ params["head"].float()
        return logits, {**caches, "self": new_self}


def build_model(cfg):
    if cfg.family == "encdec":
        return EncDecLM(cfg)
    return DecoderLM(cfg)
