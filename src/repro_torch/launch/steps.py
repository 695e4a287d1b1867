"""The train step — counterpart of
:func:`repro.launch.steps.make_train_cell`, at one rank.

The step differentiates ``model.loss_fn`` with ``torch.autograd``,
accumulates gradients over microbatches, clips them by their global
norm, takes the learning rate from the cosine schedule and applies the
optimizer; its metrics are the reference's (``loss``, ``ce``, ``aux``,
``grad_norm``, ``lr``).  The tensor planner's shardings, activation
constraints and ZeRO-3 need more than one rank and come with the
``torch.distributed`` backend; at one rank the step applies none.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.configs import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import build_model
from repro_torch.optim import (clip_by_global_norm, cosine_warmup,
                               make_optimizer)
from repro_torch.pytree import tree_map

#: What a step over more than one rank needs (named by the refusals).
DISTRIBUTED = "the torch.distributed backend for Mesh (ROADMAP.md §1)"


@dataclasses.dataclass
class CellSpec:
    """A train step, its model and optimizer, and its microbatch count."""

    step_fn: Any              # (params, opt_state, batch, step) -> ...
    model: Any
    optimizer: Any
    n_micro: int = 1


def choose_microbatch(cfg: ModelConfig, shape: ShapeConfig,
                      dp: int, *, budget_gb: float = 3.0) -> int:
    """Split the per-device batch so rematerialised activations fit.

    Rough per-microbatch activation estimate: one (B_loc, S, d_model)
    residual per layer in bf16, x4 for block intermediates kept live
    during the rematerialised backward."""
    b_loc = max(1, shape.global_batch // dp)
    per_seq = shape.seq_len * cfg.d_model * 2 * 4 * cfg.n_layers
    micro = 1
    while (b_loc // micro > 1
           and b_loc % (micro * 2) == 0
           and b_loc // micro * per_seq > budget_gb * 2**30):
        micro *= 2
    return micro


def make_train_cell(cfg: ModelConfig, shape: ShapeConfig,
                    train_cfg: TrainConfig, *, attn_impl="auto") -> CellSpec:
    """The train step of ``cfg`` at one rank."""
    model = build_model(cfg)
    opt = make_optimizer(train_cfg.optimizer,
                         weight_decay=train_cfg.weight_decay)
    compute_dtype = (torch.bfloat16 if train_cfg.compute_dtype == "bfloat16"
                     else torch.float32)
    n_micro = train_cfg.microbatch or choose_microbatch(cfg, shape, 1)

    def loss_of(params, batch):
        return model.loss_fn(params, batch, impl=attn_impl,
                             remat=train_cfg.remat,
                             compute_dtype=compute_dtype)

    def train_step(params, opt_state, batch, step):
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        if n_micro > 1:
            # strided split (B -> (B/n, n) -> (n, B/n)), as the reference
            micro = tree_map(
                lambda x: x.reshape((x.shape[0] // n_micro, n_micro)
                                    + x.shape[1:]).transpose(0, 1), batch)
            tot = aux = 0.0
            for i in range(n_micro):
                loss_i, m = loss_of(leaves, tree_map(lambda x: x[i], micro))
                (loss_i / n_micro).backward()
                tot = tot + loss_i.detach()
                aux = aux + m["aux"].detach()
            loss = tot / n_micro
            metrics = {"ce": loss, "aux": aux / n_micro}
        else:
            loss, m = loss_of(leaves, batch)
            loss.backward()
            loss = loss.detach()
            metrics = {"ce": m["ce"].detach(), "aux": m["aux"].detach()}
        grads = tree_map(lambda p: p.grad if p.grad is not None
                         else torch.zeros_like(p), leaves)
        grads, gnorm = clip_by_global_norm(grads, train_cfg.grad_clip)
        lr = cosine_warmup(step, base_lr=train_cfg.learning_rate,
                           warmup_steps=train_cfg.warmup_steps,
                           total_steps=train_cfg.total_steps).to(loss.device)
        params, opt_state = opt.update(grads, opt_state, params, lr)
        return params, opt_state, dict(metrics, loss=loss, grad_norm=gnorm,
                                       lr=lr)

    return CellSpec(train_step, model, opt, n_micro)
