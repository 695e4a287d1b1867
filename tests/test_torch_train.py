"""Training in the PyTorch port on the CPU, held against the JAX package:
``loss_fn`` and its gradients (``torch.autograd`` against
``jax.value_and_grad``) for one dense (gemma3-1b), one MoE (qwen2-moe,
with its aux loss), the SSM (mamba2-130m) and the encoder-decoder
(whisper-small) smoke config, in float32 with the same weights drawn
with numpy into the reference's tree.  ``tests/test_torch_train_step.py``
holds the chunked cross-entropy and one train step, and
``tests/test_torch_remat.py`` remat.  Tolerances: loss rtol 1e-5;
gradients rtol = atol = 1e-4 (the MoE's, whose capacity slots see float
sums in another order, 2e-4).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as jsmoke_config
from repro.models import build_model as jbuild_model

from tests._torch_threads import one_torch_thread  # noqa: F401

ARCHS = ("gemma3-1b", "qwen2-moe-a2.7b", "mamba2-130m", "whisper-small")
B, S = 2, 24


def _tree_close(got, want, tol, label=""):
    from repro_torch import convert

    if isinstance(want, dict):
        assert set(got) == set(want), (label, sorted(got), sorted(want))
        for k in want:
            _tree_close(got[k], want[k], tol, f"{label}/{k}")
        return
    got = convert.tree_to_numpy(got) if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol,
                               err_msg=label)


@functools.lru_cache(maxsize=None)
def _setup(arch, n_layers=None):
    """(jax model, jax params, port model, port params, numpy batch)."""
    from repro_torch import convert
    from repro_torch.configs import smoke_config
    from repro_torch.models import build_model

    jcfg, cfg = jsmoke_config(arch), smoke_config(arch)
    if n_layers is not None:
        jcfg = dataclasses.replace(jcfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    jmodel = jbuild_model(jcfg)
    shapes = jax.eval_shape(lambda k: jmodel.init(k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(ARCHS.index(arch))
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.zeros(s.shape, np.float32)
        if "norm" in jax.tree_util.keystr(path)
        else (rng.normal(size=s.shape) * 0.05).astype(np.float32), shapes)
    tokens = rng.integers(1, cfg.vocab_size, size=(B, S)).astype(np.int32)
    batch = {"tokens": tokens, "labels": tokens,
             "mask": (rng.random((B, S)) < 0.8)}
    if cfg.family == "encdec":
        batch["frames"] = (rng.normal(size=(B, cfg.encoder.n_frames,
                                            cfg.d_model)) * 0.1).astype(
            np.float32)
    return (jmodel, jax.tree_util.tree_map(jnp.asarray, np_params),
            build_model(cfg), convert.params_from_numpy(np_params, "cpu"),
            batch)


def _port_value_and_grad(model, params, batch, **kw):
    leaves = jax.tree_util.tree_map(lambda p: p.detach().requires_grad_(),
                                    params)
    loss, metrics = model.loss_fn(leaves, batch, **kw)
    loss.backward()
    metrics = {k: v.detach() for k, v in metrics.items()}
    return loss.detach(), metrics, jax.tree_util.tree_map(
        lambda p: p.grad, leaves)


def _torch_batch(batch):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def _reference_value_and_grad(arch):
    jmodel, jparams, _, _, batch = _setup(arch)
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: jmodel.loss_fn(p, b, compute_dtype=jnp.float32),
        has_aux=True))
    (loss, metrics), grads = fn(jparams, jax.tree_util.tree_map(
        jnp.asarray, batch))
    return loss, metrics, grads


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch):
    """The loss (next-token CE over the masked tokens, + 0.01 x the MoE
    aux loss), its ``ce`` and ``aux`` metrics and the gradient of every
    parameter."""
    _, _, model, params, batch = _setup(arch)
    want_loss, want_m, want_g = _reference_value_and_grad(arch)
    loss, m, grads = _port_value_and_grad(model, params, _torch_batch(batch),
                                          compute_dtype=torch.float32)
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    np.testing.assert_allclose(float(m["ce"]), float(want_m["ce"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(m["aux"]), float(want_m["aux"]),
                               rtol=1e-5, atol=1e-7)
    if arch == "qwen2-moe-a2.7b":
        assert float(m["aux"]) > 0
    tol = 2e-4 if arch == "qwen2-moe-a2.7b" else 1e-4
    _tree_close(grads, jax.tree_util.tree_map(np.asarray, want_g), tol, arch)
