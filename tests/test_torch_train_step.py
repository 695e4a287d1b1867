"""Training in the PyTorch port on the CPU, held against the JAX package:
``chunked_cross_entropy`` with a mask and a length that is not a
multiple of the chunk (its value and gradients), and one
``make_train_cell`` step with ``microbatch=2`` (AdamW, clipping, the
schedule, remat) on gemma3-1b's smoke config against the reference's.
Tolerances: the CE rtol 1e-6 (gradients 1e-5); the step's metrics rtol
1e-5, its parameters and optimizer state rtol = atol = 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import B, S, _setup, _tree_close


def test_chunked_cross_entropy_matches_reference():
    """A mask and a length (45) that is not a multiple of the chunk (16):
    the value and its gradients with respect to x and the head."""
    from repro.models.layers import chunked_cross_entropy as jce
    from repro_torch.models.layers import chunked_cross_entropy

    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 45, 32)).astype(np.float32)
    w = (rng.normal(size=(32, 100)) * 0.3).astype(np.float32)
    labels = rng.integers(0, 100, size=(3, 45)).astype(np.int32)
    mask = rng.random((3, 45)) < 0.7
    want, (gx, gw) = jax.value_and_grad(
        lambda x, w: jce(x, w, labels, mask=mask, chunk=16),
        argnums=(0, 1))(x, w)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    got = chunked_cross_entropy(tx, tw, torch.from_numpy(labels),
                                mask=torch.from_numpy(mask), chunk=16)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(tx.grad.numpy(), gx, rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tw.grad.numpy(), gw, rtol=1e-5, atol=1e-7)
    # no mask: every token counts
    got = chunked_cross_entropy(tx.detach(), tw.detach(),
                                torch.from_numpy(labels), chunk=16)
    np.testing.assert_allclose(float(got), float(jce(x, w, labels, chunk=16)),
                               rtol=1e-6)


def test_train_step_with_microbatches_matches_reference():
    """One step of ``make_train_cell`` (microbatch 2, AdamW, global-norm
    clipping at 1.0, the cosine schedule at step 3, remat) on gemma3-1b's
    smoke config, float32, from a state with its second moment filled:
    the new parameters, the optimizer state and the metrics (loss, ce,
    aux, grad_norm, lr) equal the reference's step on a one-device
    mesh."""
    from repro.configs import ShapeConfig as JShape, TrainConfig as JTrain
    from repro.launch.mesh import make_local_mesh
    from repro.launch.steps import make_train_cell as jmake
    from repro_torch import convert
    from repro_torch.configs import ShapeConfig, TrainConfig, smoke_config
    from repro_torch.launch.mesh import make_local_mesh as local_mesh
    from repro_torch.launch.steps import make_train_cell

    jmodel, jparams, _, params, batch = _setup("gemma3-1b")
    kw = dict(microbatch=2, compute_dtype="float32", remat=True,
              warmup_steps=2, total_steps=10, learning_rate=1e-2)
    jcell = jmake(jmodel.cfg, JShape("t", S, B, "train"),
                  make_local_mesh(1), JTrain(**kw))
    # a second moment already filled, as some steps into a run (at count
    # 0 Adam's first update is lr * g / (|g| + eps): a gradient near eps,
    # equal to the reference's within its last bits, could move its
    # parameter anywhere in [-lr, lr])
    np_state = {"m": jax.tree_util.tree_map(np.zeros_like, jax.tree_util.
                                            tree_map(np.asarray, jparams)),
                "v": jax.tree_util.tree_map(
                    lambda p: np.full(np.shape(p), 1e-2, np.float32),
                    jparams),
                "count": np.zeros((), np.int32)}
    jbatch = {k: jnp.asarray(batch[k]) for k in ("tokens", "labels")}
    want_p, want_s, want_m = jax.jit(jcell.step_fn)(
        jparams, jax.tree_util.tree_map(jnp.asarray, np_state), jbatch,
        jnp.int32(3))
    cell = make_train_cell(smoke_config("gemma3-1b"),
                           ShapeConfig("t", S, B, "train"),
                           local_mesh(device="cpu"), TrainConfig(**kw))
    assert cell.n_micro == 2
    got_p, got_s, got_m = cell.step_fn(
        params, convert.params_from_numpy(np_state, "cpu"),
        {k: torch.from_numpy(batch[k]) for k in ("tokens", "labels")}, 3)
    for k in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(got_m[k]), float(want_m[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    _tree_close(got_p, jax.tree_util.tree_map(np.asarray, want_p), 1e-4,
                "params")
    _tree_close(convert.tree_to_numpy(got_s),
                jax.tree_util.tree_map(np.asarray, want_s), 1e-4, "state")
