"""GPipe in the PyTorch port on the CPU (``repro_torch.core.pipeline`` on
the stacked mesh), held against the JAX package: at the reference test's
sizes (S 8 stages, M 6 microbatches of 4 rows, D 16, a ``tanh`` stage)
the port's outputs and its ``torch.autograd`` gradients equal the
reference's own oracle, run in-process (the stages applied in order
under ``jax.vmap`` over microbatches, and ``jax.grad`` of it), with and
without ``checkpoint``, which agree with each other bit for bit; a
forward counts M+S-1 ``ppermute`` launches, and ``Mesh.ppermute``'s
gradient is the inverse permutation.  One case runs the reference's
``make_pipeline`` at S 4 on 4 virtual devices in a subprocess (JAX
refuses its partial permutation under ``jax.vmap``), ~5 s.
Tolerances: outputs and gradients rtol = atol = 1e-5.
"""
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_dist_train import FAST_COMPILE

S, M, MB, D = 8, 6, 4, 16


def _inputs(s, seed=0):
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(s, D, D)).astype(np.float32) * 0.3
    b = rng.normal(size=(s, D)).astype(np.float32) * 0.1
    x = rng.normal(size=(M, MB, D)).astype(np.float32)
    return w, b, x


def _port(w, b, x, checkpoint):
    """(outputs, d sum(out^2) / d(w, b), mesh) of the port's pipeline."""
    from repro_torch.core.pipeline import make_pipeline
    from repro_torch.mesh import make_mesh

    mesh = make_mesh((w.shape[0],), ("stage",), device="cpu")
    tw, tb = (torch.from_numpy(a).requires_grad_() for a in (w, b))
    run = make_pipeline(lambda p, x: torch.tanh(x @ p["w"] + p["b"]), mesh,
                        axis="stage", checkpoint=checkpoint)
    out = run({"w": tw, "b": tb}, torch.from_numpy(x))
    gw, gb = torch.autograd.grad((out ** 2).sum(), (tw, tb))
    return out.detach().numpy(), (gw.numpy(), gb.numpy()), mesh


@functools.lru_cache(maxsize=None)
def _oracle(seed):
    """The reference test's oracle on ``_inputs(S, seed)``: stages in
    order, vmapped over microbatches; and jax.grad of the sum of
    squares."""
    w, b, x = _inputs(S, seed)

    def seq(stacked, xm):
        y = xm
        for s in range(stacked["w"].shape[0]):
            y = jnp.tanh(y @ stacked["w"][s] + stacked["b"][s])
        return y

    def fwd(st):
        return jax.vmap(lambda xm: seq(st, xm))(jnp.asarray(x))

    def compiled(f):
        return jax.jit(f).lower(stacked).compile(
            compiler_options=FAST_COMPILE)

    stacked = {"w": jnp.asarray(w), "b": jnp.asarray(b)}
    grads = compiled(jax.grad(lambda st: jnp.sum(fwd(st) ** 2)))(stacked)
    return np.asarray(compiled(fwd)(stacked)), (np.asarray(grads["w"]),
                                                np.asarray(grads["b"]))


@pytest.mark.parametrize("checkpoint", [True, False])
def test_pipeline_matches_sequential_oracle_and_grads(checkpoint):
    w, b, x = _inputs(S)
    got, (gw, gb), mesh = _port(w, b, x, checkpoint)
    want, (ww, wb) = _oracle(0)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gw, ww, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gb, wb, rtol=1e-5, atol=1e-5)
    assert np.abs(gw).sum() > 0 and np.abs(gb[0]).sum() > 0
    # one ppermute a tick, each sending S-1 stages' (MB, D) buffers
    assert mesh.launches == {"ppermute": M + S - 1}
    assert mesh.bytes["ppermute"] == (M + S - 1) * (S - 1) * MB * D * 4


def test_pipeline_checkpoint_equals_no_checkpoint():
    w, b, x = _inputs(S, seed=1)
    a, (aw, ab), _ = _port(w, b, x, True)
    c, (cw, cb), _ = _port(w, b, x, False)
    for g, h in ((a, c), (aw, cw), (ab, cb)):
        np.testing.assert_array_equal(g, h)


def test_ppermute_gradient_is_the_inverse_permutation():
    """A partial shift (0->1, 1->2, 2->3 of 4 ranks): rank r's gradient is
    what rank r+1 received it with, and the last rank, which sends
    nothing, gets zeros."""
    from repro_torch.mesh import make_mesh

    mesh = make_mesh((4,), ("s",), device="cpu")
    x = torch.arange(12.0).reshape(4, 3).requires_grad_()
    wt = torch.arange(1.0, 13.0).reshape(4, 3)
    (g,) = torch.autograd.grad((mesh.ppermute(x, "s", [(0, 1), (1, 2),
                                                       (2, 3)]) * wt).sum(),
                               x)
    torch.testing.assert_close(g[:3], wt[1:], rtol=0, atol=0)
    torch.testing.assert_close(g[3], torch.zeros(3), rtol=0, atol=0)


def test_pipeline_matches_reference_make_pipeline(multidevice):
    """The reference's jitted ``make_pipeline`` over 4 virtual devices
    (a subprocess) against the port's on a 4-rank stacked mesh."""
    out = multidevice("""
        import json
        import jax, jax.numpy as jnp, numpy as np
        from repro.compat import make_mesh
        from repro.core.pipeline import make_pipeline

        rng = np.random.default_rng(2)
        w = rng.normal(size=(4, 16, 16)).astype(np.float32) * 0.3
        b = rng.normal(size=(4, 16)).astype(np.float32) * 0.1
        x = rng.normal(size=(6, 4, 16)).astype(np.float32)
        run = make_pipeline(lambda p, x: jnp.tanh(x @ p["w"] + p["b"]),
                            make_mesh((4,), ("stage",)), axis="stage")
        got = run({"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x))
        print("OUT", json.dumps(np.asarray(got).tolist()))
    """, n_devices=4)
    want = np.asarray(json.loads(out.split("OUT ", 1)[1]), np.float32)
    got, _, mesh = _port(*_inputs(4, seed=2), True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert mesh.launches["ppermute"] == M + 4 - 1
