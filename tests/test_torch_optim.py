"""The port's optimizers and gradient machinery on the CPU, held against
the JAX package (``repro.optim``) on the same numpy trees: AdamW and
Adafactor for three steps (a 1-D leaf, unfactored; a 2-D and a 3-D leaf,
factored over their two largest dims; Adafactor with bf16 momentum and
streamed over a leading dim too), the cosine schedule with warm-up,
global-norm clipping, and int8 compression with error feedback.
Tolerance: rtol = atol = 1e-6 (int8 codes bit for bit).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import optim as jopt
from repro.optim import grad as jgrad
from repro.optim.api import opt_state_axes as jaxes

from tests._torch_threads import one_torch_thread  # noqa: F401

TOL = dict(rtol=1e-6, atol=1e-6)
SHAPES = {"bias": (7,), "w": (5, 9), "stack": {"k": (3, 4, 6)}}


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)

    def draw(s):
        if isinstance(s, dict):
            return {k: draw(v) for k, v in s.items()}
        return (rng.normal(size=s) * scale).astype(np.float32)
    return draw(SHAPES)


def _close(got, want, label=""):
    from repro_torch import convert

    if isinstance(want, dict):
        assert set(got) == set(want), (label, sorted(got), sorted(want))
        for k in want:
            _close(got[k], want[k], f"{label}/{k}")
        return
    got = convert.tree_to_numpy(got) if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    if want.dtype == jnp.bfloat16:      # tree_to_numpy: its float32 values
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        want = want.astype(np.float32)
    assert got.shape == want.shape and got.dtype == want.dtype, (
        label, got.shape, want.shape, got.dtype, want.dtype)
    np.testing.assert_allclose(got, want, **TOL, err_msg=label)


def _j(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(tree):
    from repro_torch import convert

    return convert.params_from_numpy(tree, "cpu")


@pytest.mark.parametrize("name,kw", [
    ("adamw", {}),
    ("adafactor", {}),
    ("adafactor", {"momentum": True}),
    ("adafactor", {"stream_leading": 2}),
])
def test_three_steps_match_reference(name, kw):
    """Three updates from the same parameters with the same gradients:
    every parameter and state leaf (its keys too) after each step."""
    from repro_torch import optim

    params, grads = _tree(0), [_tree(1 + i, 0.1) for i in range(3)]
    momentum = kw.get("momentum", False)
    stream = kw.get("stream_leading", 0)
    if name == "adamw":
        jinit, init = jopt.adamw_init, optim.adamw_init
        jup = lambda g, s, p, lr: jopt.adamw_update(g, s, p, lr=lr)
        up = lambda g, s, p, lr: optim.adamw_update(g, s, p, lr=lr)
    else:
        jinit = lambda p: jopt.adafactor_init(p, momentum=momentum)
        init = lambda p: optim.adafactor_init(p, momentum=momentum)
        jup = lambda g, s, p, lr: jopt.adafactor_update(
            g, s, p, lr=lr, weight_decay=0.01, stream_leading=stream)
        up = lambda g, s, p, lr: optim.adafactor_update(
            g, s, p, lr=lr, weight_decay=0.01, stream_leading=stream)
    jp, p = _j(params), _t(params)
    js, s = jinit(jp), init(p)
    _close(s, js, "init")
    for step, g in enumerate(grads):
        jp, js = jup(_j(g), js, jp, 1e-2)
        p, s = up(_t(g), s, p, torch.tensor(1e-2))
        _close(p, jp, f"step {step} params")
        _close(s, js, f"step {step} state")


def test_state_axes_match_reference():
    """``opt_state_axes``: a state leaf takes its parameter's logical axes,
    less a factored-out dim."""
    from repro_torch import optim

    params = _tree(0)
    axes = {"bias": ("a",), "w": ("a", "b"), "stack": {"k": ("l", "a", "b")}}
    shapes = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), params)
    for name in ("adamw", "adafactor"):
        assert optim.opt_state_axes(name, _t(params), axes) == \
            jaxes(name, shapes, axes)


def test_schedule_and_clip_match_reference():
    """The cosine schedule with warm-up at steps 0..12 (warm-up 3, total
    10, beyond the end), and global-norm clipping above and below the
    threshold."""
    from repro_torch import optim

    for step in range(13):
        want = jopt.cosine_warmup(step, base_lr=3e-3, warmup_steps=3,
                                  total_steps=10)
        got = optim.cosine_warmup(step, base_lr=3e-3, warmup_steps=3,
                                  total_steps=10)
        np.testing.assert_allclose(float(got), float(want), **TOL)
    g = _tree(4)
    for max_norm in (0.5, 1e3):
        jt, jn = jopt.clip_by_global_norm(_j(g), max_norm)
        t, n = optim.clip_by_global_norm(_t(g), max_norm)
        np.testing.assert_allclose(float(n), float(jn), **TOL)
        _close(t, jt, f"clip {max_norm}")
    np.testing.assert_allclose(float(optim.global_norm(_t(g))),
                               float(jopt.global_norm(_j(g))), **TOL)


def test_int8_compression_with_error_feedback_matches_reference():
    """Three rounds of int8 compression of a gradient tree, each adding
    the last round's error: the int8 codes bit for bit, the scales, the
    errors, and the decompressed tree; the error-feedback state starts at
    zeros in float32."""
    from repro_torch import optim

    params = _tree(0)
    jerr, err = (jgrad.init_error_feedback(_j(params)),
                 optim.init_error_feedback(_t(params)))
    _close(err, jerr, "init")
    for step in range(3):
        g = _tree(10 + step, 0.3)
        jq, js, jerr = jgrad.tree_compress_int8(_j(g), jerr)
        q, s, err = optim.tree_compress_int8(_t(g), err)
        _close(q, jq, f"q {step}")
        _close(s, js, f"scale {step}")
        _close(err, jerr, f"error {step}")
        _close(optim.tree_decompress_int8(q, s),
               jgrad.tree_decompress_int8(jq, js), f"deq {step}")
    q, s, e = optim.compress_int8(torch.zeros(4), torch.zeros(4))
    assert q.dtype == torch.int8 and not q.any() and float(s) > 0
