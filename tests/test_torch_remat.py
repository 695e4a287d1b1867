"""Remat in the PyTorch port on the CPU: recomputing activations in the
backward pass (``torch.utils.checkpoint``, one level, and two levels of
segments from 8 periods on, as the reference's sqrt-remat) gives the
loss and gradients of the plain backward bit for bit, for gemma3-1b,
mamba2-130m at 8 layers and whisper-small at ``smoke_config`` size.
"""
import jax
import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_train import (_port_value_and_grad, _setup,
                                    _torch_batch)


@pytest.mark.parametrize("arch,n_layers", [("gemma3-1b", None),
                                           ("mamba2-130m", 8),
                                           ("whisper-small", None)])
def test_remat_equals_no_remat(arch, n_layers):
    """Recomputing activations in the backward pass changes nothing: the
    same loss and gradients, bit for bit on the CPU (mamba2 at 8 layers
    runs the two-level segments)."""
    _, _, model, params, batch = _setup(arch, n_layers)
    tb = _torch_batch(batch)
    outs = [_port_value_and_grad(model, params, tb, remat=r,
                                 compute_dtype=torch.float32)
            for r in (False, True)]
    assert float(outs[0][0]) == float(outs[1][0])
    for a, b in zip(jax.tree_util.tree_leaves(outs[0][2]),
                    jax.tree_util.tree_leaves(outs[1][2])):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
