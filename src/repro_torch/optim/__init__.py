"""Optimizers and gradient machinery on tensor trees — counterpart of
:mod:`repro.optim`: AdamW, Adafactor (factored second moment), global-norm
clipping, the cosine schedule with warm-up, and int8 error-feedback
compression of a gradient tree.  Plain functions: each update takes the
gradient, state and parameter trees and returns new parameter and state
trees, computed under ``torch.no_grad()``; states keep the reference's
keys, so they carry across by :mod:`repro_torch.convert`.

The compressed all-reduce (``compressed_allreduce_tree``) needs a mesh of
ranks that exchange gradients, and comes with the ``torch.distributed``
backend.
"""
from repro_torch.optim.adamw import adamw_init, adamw_update  # noqa: F401
from repro_torch.optim.adafactor import (  # noqa: F401
    adafactor_init, adafactor_update)
from repro_torch.optim.api import (  # noqa: F401
    Optimizer, make_optimizer, opt_state_axes)
from repro_torch.optim.grad import (  # noqa: F401
    clip_by_global_norm, compress_int8, decompress_int8, global_norm,
    init_error_feedback, tree_compress_int8, tree_decompress_int8)
from repro_torch.optim.schedule import cosine_warmup  # noqa: F401
