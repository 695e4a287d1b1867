"""The tensor planner of the PyTorch port (``repro_torch.core.
tensor_plan``) on the CPU, held against the JAX package's: pure data, so
its specs must equal the reference's entry for entry (exact).

* the twins of ``tests/test_tensor_plan.py`` (TP heads/FF, the
  divisibility fallback, one use per mesh axis, batch over the dp axes,
  the serve plan's sequence and 2-D expert sharding, slab specs), each
  spec also equal to the reference's;
* one config of each family at full size (gemma3-1b, qwen2-moe-a2.7b,
  mamba2-130m, jamba-1.5-large-398b, whisper-small): the specs of the
  parameter, AdamW and Adafactor state and cache trees equal the
  reference's ``tree_specs`` leaf by leaf on meshes (16, 16),
  (2, 16, 16), (2, 2) and (1, 4), under the train plan (``zero3`` on and
  off, ``dp_only``) and the serve plan (``shard_seq``, ``decode``).  The
  port's shapes come from the ``meta`` device, the reference's from its
  ``launch/steps.py::_param_shapes`` and ``_cache_shapes``;
* ``shard_shape`` against ``NamedSharding.shard_shape`` on a one-device
  mesh, and against the spec arithmetic on the production meshes, where
  a stacked mesh lays the blocks out (``Mesh.shard``/``unshard``).

The full-size spec trees of the five families are in
``tests/test_torch_tensor_plan_full.py``, which uses this file's helpers.
"""
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.core import tensor_plan as jtp
from repro_torch.core import tensor_plan as tp

from tests._torch_threads import one_torch_thread  # noqa: F401

MESHES = {(16, 16): ("data", "model"), (2, 16, 16): ("pod", "data", "model"),
          (2, 2): ("data", "model"), (1, 4): ("data", "model")}
ARCHS = ("gemma3-1b", "qwen2-moe-a2.7b", "mamba2-130m",
         "jamba-1.5-large-398b", "whisper-small")
TRAIN = [dict(zero3=False), dict(zero3=True), dict(strategy="dp_only")]
SERVE = [dict(shard_seq=False, decode=False), dict(shard_seq=True),
         dict(decode=True)]


def _both(kind, axes, shape, **kw):
    make = {"train": "make_train_plan", "serve": "make_serve_plan"}[kind]
    return (getattr(tp, make)(axes, shape, **kw),
            getattr(jtp, make)(axes, shape, **kw))


#: (plan kind, mesh, plan options, tensor shape, logical axes, expected)
SPECS = [
    ("train", (16, 16), {}, (8192, 64, 128),
     (tp.D_MODEL, tp.HEADS, tp.HEAD_DIM), (None, "model")),
    ("train", (16, 16), {}, (8192, 49152), (tp.D_MODEL, tp.D_FF),
     (None, "model")),
    # GQA kv=8 cannot shard over a 16-way model axis
    ("train", (16, 16), {}, (8192, 8, 128),
     (tp.D_MODEL, tp.KV_HEADS, tp.HEAD_DIM), ()),
    # 60 experts cannot shard over 16
    ("train", (16, 16), {}, (60, 2048, 1408),
     (tp.EXPERTS, tp.D_MODEL, tp.D_EXPERT), (None, None, "model")),
    # experts -> model, d_model -> data (zero3): each axis once
    ("train", (16, 16), dict(zero3=True), (128, 7168, 4864),
     (tp.EXPERTS, tp.D_MODEL, tp.D_EXPERT), ("model", "data")),
    ("train", (2, 16, 16), {}, (256, 4096), (tp.BATCH, None),
     (("pod", "data"),)),
    # long-context KV shards the sequence over every available axis
    ("serve", (16, 16), dict(shard_seq=True), (1, 524288, 8, 128),
     (tp.BATCH, tp.SEQ_KV, tp.KV_HEADS, tp.HEAD_DIM),
     (None, ("data", "model"))),
    # expert weights shard 2-D: experts over model, d_model over data
    ("serve", (16, 16), dict(shard_seq=True), (16, 8192, 24576),
     (tp.EXPERTS, tp.D_MODEL, tp.D_EXPERT), ("model", "data")),
]


@pytest.mark.parametrize("kind,mesh,kw,shape,axes,expected", SPECS)
def test_spec_matches_reference(kind, mesh, kw, shape, axes, expected):
    port, ref = _both(kind, MESHES[mesh], mesh, **kw)
    got = port.spec(shape, axes)
    assert isinstance(got, tp.PartitionSpec)
    assert tuple(got) == expected
    assert tuple(got) == tuple(ref.spec(shape, axes))
    flat = [a for e in got for a in tp.spec_axes(e)]
    assert len(flat) == len(set(flat))


def test_slab_spec_rank1_and_rank2():
    """Loop slabs are ordinary sharded tensors: one device dim for a
    rank-1 slab, two (every third dim) for a rank-2 nest over a 2-D
    mesh."""
    assert tp.slab_spec("data") == (None, "data")
    assert tp.slab_spec(("i", "j")) == (None, "i", None, None, "j", None)
    for axis in ("data", ("i", "j")):
        assert tuple(tp.slab_spec(axis)) == tuple(jtp.slab_spec(axis))
    with pytest.raises(ValueError):
        tp.slab_spec(("i", "j", "k"))


@functools.lru_cache(maxsize=None)
def _trees(arch):
    """Per package: (params, axes, {optimizer: (state, state axes)},
    cache, cache axes) of ``arch`` at full size, shapes only."""
    from repro.configs import get_config as jget
    from repro.launch.steps import _cache_shapes, _param_shapes
    from repro.models import build_model as jbuild
    from repro.optim import make_optimizer as jopt
    from repro.optim.api import opt_state_axes as jaxes
    from repro_torch.configs import get_config
    from repro_torch.launch.steps import param_shapes
    from repro_torch.models import build_model
    from repro_torch.optim import make_optimizer
    from repro_torch.optim.api import opt_state_axes

    jmodel = jbuild(jget(arch))
    jp, ja = _param_shapes(jmodel)
    jc, jca = _cache_shapes(jmodel, 8, 2048)
    ref = (jp, ja, {o: (jax.eval_shape(jopt(o).init, jp), jaxes(o, jp, ja))
                    for o in ("adamw", "adafactor")}, jc, jca)
    model = build_model(get_config(arch))
    p, a = param_shapes(model)
    port = (p, a, {o: (make_optimizer(o).init(p), opt_state_axes(o, p, a))
                   for o in ("adamw", "adafactor")},
            model.init_cache(8, 2048, device="meta"), model.cache_axes())
    return port, ref


def _same_specs(got, want, path=""):
    """Leaf by leaf: the port's spec tree == the reference's."""
    if isinstance(want, dict):
        assert set(got) == set(want), path
        return sum(_same_specs(got[k], want[k], f"{path}/{k}") for k in want)
    assert isinstance(got, tp.PartitionSpec) and isinstance(want, JP), path
    assert tuple(got) == tuple(want), (path, got, want)
    return 1


def test_shard_shape_matches_named_sharding_on_one_device():
    from jax.sharding import NamedSharding

    from repro.compat import make_mesh

    jmesh = make_mesh((1, 1), ("data", "model"))
    port = tp.make_train_plan(("data", "model"), (1, 1), zero3=True)
    for shape, axes in (((64, 8, 16), (tp.D_MODEL, tp.HEADS, tp.HEAD_DIM)),
                        ((32, 128), (tp.BATCH, None)), ((7,), (tp.VOCAB,))):
        spec = port.spec(shape, axes)
        assert port.shard_shape(shape, spec) == NamedSharding(
            jmesh, JP(*spec)).shard_shape(shape)


@pytest.mark.parametrize("arch", ["gemma3-1b", "qwen2-moe-a2.7b"])
def test_shard_shape_is_the_spec_arithmetic_and_the_mesh_layout(arch):
    """On the production meshes every parameter's block is its shape over
    the spec's axis sizes, and on a (2, 4) stacked mesh ``Mesh.shard``
    gives blocks of that shape, which ``Mesh.unshard`` gathers back."""
    from repro_torch.mesh import make_mesh

    (p, a, _, _, _), _ = _trees(arch)
    for mesh, axes in MESHES.items():
        plan = tp.make_train_plan(axes, mesh, zero3=True)
        sizes = dict(zip(axes, mesh))
        for leaf, spec in _pairs(p, plan.tree_specs(p, a)):
            want = tuple(n // int(np.prod([sizes[x] for x in tp.spec_axes(
                spec[d] if d < len(spec) else None)]))
                for d, n in enumerate(leaf.shape))
            assert plan.shard_shape(leaf.shape, spec) == want
    with pytest.raises(ValueError, match="does not divide"):
        tp.make_train_plan(("data", "model"), (16, 16)).shard_shape(
            (10, 3), tp.P("data"))
    small = make_mesh((2, 4), ("data", "model"), device="cpu")
    plan = tp.make_train_plan(small.axis_names, (2, 4), zero3=True)
    x = torch.arange(8 * 12 * 4.0).reshape(8, 12, 4)
    spec = plan.spec(x.shape, (tp.D_MODEL, tp.HEADS, tp.HEAD_DIM))
    assert spec == ("data", "model")
    xs = small.shard(x, spec)
    assert tuple(xs.shape) == (2, 4) + plan.shard_shape(x.shape, spec)
    torch.testing.assert_close(xs[1, 3], x[4:8, 9:12], rtol=0, atol=0)
    torch.testing.assert_close(small.unshard(xs, spec), x, rtol=0, atol=0)
    assert small.launches == {"all_gather": 2}


def _pairs(tree, specs):
    if isinstance(tree, dict):
        for k in tree:
            yield from _pairs(tree[k], specs[k])
    else:
        yield tree, specs
