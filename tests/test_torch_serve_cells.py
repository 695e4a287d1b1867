"""The serve cells of the PyTorch port (``make_prefill_cell``,
``make_decode_cell``, ``make_cell``) on stacked CPU meshes, held against
the JAX package's cells, and ``shard_fn`` through both packages' prefill
and decode.

* The smoke configs of gemma3-1b, qwen2-moe-a2.7b and whisper-small (two
  layers; whisper with its two encoder layers), bf16 weights drawn with
  numpy into both packages: the port's prefill cell and a decode step
  from the reference's caches, on (1, 1), (2, 1) and (2, 2) meshes,
  against the reference's cell steps, built on its one-device mesh with
  ``repro.launch.steps._dp_degree`` bound to the port mesh's data degree
  (the MoE ``groups``).  The dense models compute in bf16, as the cells
  do (the reference compiled with every bf16 op rounded to bf16, as
  torch rounds it), so logits are held at atol = 2e-2 x max|logit| and
  caches at rtol = atol = 2e-2.  In bf16 a few of the MoE model's tokens
  route to other experts in one package than in the other (near-equal
  router scores rounded at other points; a dropped slot moves the
  rest), which no tolerance holds, so its cells are held in float32
  compute, both packages' ``build_model`` bound inside the test to a
  model whose serve calls take float32 (as ``_dp_degree`` is bound):
  logits at atol = 1e-4 x max|logit|, the bf16 caches at rtol = atol =
  1e-2 (one bf16 step).  A dense model's cells on (2, 1) and (2, 2) equal
  its (1, 1) cell bit for bit, and the MoE model's (2, 2) cell equals
  its (2, 1) cell (both at groups 2).
* A ``shard_seq`` shape (batch 1 on a data degree of 2): the MoE
  model's cells against the reference at groups 1, as above.
* Every cell's argument specs equal the reference's ``_serve_plan``
  specs of the same trees on meshes of the same shape.
* ``make_cell`` dispatches each kind.
* A ``shard_fn`` that records the shapes it sees, passed to both
  packages' ``prefill`` and ``decode_step``: the same sequence of
  shapes, and the port's outputs equal those of ``shard_fn=None``
  exactly.
"""
import contextlib
import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_dist_train import FAST_COMPILE

ARCHS = ("gemma3-1b", "qwen2-moe-a2.7b", "whisper-small")
B, S = 4, 16
MESHES = ((1, 1), (2, 1), (2, 2))
#: bf16 in both packages: logits within this share of max|logit|, caches
#: within it (rtol and atol)
TOL = 2e-2
#: the MoE model's cells, in float32 compute: logits (a share of
#: max|logit|), and caches, which store bf16 (one bf16 step of a value
#: rounded on either side of a tie)
TOL_F32 = 1e-4
TOL_F32_CACHE = 1e-2
#: XLA's options for the reference's cells: FAST_COMPILE, and every bf16
#: op rounded to bf16 as torch rounds it
COMPILE = {**FAST_COMPILE, "xla_allow_excess_precision": False}
MOE = "qwen2-moe-a2.7b"


class _Float32Serve:
    """A model whose ``prefill`` and ``decode_step`` compute in float32
    whatever ``compute_dtype`` they are given."""

    def __init__(self, model, dtype):
        self.model, self.dtype = model, dtype

    def __getattr__(self, name):
        return getattr(self.model, name)

    def prefill(self, *a, **kw):
        return self.model.prefill(*a, **{**kw, "compute_dtype": self.dtype})

    def decode_step(self, *a, **kw):
        return self.model.decode_step(*a, **{**kw,
                                             "compute_dtype": self.dtype})


@contextlib.contextmanager
def _cells_compute(arch):
    """For the MoE arch, both packages' cells built meanwhile compute in
    float32 (their ``build_model`` bound to :class:`_Float32Serve`)."""
    import repro.launch.steps as jsteps
    import repro_torch.launch.steps as tsteps

    if arch != MOE:
        yield
        return
    old = jsteps.build_model, tsteps.build_model
    jsteps.build_model = lambda cfg: _Float32Serve(old[0](cfg), jnp.float32)
    tsteps.build_model = lambda cfg: _Float32Serve(old[1](cfg),
                                                   torch.float32)
    try:
        yield
    finally:
        jsteps.build_model, tsteps.build_model = old


def _configs(arch, layers=2):
    from repro.configs import smoke_config as jsmoke_config
    from repro_torch.configs import smoke_config

    return (dataclasses.replace(jsmoke_config(arch), n_layers=layers),
            dataclasses.replace(smoke_config(arch), n_layers=layers))


@functools.lru_cache(maxsize=None)
def _setup(arch):
    """(jax model, jax bf16 params, port model, port bf16 params): the
    same weights, drawn with numpy (norms 0, the rest normal(0, 0.05)),
    rounded to bf16 alike."""
    from repro.models import build_model as jbuild_model
    from repro_torch import convert
    from repro_torch.models import build_model

    jcfg, cfg = _configs(arch)
    jmodel = jbuild_model(jcfg)
    shapes = jax.eval_shape(lambda k: jmodel.init(k)[0],
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(ARCHS.index(arch))
    np_params = jax.tree_util.tree_map_with_path(
        lambda path, s: np.zeros(s.shape, np.float32)
        if "norm" in jax.tree_util.keystr(path)
        else (rng.normal(size=s.shape) * 0.05).astype(np.float32), shapes)
    params = jax.tree_util.tree_map(
        lambda t: t.to(torch.bfloat16),
        convert.params_from_numpy(np_params, "cpu"))
    return (jmodel, jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.bfloat16), np_params),
        build_model(cfg), params)


def _inputs(cfg, b):
    """(prompt batch, two decode steps' (tokens, pos)) as numpy."""
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(1, cfg.vocab_size,
                                    size=(b, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.normal(
            size=(b, cfg.encoder.n_frames, cfg.d_model)).astype(np.float32)
    steps = [(rng.integers(1, cfg.vocab_size, size=b).astype(np.int32),
              np.full(b, S - 3 + i, np.int32)) for i in range(2)]
    return batch, steps


def _shape(kind, b=B):
    from repro.configs import ShapeConfig as JShape
    from repro_torch.configs import ShapeConfig

    return JShape(kind, S, b, kind), ShapeConfig(kind, S, b, kind)


@functools.lru_cache(maxsize=None)
def _reference(arch, dp, b=B):
    """The reference's prefill cell step on the prompt, then two decode
    cell steps from its caches, its ``_dp_degree`` bound to ``dp``:
    (prefill (logits, caches), [(logits, caches) per decode step]) as
    numpy."""
    import repro.launch.steps as jsteps
    from repro.launch.mesh import make_local_mesh

    jmodel, jparams, _, _ = _setup(arch)
    batch, steps = _inputs(jmodel.cfg, b)
    old = jsteps._dp_degree
    jsteps._dp_degree = lambda mesh: dp
    try:
        with _cells_compute(arch):
            cells = [jsteps.make_cell(jmodel.cfg, _shape(kind, b)[0],
                                      make_local_mesh(1))
                     for kind in ("prefill", "decode")]
    finally:
        jsteps._dp_degree = old
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    caches = jmodel.init_cache(b, S, dtype=jnp.bfloat16)
    prefill = jax.jit(cells[0].step_fn).lower(
        jparams, jbatch, caches).compile(compiler_options=COMPILE)
    logits, caches = prefill(jparams, jbatch, caches)
    out = [jax.tree_util.tree_map(np.asarray, (logits, caches))]
    tok, pos = (jnp.asarray(a) for a in steps[0])
    decode = jax.jit(cells[1].step_fn).lower(
        jparams, caches, tok, pos).compile(compiler_options=COMPILE)
    dec = []
    for tok, pos in steps:
        logits, caches = decode(jparams, caches, jnp.asarray(tok),
                                jnp.asarray(pos))
        dec.append(jax.tree_util.tree_map(np.asarray, (logits, caches)))
    return out[0], dec


def _close(got, want, label, tol):
    from repro_torch import convert

    got, want = convert.tree_to_numpy(got), np.asarray(want, np.float32)
    assert got.shape == want.shape, (label, got.shape, want.shape)
    if label.endswith("logits"):
        atol = tol * float(np.abs(want).max())
        np.testing.assert_allclose(got, want, rtol=0, atol=atol,
                                   err_msg=label)
    else:
        np.testing.assert_allclose(got, want.astype(got.dtype), rtol=tol,
                                   atol=tol, err_msg=label)


def _close_tree(got, want, label, tol):
    if isinstance(want, dict):
        assert set(got) == set(want), (label, sorted(got), sorted(want))
        for k in want:
            _close_tree(got[k], want[k], f"{label}/{k}", tol)
    else:
        _close(got, want, label, tol)


def _port_run(arch, mesh_shape, b=B):
    """The port's prefill cell on the prompt and two decode cell steps
    from the reference's caches (at the mesh's data degree), every
    result gathered: (prefill (logits, caches), [(logits, caches)])."""
    from repro_torch import convert
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_cell

    _, _, model, params = _setup(arch)
    batch, steps = _inputs(model.cfg, b)
    ref_caches = _reference(arch, _groups(arch, mesh_shape, b), b)[0][1]
    mesh = make_local_mesh(mesh_shape[1], ranks=mesh_shape[0] * mesh_shape[1],
                           device="cpu")
    with _cells_compute(arch):
        pcell = make_cell(model.cfg, _shape("prefill", b)[1], mesh)
        dcell = make_cell(model.cfg, _shape("decode", b)[1], mesh)
    p, c = pcell.place(params)
    logits, c = pcell.step_fn(p, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, c)
    got = [(logits, pcell.gather(p, c)[1])]
    p, c = dcell.place(params, convert.cache_from_numpy(ref_caches, "cpu"))
    for tok, pos in steps:
        logits, c = dcell.step_fn(p, c, torch.from_numpy(tok),
                                  torch.from_numpy(pos))
        got.append((logits, dcell.gather(p, c)[1]))
    assert mesh.launches["all_gather"] > 0 or mesh.shape == {
        "data": 1, "model": 1}
    assert pcell.plan.constrained.total() > 0
    return got


def _groups(arch, mesh_shape, b):
    """The reference's ``_dp_degree`` for a port mesh: its data degree,
    or 1 where the batch is smaller; 1 for a dense model, which no
    degree changes (one reference compile serves every mesh)."""
    return mesh_shape[0] if arch == MOE and b >= mesh_shape[0] else 1


def _hold(arch, got, mesh_shape, b, label):
    pre, dec = _reference(arch, _groups(arch, mesh_shape, b), b)
    tol, ctol = (TOL_F32, TOL_F32_CACHE) if arch == MOE else (TOL, TOL)
    for i, ((gl, gc), (wl, wc)) in enumerate(zip(got, [pre] + dec)):
        step = "prefill" if i == 0 else f"decode {i}"
        _close(gl, wl, f"{label} {step} logits", tol)
        _close_tree(gc, wc, f"{label} {step} caches", ctol)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cells_match_reference_cells_across_meshes(arch):
    runs = {}
    for shape in MESHES:
        runs[shape] = _port_run(arch, shape)
        _hold(arch, runs[shape], shape, B, f"{arch} {shape}")
    moe = arch == "qwen2-moe-a2.7b"
    for shape, like in (((2, 2), (2, 1)),) if moe else (
            ((2, 1), (1, 1)), ((2, 2), (1, 1))):
        for (gl, _), (wl, _) in zip(runs[shape], runs[like]):
            assert torch.equal(gl, wl), (arch, shape, like)


def test_shard_seq_cells_match_reference():
    """Batch 1 on a data degree of 2: the serve plan shards the caches'
    sequence dim over (data, model) in place of the batch, and the MoE
    model's groups fall to 1 (its cells held as above; the dense models'
    shard_seq specs are in the specs test)."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_prefill_cell

    _hold(MOE, _port_run(MOE, (2, 1), b=1), (2, 1), 1, f"{MOE} shard_seq")
    cell = make_prefill_cell(_setup(MOE)[2].cfg, _shape("p", 1)[1],
                             make_local_mesh(1, ranks=2, device="cpu"))
    assert cell.specs[2]["slot0"]["k"][2] == ("data", "model")
    assert cell.specs[1]["tokens"] == ()            # the batch replicated


@functools.lru_cache(maxsize=None)
def _reference_shapes(arch, tree, b=B):
    """The reference's (shapes, axes) of its parameters or caches."""
    import repro.launch.steps as jsteps

    jmodel = _setup(arch)[0]
    if tree == "params":
        return jsteps._param_shapes(jmodel)
    return jsteps._cache_shapes(jmodel, b, S)


def _reference_specs(arch, kind, mesh_shape, b=B):
    """The reference's ``_serve_plan`` specs of its cell's argument trees
    on a mesh of ``mesh_shape`` over ("data", "model")."""
    import repro.launch.steps as jsteps

    jmodel = _setup(arch)[0]
    shape = _shape(kind, b)[0]
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape=dict(zip(("data", "model"),
                                                mesh_shape)))
    plan = jsteps._serve_plan(mesh, shape)
    is_axes = lambda x: isinstance(x, tuple) and all(  # noqa: E731
        isinstance(e, (str, type(None))) for e in x)

    def specs(shapes, axes):
        return jax.tree_util.tree_map(
            lambda a, s: tuple(plan.spec(s.shape, a)), axes, shapes,
            is_leaf=is_axes)

    p_shapes, p_axes = _reference_shapes(arch, "params")
    c_shapes, c_axes = _reference_shapes(arch, "caches", b)
    if kind == "prefill":
        fields = jsteps._batch_fields(jmodel.cfg, shape)
        fields.pop("labels")
        batch = {k: tuple(plan.spec(sh, jsteps._BATCH_AXES[k]))
                 for k, (sh, _) in fields.items()}
        return specs(p_shapes, p_axes), batch, specs(c_shapes, c_axes)
    row = tuple(plan.spec((b,), ("batch",)))
    return specs(p_shapes, p_axes), specs(c_shapes, c_axes), row, row


def test_cell_specs_equal_reference_serve_plan():
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import make_cell

    def plain(tree):
        if isinstance(tree, dict):
            return {k: plain(v) for k, v in tree.items()}
        return tuple(tree)

    for arch in ARCHS:
        cfg = _setup(arch)[2].cfg
        for kind in ("prefill", "decode"):
            for shape, b in ((1, 1), B), ((2, 1), B), ((2, 2), B), \
                    ((2, 2), 1):
                mesh = make_local_mesh(shape[1], ranks=shape[0] * shape[1],
                                       device="cpu")
                cell = make_cell(cfg, _shape(kind, b)[1], mesh)
                want = _reference_specs(arch, kind, shape, b)
                assert tuple(plain(s) for s in cell.specs) == want, (
                    arch, kind, shape, b)


def test_make_cell_dispatches_each_kind():
    from repro_torch.configs import recommended_train_config
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import ARG_GROUPS, make_cell

    cfg = _setup("gemma3-1b")[2].cfg
    mesh = make_local_mesh(1, device="cpu")
    for kind in ("train", "prefill", "decode"):
        cell = make_cell(cfg, _shape(kind)[1], mesh)
        assert cell.kind == kind
        assert len(cell.args) == len(cell.specs) == len(ARG_GROUPS[kind])
        assert all(x.device.type == "meta" for x in
                   jax.tree_util.tree_leaves(cell.args))
    cell = make_cell(cfg, _shape("train")[1], mesh)
    assert cell.optimizer.name == recommended_train_config(cfg).optimizer
    # serve parameters are bf16, train parameters the train config's
    assert cell.args[0]["embed"].dtype == torch.float32
    assert make_cell(cfg, _shape("decode")[1], mesh).args[0][
        "embed"].dtype == torch.bfloat16


def _unrolled_scan(f, init, xs, length=None, **_):
    """``jax.lax.scan`` as a Python loop over the leading dim."""
    n = length or jax.tree_util.tree_leaves(xs)[0].shape[0]
    carry, ys = init, []
    for i in range(n):
        carry, y = f(carry, jax.tree_util.tree_map(lambda x: x[i], xs))
        ys.append(y)
    return carry, jax.tree_util.tree_map(lambda *a: jnp.stack(a), *ys)


@pytest.mark.parametrize("arch", ("gemma3-1b", "whisper-small"))
def test_shard_fn_reaches_prefill_and_decode_in_both_packages(arch,
                                                              monkeypatch):
    """The same shapes, in the same order, reach ``shard_fn`` in both
    packages' ``prefill`` and ``decode_step``; with it the port's
    outputs are those of ``shard_fn=None``."""
    from repro_torch import convert

    jmodel, jparams, model, params = _setup(arch)
    batch, steps = _inputs(model.cfg, B)
    tok, pos = steps[0]
    seen = {"jax": [], "torch": []}

    def recorder(key):
        def sf(x):
            seen[key].append(tuple(x.shape))
            return x
        return sf

    # traced for shapes, with the reference's scans unrolled so that a
    # layer scan calls its body once a layer (a traced scan calls it once)
    monkeypatch.setattr(jax.lax, "scan", _unrolled_scan)
    jcache = jmodel.init_cache(B, S, dtype=jnp.bfloat16)
    _, jcache = jax.eval_shape(
        lambda p, bt, c: jmodel.prefill(p, bt, c, shard_fn=recorder("jax"),
                                        impl="full"),
        jparams, {k: jnp.asarray(v) for k, v in batch.items()}, jcache)
    jax.eval_shape(
        lambda p, c, t, q: jmodel.decode_step(p, c, t, q, impl="full",
                                              shard_fn=recorder("jax")),
        jparams, jcache, jnp.asarray(tok), jnp.asarray(pos))
    monkeypatch.undo()
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    outs = []
    for sf in (recorder("torch"), None):
        cache = model.init_cache(B, S, dtype=torch.bfloat16, device="cpu")
        logits, cache = model.prefill(params, tbatch, cache, impl="full",
                                      shard_fn=sf)
        dlogits, cache = model.decode_step(
            params, cache, torch.from_numpy(tok), torch.from_numpy(pos),
            impl="full", shard_fn=sf)
        outs.append((logits, dlogits, convert.tree_to_numpy(cache)))
    assert seen["torch"] == seen["jax"], (seen["torch"], seen["jax"])
    assert len(seen["torch"]) >= model.cfg.n_layers * 2
    assert torch.equal(outs[0][0], outs[1][0])
    assert torch.equal(outs[0][1], outs[1][1])
    for a, b in zip(jax.tree_util.tree_leaves(outs[0][2]),
                    jax.tree_util.tree_leaves(outs[1][2])):
        np.testing.assert_array_equal(a, b)
