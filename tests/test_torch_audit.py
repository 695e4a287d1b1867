"""The port's step audits (``repro_torch.launch.audit``, ``lower_cell``,
``repro_torch.launch.dryrun``) held against the reference's
(``repro.launch.hlo_analysis``, ``repro.launch.steps.lower_cell``,
``repro.launch.dryrun``) on the CPU.

* ``wire_bytes`` equals the reference's ``_wire_bytes`` over every
  collective kind (and the mesh's op names for them) and group sizes 1-8,
  exactly.
* The roofline terms at the card's constants (the twin of
  ``tests/test_hlo_analysis.py::test_roofline_terms_math``), to 1e-9.
* One smoke cell of each kind (gemma3-1b, 2 layers, batch 4 x 16) on a
  (1, 1) mesh: ``lower_cell``'s per-rank argument bytes equal the
  reference's compiled ``memory_analysis().argument_size_in_bytes``
  exactly; its FLOPs lie within 1% of the reference's
  ``analyze_hlo(...).dot_flops`` for prefill and decode.  For train the
  two count different products: the reference's chunked cross-entropy
  pads each sequence to its 512-token chunk (4 x 512 rows of the head's
  product, forward and backward, for 4 x 15 tokens) and contracts a
  one-hot of the vocabulary, where the port computes the 60 rows and
  gathers the label's logit (a pinned difference); the port's count is
  1/7 of the reference's here, held within 1%.
* The counted collectives of a (2, 2) ZeRO-3 train cell: one
  ``all_gather`` per rank axis of every sharded leaf, one ``psum`` per
  gradient leaf and one for the metrics, each priced by ``wire_bytes``.
* ``run_cell`` writes a record, returns it again without lowering
  (resumable), and records an error with its traceback; ``should_skip``
  equals the reference's on every (arch, shape).
"""
import dataclasses
import functools
import json
import os

import jax
import pytest

from tests._torch_threads import one_torch_thread  # noqa: F401
from tests.test_torch_dist_train import FAST_COMPILE

B, S = 4, 16
#: the train cell: the port's FLOPs over the reference's dot FLOPs (the
#: reference's padded chunk of the cross-entropy; see above)
TRAIN_FLOP_RATIO = 1 / 7


def _reference_dryrun():
    """``repro.launch.dryrun``, imported without keeping the device count
    it sets in ``XLA_FLAGS`` for its own process."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as jdry
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    return jdry


def test_wire_bytes_equal_reference():
    from repro.launch import hlo_analysis as ha
    from repro_torch.launch import audit

    assert audit.COLLECTIVES == ha.COLLECTIVES
    kinds = list(ha.COLLECTIVES) + ["other"]
    for kind in kinds:
        for g in range(1, 9):
            for payload in (0, 1, 4096, 12345, 2**31 + 7):
                assert audit.wire_bytes(kind, payload, g) == \
                    ha._wire_bytes(kind, payload, g), (kind, g, payload)
    for op, kind in audit.MESH_KINDS.items():
        for g in range(1, 9):
            assert audit.wire_bytes(op, 4096, g) == \
                ha._wire_bytes(kind, 4096, g), (op, g)


def test_roofline_terms_math():
    from repro_torch.launch import audit

    t = audit.roofline_terms(flops=989e12, bytes=3.35e12, wire_bytes=450e9)
    assert abs(t.compute_s - 1.0) < 1e-9
    assert abs(t.memory_s - 1.0) < 1e-9
    assert abs(t.collective_s - 1.0) < 1e-9
    assert t.roofline_fraction == 1.0
    t2 = audit.roofline_terms(flops=989e12, bytes=3.35e12 * 2,
                              wire_bytes=0)
    assert t2.dominant == "memory"
    assert abs(t2.roofline_fraction - 0.5) < 1e-9


def _cfgs(arch="gemma3-1b", layers=2):
    from repro.configs import smoke_config as jsmoke
    from repro_torch.configs import smoke_config

    return (dataclasses.replace(jsmoke(arch), n_layers=layers),
            dataclasses.replace(smoke_config(arch), n_layers=layers))


@functools.lru_cache(maxsize=None)
def _reference(kind):
    """(argument bytes, dot FLOPs) of the reference's compiled cell."""
    import repro.launch.steps as jsteps
    from repro.configs import ShapeConfig
    from repro.launch import hlo_analysis as ha
    from repro.launch.mesh import make_local_mesh

    jcfg, _ = _cfgs()
    cell = jsteps.make_cell(jcfg, ShapeConfig(kind, S, B, kind),
                            make_local_mesh(1))
    compiled = jsteps.lower_cell(cell).compile(compiler_options=FAST_COMPILE)
    rep = ha.analyze_hlo(compiled.as_text(), num_devices=1,
                         default_trip=max(1, jcfg.n_layers))
    return compiled.memory_analysis().argument_size_in_bytes, rep.dot_flops


@pytest.mark.parametrize("kind", ["prefill", "decode", "train"])
def test_lowered_cell_matches_reference_memory_and_flops(kind):
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import lower_cell, make_cell

    _, cfg = _cfgs()
    cell = make_cell(cfg, ShapeConfig(kind, S, B, kind),
                     make_local_mesh(1, device="cpu"))
    low = lower_cell(cell)
    want_bytes, want_flops = _reference(kind)
    assert low.argument_bytes == want_bytes, (kind, low.arg_bytes,
                                              want_bytes)
    assert low.launches == {} and low.calls == []   # one rank
    assert all(x.device.type == "meta" for x in
               jax.tree_util.tree_leaves(cell.args))
    want = TRAIN_FLOP_RATIO if kind == "train" else 1.0
    assert abs(low.flops / want_flops / want - 1.0) < 0.01, (
        kind, low.flops, want_flops)
    names = [n for n, *_ in low.outputs]
    if kind == "train":
        assert any(n.startswith("2/") for n in names)      # the metrics
    else:
        assert low.outputs[0][1:] == ((B, cfg.vocab_size), "float32")


def test_counted_collectives_of_a_2x2_train_cell():
    from repro_torch.configs import ShapeConfig, TrainConfig
    from repro_torch.core import tensor_plan as tp
    from repro_torch.launch import audit
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.launch.steps import lower_cell, make_cell, map_specs
    from repro_torch.pytree import tree_leaves

    _, cfg = _cfgs()
    mesh = make_local_mesh(2, ranks=4, device="cpu")
    cell = make_cell(cfg, ShapeConfig("t", S, B, "train"), mesh,
                     TrainConfig(optimizer="adamw", zero3=True, remat=False,
                                 microbatch=1, compute_dtype="float32"))
    low = lower_cell(cell)
    specs = []
    map_specs(lambda leaf, spec: specs.append(spec), cell.args[0],
              cell.param_specs)
    # one gather per rank axis a sharded leaf names
    gathers = sum(len({a for e in s for a in tp.spec_axes(e)})
                  for s in specs)
    n_leaves = len(specs)
    assert low.launches == {"all_gather": gathers,
                            "psum": n_leaves + 1}, low.launches
    assert len(low.calls) == gathers + n_leaves + 1
    rep = audit.StepReport.from_lowered(low)
    assert {c.kind for c in rep.collectives} == {"all-gather", "all-reduce"}
    assert all(c.group_size == 2 for c in rep.collectives)
    assert rep.total_wire_bytes == sum(
        int(audit.wire_bytes(op, payload, g)) for op, g, payload in low.calls)
    # a gradient psum moves a parameter's bytes; per rank 2 x (g-1)/g of
    # them on a ring of 2 ranks
    n_param_bytes = sum(x.numel() * 4 for x in tree_leaves(cell.args[0]))
    assert rep.by_kind()["all-reduce"] >= n_param_bytes
    assert set(rep.by_kind()) == {"all-gather", "all-reduce"}
    # ZeRO-3: a rank stores a block of most leaves (norms stay whole)
    assert n_param_bytes / 4 < low.arg_bytes["params"] < n_param_bytes / 2


def test_run_cell_writes_resumes_and_records_an_error(tmp_path, monkeypatch):
    from repro_torch.launch import dryrun, steps

    dryrun.main(["--arch", "gemma3-1b", "--shape", "decode_32k", "--out",
                 str(tmp_path)])
    path = tmp_path / "gemma3-1b__decode_32k__pod16x16.json"
    rec = json.loads(path.read_text())
    assert rec["status"] == "ok" and rec["devices"] == 256, rec
    assert rec["memory"]["temp_bytes"] is None and rec["memory"]["reason"]
    assert rec["memory"]["argument_bytes"] == sum(
        rec["memory"]["argument_bytes_by_group"].values())
    assert rec["step"]["n_collectives"] > 0
    assert rec["roofline"]["dominant"] in ("compute", "memory", "collective")
    assert rec["roofline"]["fits_80gb"] is True
    # resumable: the stored record comes back without building the cell
    monkeypatch.setattr(steps, "make_cell", lambda *a, **k: 1 / 0)
    again = dryrun.run_cell("gemma3-1b", "decode_32k", False, str(tmp_path))
    assert again == rec
    # a cell that fails to build is recorded, with its traceback
    err = dryrun.run_cell("gemma3-1b", "decode_32k", False, str(tmp_path),
                          force=True)
    assert err["status"] == "error" and "ZeroDivisionError" in err["error"]
    assert "Traceback" in err["traceback"]
    assert json.loads(path.read_text())["status"] == "error"


def test_should_skip_equals_reference():
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.configs import list_archs
    from repro_torch.configs import SHAPES, get_config
    from repro_torch.launch import dryrun

    jdry = _reference_dryrun()
    seen = set()
    for arch in list_archs():
        for name in JSHAPES:
            got = dryrun.should_skip(get_config(arch), SHAPES[name])
            assert got == jdry.should_skip(jget_config(arch),
                                           JSHAPES[name]), (arch, name)
            seen.add(got is None)
        assert dryrun.cell_id(arch, "x", "m") == jdry.cell_id(arch, "x", "m")
    assert seen == {True, False}
