"""K1's launcher (``span_kernel._Launcher``): the parts that run without
a card.

On the card a span launch gathers its pointers, picks the compiled
kernel of their alignment specialisation and makes one C call
(``src/repro_torch/csrc/span_launch.cu``); ``tests/test_torch_gpu.py``
and ``chip_smoke.py`` hold it against Triton's own launch bit for bit.
Here: the outputs of a span lie in one allocation at 16-byte aligned,
disjoint offsets that cover every output, and a pointer off 16 bytes
(a window view that starts mid-row) selects another compiled kernel,
while an aligned one finds the first again.
"""
import numpy as np
import pytest
import torch

from tests import test_torch_span_kernel as tsk


def _sources():
    """Spans of one and of several outputs, of one type and of several
    (a float row, an int32 count and a bool flag per lane)."""
    from repro_torch import omp

    sources = []
    for prog, env, axes in tsk._forwarding_regions():
        mesh = omp.make_mesh((3,) if len(axes) == 1 else (3, 2), axes,
                             device="cpu")
        sources += [sp.source for sp in omp.compile(
            prog, mesh, lowering="kernel", env_like=env).kernel_plan.spans]

    @omp.parallel_for(stop=13, name="mixed")
    def mixed(i, env):
        x = env["x"][i]
        return {"r": omp.at(i, x * env["w"]),
                "n": omp.at(i, (x > 0).to(torch.int32)),
                "f": omp.at(i, x < -0.5), "y": omp.at(i, x + 1.0)}

    g = np.random.default_rng(3)
    env = {"x": torch.tensor(g.standard_normal(13).astype(np.float32)),
           "w": torch.tensor(g.standard_normal(5).astype(np.float32)),
           "r": torch.zeros(13, 5), "n": torch.zeros(13, dtype=torch.int32),
           "f": torch.zeros(13, dtype=torch.bool), "y": torch.zeros(13)}
    comp = omp.compile(mixed, omp.make_mesh((2,), ("data",), device="cpu"),
                       lowering="kernel", env_like=env)
    sources.append(comp.kernel_plan.spans[0].source)
    return sources


def test_outputs_lie_in_one_allocation_aligned_and_disjoint():
    from repro_torch.kernels import span_kernel

    sources = _sources()
    assert any(len({dt for *_, dt in s.outputs}) > 2 for s in sources)
    assert any(len(s.outputs) > 2 for s in sources)
    for source in sources:
        offsets, total = span_kernel.output_layout(source)
        spans = []
        for off, (_, _, shape, dt) in zip(offsets, source.outputs):
            assert off % span_kernel.ALIGN == 0
            spans.append((off, off + int(np.prod(shape))
                          * torch.empty((), dtype=dt).element_size()))
        assert spans == sorted(spans) and spans[-1][1] <= total
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        outs = span_kernel._Launcher(source).outputs(torch.device("cpu"))
        base = min(t.data_ptr() for t in outs)
        for t, (off, end), (_, _, shape, dt) in zip(outs, spans,
                                                    source.outputs):
            assert tuple(t.shape) == tuple(shape) and t.dtype == dt
            assert t.is_contiguous() and t.data_ptr() % 16 == 0
            assert t.data_ptr() - base == off
            assert t.numel() * t.element_size() == end - off
        # one allocation: every output shares the first one's storage
        if len(outs) > 1:
            assert len({t.untyped_storage().data_ptr() for t in outs}) == 1
        # writes through one view never reach another
        for t in outs:
            t.zero_()
        outs[-1].fill_(1)
        assert all(not bool(t.any()) for t in outs[:-1])


def test_a_misaligned_pointer_selects_another_compiled_kernel(monkeypatch):
    from repro_torch.kernels import span_kernel

    source = _sources()[-1]
    compiled = []

    def fake_compile(src, args, outs):
        compiled.append(span_kernel.specialisation(
            [t.data_ptr() for t in (*args, *outs)]))
        return span_kernel._Compiled(function=len(compiled), threads=128,
                                     shared=0, extra=((0, 1), (0, 1)))

    monkeypatch.setattr(span_kernel, "_compile", fake_compile)
    launcher = span_kernel._Launcher(source)
    outs = launcher.outputs(torch.device("cpu"))
    n_in = len(source.inputs)
    aligned = [torch.zeros(64) for _ in range(n_in)]
    shifted = [torch.zeros(65)[1:] for _ in range(n_in)]   # 4 bytes off
    assert all(t.data_ptr() % 16 == 4 for t in shifted)

    def entry(args):
        ptrs = [t.data_ptr() for t in (*args, *outs)]
        return launcher.kernel_for(args, outs, ptrs, 0)

    first = entry(aligned)
    second = entry(shifted)
    assert first.function == 1 and second.function == 2
    assert compiled[0] == 0 and compiled[1] == (1 << n_in) - 1
    assert entry([torch.zeros(64) for _ in range(n_in)]) is first
    assert entry(shifted) is second and len(compiled) == 2
    # another device index is another kernel handle
    assert launcher.kernel_for(aligned, outs, [t.data_ptr() for t in (
        *aligned, *outs)], 1).function == 3
    with pytest.raises(ValueError, match="compiled for"):
        entry([torch.zeros(64, dtype=torch.float64) for _ in range(n_in)])
    assert span_kernel.specialisation([16, 32, 36, 0, 8]) == 0b10100


def test_sources_of_one_text_and_other_shapes_get_a_launcher_each(
        monkeypatch):
    """The launcher cache is keyed on what a launcher keeps from its
    source beside the text: a source of the same ``fn_name`` with another
    grid or other output shapes launches with its own, never the first
    one's."""
    import dataclasses

    from repro_torch.kernels import span_kernel

    first = _sources()[-1]
    wider = dataclasses.replace(
        first, n_programs=first.n_programs * 2,
        outputs=tuple((si, key, (shape[0] * 2, *shape[1:]), dt)
                      for si, key, shape, dt in first.outputs))
    assert wider.fn_name == first.fn_name
    assert span_kernel.launcher_key(wider) != span_kernel.launcher_key(first)
    launched = []

    def fake_launch(self, args, outs, device_index):
        launched.append((self.source.n_programs,
                         [tuple(t.shape) for t in outs]))

    monkeypatch.setattr(span_kernel._Launcher, "launch", fake_launch)
    monkeypatch.setattr(torch._C, "_cuda_getDevice", lambda: 0,
                        raising=False)
    monkeypatch.setattr(span_kernel, "_LAUNCHERS", {})
    n_stages = 1 + max(si for _, si, _ in first.inputs)
    stage_io = [({}, {}) for _ in range(n_stages)]
    for kind, si, key in first.inputs:
        stage_io[si][0 if kind == "win" else 1][key] = torch.zeros(4, 5)
    before = span_kernel.LAUNCHES
    for source in (first, wider, first):
        outs = span_kernel.launch_span(source, stage_io, torch.device("cpu"))
        got = {key: tuple(t.shape) for o in outs for key, t in o.items()}
        assert got == {key: tuple(shape)
                       for _, key, shape, _ in source.outputs}
    assert [g for g, _ in launched] == [first.n_programs, wider.n_programs,
                                        first.n_programs]
    assert len(span_kernel._LAUNCHERS) == 2
    assert span_kernel.LAUNCHES == before + 3
