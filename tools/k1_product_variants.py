#!/usr/bin/env python3
"""K1's product kernels on one NVIDIA card against the variants that the
span-kernel generator sets aside, each pair timed in turns on one card:

* **matrix-vector spans** (atax ``ax``, bicg ``q``, mvt ``x1``,
  ``gesummv``): the generator's row sum (``[lanes, bk] * [1, bk]`` K
  tiles summed in float32, ``span_kernel._MV_LANES`` lanes a program,
  ``_BK_MV``-wide K tiles pipelined ``_MV_STAGES`` deep, ``_MV_WARPS``
  warps) against the earlier 16-column ``tl.dot`` design (the vector
  broadcast over 16 columns, column 0 kept; 16 lanes, 128-wide K tiles,
  2 warps; its emitter is kept here, not in the generator) and against
  the row sum at other lanes, K tiles, depths and warps;
* **row-times-matrix products** (gemm, 2mm, 3mm, syrk, syr2k,
  covariance ``cov``): float32 ``tl.dot`` at 3xTF32 on the tensor cores
  (``span_kernel._F32_PRECISION``) against IEEE float32 on the FMA pipes
  at the same tiles and at the earlier FMA design's (64 x 64 tiles, 4
  warps, K tiles of 32), and the chosen tiles (``_DOT_LANES`` lanes x
  ``_DOT_TILE_SCALE * _MAX_TILE_ELEMS / lanes`` values, ``_DOT_WARPS``
  warps, a ``_DOT_STAGES``-deep ring, K tiles of ``_BK_ONE`` in a span of
  one product and ``_BK`` in one of more) against other tiles and
  depths;
* **the transposed copy** (``span_kernel.kernel_args``, kind
  ``"replT"``) of a matrix whose tiles run the other way than the dot
  reads them fastest (under 3xTF32 K-major: gemm's ``B``), timed apart
  from the product, and each product's matrix read the way the generator
  chose against the other way (syrk's and syr2k's ``A.T``, covariance's
  rows: as they lie under 3xTF32);

* **the operand ring of a product span of few lanes** (phase 18's
  ``cumsum1`` of ``chip_smoke.py``: 32-lane tiles, a 512-wide output
  tile): the K tile the generator chose to fit ``_DOT_STAGES`` stages
  in ``span_kernel._SMEM_BYTES`` against a longer one at fewer stages,
  narrower output tiles and shorter K tiles (a variant that does not fit
  a program is reported as such);

and, at n = 512, the 16-bit route of a product (bfloat16 and float16
operands go to ``tl.dot`` as they are, with a float32 accumulator),
held against the plain version at 1e-2 (one bfloat16 rounding).

    python3 tools/k1_product_variants.py [mv|mm|copy|ring|16bit ...]

PolyBench/C 4.2.1 EXTRALARGE dims, float32, 8 ranks, ``static`` — the
spans of ``chip_smoke.py``'s phase 17.  Each variant is held against the
plain version (``chip_smoke.agree`` at 1e-4, and at 1e-5 for a matrix
product as phase 17 holds it), then chosen and variant are timed in
turns (chosen, variant, variant, chosen; the device time a call under
``torch.profiler``, ``chip_smoke.device_ms``, the transposed copy
included unless said).  Every line names the card and its power limit.  Needs a CUDA
card.
"""
from __future__ import annotations

import contextlib
import re
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

MV = (("atax", 0), ("bicg", 0), ("mvt", 0), ("gesummv", 0))
MM = (("gemm", 0), ("2mm", 0), ("2mm", 1), ("3mm", 0), ("3mm", 1),
      ("3mm", 2), ("syrk", 0), ("syr2k", 0), ("covariance", 1))
#: Row-sum variants set against the chosen one (generator constants).
MV_VARIANTS = (dict(_MV_LANES=8), dict(_MV_LANES=2), dict(_BK_MV=512),
               dict(_MV_STAGES=1), dict(_MV_STAGES=4), dict(_MV_WARPS=2),
               dict(_MV_WARPS=8))
#: Product variants set against the chosen one.
MM_VARIANTS = (dict(_F32_PRECISION="ieee", _DOT_LANES=64, _DOT_TILE_SCALE=1,
                    _DOT_WARPS=4, _BK_ONE=32),      # the FMA design
               dict(_F32_PRECISION="ieee", _BK_ONE=32),
               dict(_DOT_LANES=64, _DOT_TILE_SCALE=1, _DOT_WARPS=4),
               dict(_DOT_LANES=64, _DOT_TILE_SCALE=2, _DOT_WARPS=4),
               dict(_DOT_LANES=128, _DOT_TILE_SCALE=2, _DOT_WARPS=4),
               dict(_DOT_LANES=128, _DOT_TILE_SCALE=2, _DOT_WARPS=8),
               dict(_DOT_WARPS=4), dict(_BK_ONE=32, _BK=32),
               dict(_BK_ONE=64, _BK=64), dict(_DOT_STAGES=4),
               dict(_DOT_STAGES=2))


def _mv_dot16(self, row, mem, d_k, od):
    """The earlier matrix-vector emitter: ``tl.dot`` of the rows and the
    vector broadcast over 16 columns (IEEE float32), column 0 kept."""
    sk = self._span_kernel
    self._replicated(mem, "vector")
    k = mem.shape[d_k]
    bk = min(max(sk.pow2_at_least(k), sk._DOT_MIN), 128)
    self.flops += 2 * k
    p, off = self._address(mem, {d_k: "@K@"})
    block, w = self.block, sk._DOT_MIN
    acc = f"acc{self.n}"
    self.n += 1
    self._line(f"{acc} = tl.zeros([{block}, {w}], tl.float32)")

    def body(ks, kcol):
        a = self.cast(row, sk.torch.float32, ks)
        a = self.emit(f"tl.broadcast_to({a}, [{block}, {ks.bt}])",
                      sk.torch.float32, True, k).expr
        b = self.emit(f"tl.broadcast_to(tl.load({p} + "
                      f"{off.replace('@K@', kcol)}, mask={kcol} < {k}, "
                      f"other=0).to(tl.float32), [{ks.bt}, {w}])",
                      sk.torch.float32, False, None).expr
        return a, b, ', input_precision="ieee"'
    self._k_loop(acc, k, bk, body, block, w, sk.torch.float32)
    return self.emit(f"tl.sum(tl.where(tl.arange(0, {w})[None, :] == 0, "
                     f"{acc}, 0.0), axis=1)[:, None].to({sk._TL[od]})", od,
                     True, None)


@contextlib.contextmanager
def patched(span_kernel, consts=None, mv_dot16=False):
    """The generator with some of its constants (and, given ``mv_dot16``,
    its matrix-vector emitter) replaced, restored after."""
    consts = dict(consts or {})
    if mv_dot16:
        consts.update(_MV_WARPS=2)
    saved = {k: getattr(span_kernel, k) for k in consts}
    gen = span_kernel._Gen
    mv, tiles = gen.__dict__["_mv"], span_kernel._span_tiles

    def tiles16(chunks, shape):     # tl.dot takes at least 16 lanes
        if shape.mv and not (shape.dot or shape.outer):
            return span_kernel.derive_nest_tiles(chunks, max_lanes=16,
                                                 min_tile=16)
        return tiles(chunks, shape)
    try:
        for k, v in consts.items():
            setattr(span_kernel, k, v)
        if mv_dot16:
            gen._span_kernel = span_kernel
            gen._mv = _mv_dot16
            span_kernel._span_tiles = tiles16
        yield
    finally:
        for k, v in saved.items():
            setattr(span_kernel, k, v)
        gen._mv = mv
        span_kernel._span_tiles = tiles


def spans(torch, omp, pb, transform, name, dev):
    """``(program, plan, stage feeds)`` of every block of kernel
    ``name``, each block fed the env the earlier blocks left."""
    mesh = omp.make_mesh((8,), ("data",), device=dev)
    kernel = pb.make(name)
    env = kernel.env_fn(dev)
    out = []
    for prog in kernel.programs:
        comp = omp.compile(prog, mesh, lowering="collective",
                           schedule=omp.static(), env_like=env)
        repl, slabs = transform.stage_inputs(comp.plan, env)
        out.append((prog, comp.plan, [(slabs, repl)]))
        env = comp(env)
    return out


def check(cs, torch, span_kernel, plan, prog, io, dev, src, tol, label):
    """``src`` launched once against the plain version on the lanes that
    hold an iteration; returns its max abs error.  A variant that fails
    ``agree`` at ``tol`` is printed as failing, and still timed."""
    from repro_torch.core import kernel_lower

    want = span_kernel.span_values_plain(plan, prog, *io[0], dev)
    mask = kernel_lower.lane_mask(plan, dev)
    (got,) = span_kernel.launch_span(src, io, dev)
    err = 0.0
    for k in want:
        g, w = got[k][mask], want[k][mask]
        err = max(err, (g - w).abs().max().item())
        if not cs.agree(torch, g, w, tol):
            print(f"FAILS {label} {src.fn_name} {k}: != plain under agree "
                  f"at {tol} (max abs err {err:.3e} of max "
                  f"{w.abs().max().item():.3e})")
    return err


def in_turns(cs, torch, fns):
    """Two callables timed in turns a, b, b, a: the mean device ms a call
    of each (``chip_smoke.device_ms``: what the card spent, since a short
    span's back-to-back event time reads the host's launch)."""
    ms = {0: [], 1: []}
    for i in (0, 1, 1, 0):
        ms[i].append(cs.device_ms(torch, fns[i])[0])
    return sum(ms[0]) / 2, sum(ms[1]) / 2


def pair(cs, torch, span_kernel, plan, prog, io, dev, sources, tol, label):
    """Both sources checked against the plain version, then timed in
    turns; returns (ms, ms, err, err)."""
    errs = [check(cs, torch, span_kernel, plan, prog, io, dev, s, tol, label)
            for s in sources]
    a, b = in_turns(cs, torch, [
        (lambda s=s: span_kernel.launch_span(s, io, dev)) for s in sources])
    return a, b, *errs


def _k_tile(src) -> int:
    """The K tile of a product span's ``tl.dot`` loop."""
    return int(re.search(r"tl\.broadcast_to\(\w+, \[\d+, (\d+)\]\)",
                         src.text).group(1))


def _desc(src):
    return (f"{src.n_programs} programs x {src.num_warps} warps, "
            f"{src.num_stages} stages")


def mv_phase(cs, torch, omp, pb, transform, span_kernel, dev, card):
    for name, block in MV:
        prog, plan, io = spans(torch, omp, pb, transform, name, dev)[block]
        chosen = span_kernel.generate(plan, prog, dev)
        label = f"{name}/{prog.name}"
        with patched(span_kernel, mv_dot16=True):
            dot16 = span_kernel.generate(plan, prog, dev)
        assert "tl.dot(" in dot16.text and "tl.dot(" not in chosen.text
        a, b, ea, eb = pair(cs, torch, span_kernel, plan, prog, io, dev,
                            (chosen, dot16), 1e-4, label)
        print(f"mv {label}: row sum {a:.4f} ms ({_desc(chosen)}; err "
              f"{ea:.2e}), 16-column tl.dot {b:.4f} ms ({_desc(dot16)}; "
              f"err {eb:.2e}): {b / a:.2f}x on {card}")
        for consts in MV_VARIANTS:
            with patched(span_kernel, consts):
                other = span_kernel.generate(plan, prog, dev)
            a, b, _, _ = pair(cs, torch, span_kernel, plan, prog, io, dev,
                              (chosen, other), 1e-4, label)
            print(f"mv {label}: chosen {a:.4f} ms, {consts} {b:.4f} ms "
                  f"({_desc(other)}): {b / a:.2f}x on {card}")


def mm_phase(cs, torch, omp, pb, transform, span_kernel, dev, card):
    cache = {}
    for name, block in MM:
        if name not in cache:
            cache = {name: spans(torch, omp, pb, transform, name, dev)}
        prog, plan, io = cache[name][block]
        chosen = span_kernel.generate(plan, prog, dev)
        label = f"{name}/{prog.name}"
        for consts in MM_VARIANTS:
            with patched(span_kernel, consts):
                other = span_kernel.generate(plan, prog, dev)
            try:
                a, b, ea, eb = pair(cs, torch, span_kernel, plan, prog, io,
                                    dev, (chosen, other), 1e-5, label)
            except Exception as e:      # a variant the card cannot hold
                if type(e).__name__ != "OutOfResources":
                    raise
                print(f"mm {label}: {consts} does not fit a program: {e}")
                continue
            print(f"mm {label}: chosen {a:.4f} ms ({_desc(chosen)}, "
                  f"{chosen.value_tiles} value tiles; err {ea:.2e}), "
                  f"{consts} {b:.4f} ms ({_desc(other)}, "
                  f"{other.value_tiles} value tiles; err {eb:.2e}): "
                  f"{b / a:.2f}x on {card}")


def copy_phase(cs, torch, omp, pb, transform, span_kernel, dev, card):
    """Each product's matrix read the way the generator chose (a K-major
    tile under 3xTF32: gemm's ``B`` copied transposed, syrk's ``A.T``
    read as it lies) against the other way; the copy and the product of
    whichever one copies timed apart."""
    gen = span_kernel._Gen
    wants = gen.__dict__["_wants_k_major"]
    for name, block in (("gemm", 0), ("syrk", 0), ("syr2k", 0),
                        ("covariance", 1)):
        prog, plan, io = spans(torch, omp, pb, transform, name, dev)[block]
        chosen = span_kernel.generate(plan, prog, dev)
        gen._wants_k_major = staticmethod(lambda dt: not wants.__func__(dt))
        try:
            other = span_kernel.generate(plan, prog, dev)
        finally:
            gen._wants_k_major = wants
        label = f"{name}/{prog.name}"
        t_chosen, t_other, _, _ = pair(cs, torch, span_kernel, plan, prog,
                                       io, dev, (chosen, other), 1e-5, label)
        parts = []
        for what, src in (("chosen", chosen), ("other", other)):
            if not any(k == "replT" for k, _, _ in src.inputs):
                continue
            # the copy alone, and the product alone on arguments made once
            args = span_kernel.kernel_args(src, io)
            fn = span_kernel._kernel(src)
            outs = [torch.empty(shape, dtype=dt, device=dev)
                    for _, _, shape, dt in src.outputs]
            t_args = cs.device_ms(torch, lambda: span_kernel.kernel_args(
                src, io))[0]
            t_prod = cs.device_ms(torch, lambda: fn[(src.n_programs,)](
                *args, *outs, num_warps=src.num_warps,
                num_stages=src.num_stages))[0]
            parts.append(f"{what}: the copy {t_args:.4f} ms, the product "
                         f"{t_prod:.4f} ms")
        copies = "copied transposed" if any(
            k == "replT" for k, _, _ in chosen.inputs) else "read as it lies"
        print(f"copy {label}: chosen ({copies}) {t_chosen:.4f} ms, the "
              f"other way {t_other:.4f} ms ({t_other / t_chosen:.2f}x; "
              + "; ".join(parts) + f") on {card}")


#: Ring variants set against the chosen one on cumsum1's span.
RING_VARIANTS = (dict(_SMEM_BYTES=1 << 20),
                 dict(_DOT_STAGES=2, _SMEM_BYTES=1 << 20),
                 dict(_DOT_STAGES=1, _SMEM_BYTES=1 << 20),
                 dict(_DOT_TILE_SCALE=2),
                 dict(_DOT_TILE_SCALE=1), dict(_BK_ONE=16),
                 dict(_BK_ONE=16, _DOT_TILE_SCALE=2))


def ring_phase(cs, torch, omp, pb, transform, span_kernel, dev, card):
    """cumsum1's span (phase 18 of ``chip_smoke.py``) at the ring the
    generator chose against the variants of ``RING_VARIANTS``."""
    prog, env, shape, axes, _, _ = cs.repair_programs(
        omp, torch, dev)["cumsum1"]
    comp = omp.compile(prog, omp.make_mesh(shape, axes, device=dev),
                       lowering="collective", env_like=env)
    repl, slabs = transform.stage_inputs(comp.plan, env)
    io = [(slabs, repl)]
    chosen = span_kernel.generate(comp.plan, prog, dev)
    label = "cumsum1"
    for consts in RING_VARIANTS:
        with patched(span_kernel, consts):
            other = span_kernel.generate(comp.plan, prog, dev)
        try:
            a, b, ea, eb = pair(cs, torch, span_kernel, comp.plan, prog, io,
                                dev, (chosen, other), 1e-4, label)
        except Exception as e:      # a variant the card cannot hold
            if type(e).__name__ != "OutOfResources":
                raise
            print(f"ring {label}: {consts} ({_desc(other)}) does not fit a "
                  f"program: {e}")
            continue
        print(f"ring {label}: chosen {a:.4f} ms ({_desc(chosen)}, "
              f"{chosen.value_tiles} value tiles, K tile {_k_tile(chosen)}; "
              f"err {ea:.2e}), {consts} {b:.4f} ms ({_desc(other)}, "
              f"{other.value_tiles} value tiles, K tile {_k_tile(other)}; "
              f"err {eb:.2e}): {b / a:.2f}x on {card}")


def bits16_phase(cs, torch, omp, pb, transform, span_kernel, dev, card):
    from repro_torch.core import kernel_lower

    mesh = omp.make_mesh((8,), ("data",), device=dev)
    for name in ("gemm", "syrk"):
        kernel = pb.make(name, 512)
        prog = kernel.programs[0]
        for dt in (torch.bfloat16, torch.float16):
            env = {k: v.to(dt) for k, v in kernel.env_fn(dev).items()}
            comp = omp.compile(prog, mesh, lowering="collective",
                               schedule=omp.static(), env_like=env)
            repl, slabs = transform.stage_inputs(comp.plan, env)
            src = span_kernel.generate(comp.plan, prog, dev)
            if "tl.dot(" not in src.text or "input_precision" in src.text:
                raise AssertionError(f"{name} {dt}: not a 16-bit tl.dot")
            (got,) = span_kernel.launch_span(src, [(slabs, repl)], dev)
            want = span_kernel.span_values_plain(comp.plan, prog, slabs,
                                                 repl, dev)
            mask = kernel_lower.lane_mask(comp.plan, dev)
            for k in want:
                g, w = got[k][mask].float(), want[k][mask].float()
                if not cs.agree(torch, g, w, 1e-2):
                    raise AssertionError(f"{name} {dt} {k}: != plain")
                print(f"16-bit {name}/{prog.name} {dt}: tl.dot == plain at "
                      f"1e-2, max abs err {(g - w).abs().max().item():.3e} "
                      f"of max {w.abs().max().item():.3e} on {card}")


PHASES = {"mv": mv_phase, "mm": mm_phase, "copy": copy_phase,
          "ring": ring_phase, "16bit": bits16_phase}


def main(argv) -> int:
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs

    torch = cs._setup()
    from repro_torch import omp
    from repro_torch import polybench as pb
    from repro_torch.core import transform
    from repro_torch.kernels import span_kernel

    dev = torch.device("cuda")
    card = cs.card_line()
    print(f"card: {card}")
    for name in argv or list(PHASES):
        PHASES[name](cs, torch, omp, pb, transform, span_kernel, dev, card)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
