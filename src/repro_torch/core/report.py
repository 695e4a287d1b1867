"""Human-readable transformation report (counterpart of
:mod:`repro.core.report`, block views).

The paper presents its output as generated MPI source (Tables 2 and 3).
The port has no C source to show; the equivalent artifact is the
*distribution plan* — which buffer moves where, which collective plays the
role of which MPI_Send/Recv pair — plus the chunk schedule and, under
``Lowering.KERNEL``, the span kernels; for a region, the residency
planner's journal, the cost-modeled boundary plan and the communication
schedule (:func:`render_region`).
"""
from __future__ import annotations

import math

from repro_torch.core.context import VarClass
from repro_torch.core.plan import DistPlan


_IN_DESC = {
    "replicate": "master->workers broadcast of the full buffer "
                 "(MPI_Send to every slave / replicated in_spec)",
    "shard": "master->workers chunk slices only "
             "(MPI_Send of [offset, offset+partSize) / sharded slab in_spec)",
    "shard_halo": "chunk slices + stencil halo rows "
                  "(beyond-paper: neighbour exchange instead of broadcast)",
    "none": "not transferred (unused or write-only inside the block)",
}

_OUT_DESC = {
    "identity": "workers->master slices [offset, offset+partSize) "
                "(MPI_Recv per chunk / sharded slab out_spec)",
    "partial": "workers->master slices, master updates rows in place",
    "scatter": "strided write: full-size masked buffers combined by "
               "all-reduce (paper: whole modified array transferred)",
    "put": "full array sent by the worker owning the last iteration",
    "reduce": "per-worker partials folded into the master accumulator",
    "none": "",
}


def render_plan(plan: DistPlan) -> str:
    ch = plan.chunks
    lines = [
        f"=== OMP2MPI transformation report: {plan.name} ===",
        f"lowering        : {plan.lowering}",
    ]
    if plan.rank == 2:
        names = ("i", "j")
        ranks = " x ".join(f"{c.num_devices}" for c in plan.chunks_axes)
        lines.append(
            f"mesh axes       : {plan.axis!r} ({ranks} compute ranks, "
            "2-D decomposition)")
        for d, (lp, cd) in enumerate(zip(plan.nest.axes, plan.chunks_axes)):
            lines.append(
                f"loop axis {names[d]}     : for {names[d]} in "
                f"range({lp.start}, {lp.stop}, {lp.step})  "
                f"[{lp.trip_count} iterations]")
            lines.append(
                f"chunk axis {names[d]}    : partSize={cd.chunk}, "
                f"{cd.num_chunks} chunks total ({cd.local_chunks} per rank), "
                f"cyclic chunk q -> rank q % {cd.num_devices}")
    else:
        lines += [
            f"mesh axis       : {plan.axis!r} ({ch.num_devices} compute ranks)",
            f"loop            : for i in range({plan.loop.start}, "
            f"{plan.loop.stop}, {plan.loop.step})  "
            f"[{plan.loop.trip_count} iterations]",
            f"chunk (partSize): {ch.chunk}  "
            f"[paper Table 2 line 4: N / ranks / 10 for schedule(dynamic)]",
            f"chunks          : {ch.num_chunks} total, {ch.local_chunks} "
            f"per rank, cyclic assignment chunk j -> rank j % "
            f"{ch.num_devices}",
        ]
    lines += [
        "",
        "variable classification (Context Analysis, paper Fig. 3):",
    ]
    for key, dec in plan.vars.items():
        info = plan.context.vars[key]
        klass = dec.klass.value.upper()
        shape = "x".join(map(str, info.shape)) or "scalar"
        lines.append(f"  {key:>12s}  {klass:<9s} {shape:<16s} "
                     f"dtype={str(info.dtype).replace('torch.', '')}")
        if dec.read_map is not None:
            lines.append(f"  {'':>12s}  read map : x[{dec.read_map.a}*k"
                         f"{dec.read_map.b:+d}]")
        if dec.write_map is not None:
            lines.append(f"  {'':>12s}  write map: x[{dec.write_map.a}*k"
                         f"{dec.write_map.b:+d}]")
        if dec.read_maps is not None:
            inner = ", ".join(f"{m.a}*k{d}{m.b:+d}"
                              for d, m in zip("ij", dec.read_maps))
            lines.append(f"  {'':>12s}  read map : x[{inner}]")
        if dec.write_maps is not None:
            inner = ", ".join(f"{m.a}*k{d}{m.b:+d}"
                              for d, m in zip("ij", dec.write_maps))
            lines.append(f"  {'':>12s}  write map: x[{inner}]")
        if dec.halo_axes is not None and any(
                h != (0, 0) for h in dec.halo_axes):
            inner = ", ".join(f"axis{d} [{h[0]}, {h[1]}]"
                              for d, h in enumerate(dec.halo_axes))
            lines.append(f"  {'':>12s}  halo     : {inner}")
        if dec.reduction_op:
            lines.append(f"  {'':>12s}  reduction: op={dec.reduction_op!r} "
                         f"(identity init, paper Table 3)")
        in_d = _IN_DESC.get(dec.in_strategy, "")
        out_d = _OUT_DESC.get(dec.out_strategy, "")
        if in_d and dec.klass in (VarClass.IN, VarClass.INOUT):
            lines.append(f"  {'':>12s}  in : {in_d}")
        if out_d:
            lines.append(f"  {'':>12s}  out: {out_d}")
        if dec.note:
            lines.append(f"  {'':>12s}  note: {dec.note}")
    lines.append("")
    lines.append("communication summary (per block execution):")
    lines.extend(_comm_summary(plan))
    return "\n".join(lines)


def render_compiled(compiled) -> str:
    """Render the :class:`~repro_torch.core.api.Compiled` artifact: the
    pass pipeline header followed by the per-block Tables 2/3 view or the
    whole-region residency report."""
    from repro_torch.core.region import RegionPlan

    lines = [
        f"=== omp.compile: {compiled.program.name} ===",
        f"options         : {compiled.options.describe()}",
        f"mesh axis       : {compiled.axis!r} "
        f"({compiled.num_devices} compute ranks)",
        "",
        "pass pipeline (analyze -> schedule -> plan -> plan_comm -> "
        "schedule_comm -> lower):",
    ]
    for pr in compiled.passes:
        lines.append(f"  {pr.describe()}")
    lines.append("")
    kp = getattr(compiled, "kernel_plan", None)
    if kp is not None:
        lines.extend(kp.describe_lines())
        lines.append("")
    plan = compiled.plan
    if isinstance(plan, RegionPlan):
        lines.append(render_region(plan))
    elif isinstance(plan, DistPlan):
        lines.append(render_plan(plan))
    else:  # staged region: per-stage plans, each loop in isolation
        lines.append("staged lowering: each loop transformed in isolation "
                     "(paper Fig. 1b round trips)")
        for _, p in plan:
            lines.append("")
            lines.append(render_plan(p))
    return "\n".join(lines)


def render_region(rp) -> str:
    """Render a :class:`~repro_torch.core.region.RegionPlan`: stage
    roster, the residency planner's transition journal, the boundary
    plan, the communication schedule and the staged-vs-fused
    comparison."""
    from repro_torch.core.region import REPLICATED, SlabLayout2

    lines = [
        f"=== ParallelRegion transformation report: {rp.name} ===",
        f"mesh axis       : {rp.axis!r} ({rp.num_devices} compute ranks)",
        f"stages          : {len(rp.stages)} "
        f"({sum(1 for s in rp.stages if s.kind == 'loop')} parallel loops, "
        f"{sum(1 for s in rp.stages if s.kind == 'serial')} serial glue)",
        "",
        "stage roster:",
    ]
    for s in rp.stages:
        if s.kind == "serial":
            lines.append(f"  {s.name:>16s}  serial glue "
                         f"(writes {list(s.serial_writes)})")
        elif s.plan.rank == 2:
            trips = s.plan.nest.trip_counts
            chs = s.plan.chunks_axes
            lines.append(
                f"  {s.name:>16s}  loop nest t={trips[0]}x{trips[1]} "
                f"chunks={chs[0].chunk}x{chs[1].chunk} "
                f"({chs[0].num_chunks}x{chs[1].num_chunks} tiles cyclic)")
        else:
            ch = s.plan.chunks
            lines.append(
                f"  {s.name:>16s}  loop t={s.plan.loop.trip_count} "
                f"chunk={ch.chunk} ({ch.num_chunks} chunks cyclic)")
    lines.append("")
    lines.append("inter-loop residency (the beyond-paper layout planner):")
    if rp.log:
        lines.extend(f"  {entry}" for entry in rp.log)
    else:
        lines.append("  (no inter-stage traffic: single loop or "
                     "disjoint buffers)")
    lines.append("")
    lines.append("communication plan (cost-modeled boundary lowering, "
                 "paper §3.1.4 block-boundary send/recv):")
    if rp.comms:
        for bc in rp.comms:
            lines.append(f"  {bc.describe()}")
            lines.append(f"  {'':>4s}why: {bc.reason}")
        lines.append(
            f"  planned wire total: ~{rp.planned_wire_bytes} B "
            f"(all-gather-only baseline: ~{rp.gather_wire_bytes} B)")
    else:
        lines.append("  (no slab boundaries: nothing to exchange)")
    sched = rp.comm_sched
    if sched is not None:
        what = ("aggregated ppermute payloads, fused reductions, "
                "prefetched exchanges" if sched.mode == "aggregate"
                else "per-buffer exchanges issued at the consumer "
                     "(un-scheduled baseline)")
        lines.append("")
        lines.append(
            f"communication schedule (schedule_comm, mode={sched.mode}): "
            f"{what}:")
        event_lines = sched.describe_lines()
        if len(event_lines) == 1 and not sched.events:
            lines.append("  (no exchanges to schedule)")
        lines.extend(f"  {ln}" for ln in event_lines)
    lines.append("")
    lines.append(
        f"residency summary: {rp.n_elided} resident handoff(s) elided, "
        f"{rp.n_halo} halo ppermute exchange(s), "
        f"{rp.n_reshards} minimal reshard collective(s) inserted")
    lines.append("")
    lines.append("per-loop staged estimate (paper: every block round-trips "
                 "through the master):")
    staged_total = 0
    for s in rp.stages:
        if s.plan is None:
            continue
        _, sub = _comm_breakdown(s.plan)
        staged_total += sub
        lines.append(f"  {s.name:>16s}: ~{sub} B")
    lines.append(f"  {'TOTAL':>16s}: ~{staged_total} B if each loop is "
                 "transformed in isolation")
    lines.append("")
    lines.append("final buffer layouts:")
    for key, lay in rp.final_layout.items():
        if lay == REPLICATED:
            lines.append(f"  {key:>16s}: replicated")
        elif isinstance(lay, SlabLayout2):
            (bi, bj), (ci, cj) = lay.bases, lay.covers
            lines.append(
                f"  {key:>16s}: 2-D chunk-cyclic slab "
                f"rows [{bi}, {bi + ci}) x cols [{bj}, {bj + cj}) "
                f"(reassembled by layout at exit)")
        else:
            lines.append(
                f"  {key:>16s}: chunk-cyclic slab "
                f"rows [{lay.base}, {lay.base + lay.cover}) "
                f"(reassembled by layout at exit)")
    return "\n".join(lines)


def _bytes_of(shape, dtype) -> int:
    return math.prod(shape) * dtype.itemsize


def _comm_summary(plan: DistPlan) -> list[str]:
    """Estimated bytes moved, in MPI terms (one rule per strategy)."""
    lines, total = _comm_breakdown(plan)
    lines.append(f"  {'TOTAL':>12s}: ~{total} B "
                 f"({plan.lowering} lowering estimate)")
    return lines


def _comm_breakdown(plan: DistPlan) -> tuple[list[str], int]:
    """Per-variable traffic lines plus the numeric total."""
    if plan.rank == 2:
        return _comm_breakdown2(plan)
    ch = plan.chunks
    out = []
    total = 0
    for key, dec in plan.vars.items():
        info = plan.context.vars[key]
        b = _bytes_of(info.shape, info.dtype)
        row = _bytes_of(info.shape[1:], info.dtype) if info.shape else b
        moved = 0
        parts = []
        if dec.in_strategy == "replicate":
            if plan.lowering == "master_worker":
                moved += b * (ch.num_devices)
                parts.append(f"in: {ch.num_devices} point-to-point sends x {b} B")
            else:
                moved += b
                parts.append(f"in: broadcast {b} B")
        elif dec.in_strategy == "shard":
            sl = row * ch.padded_trip
            moved += sl
            parts.append(f"in: chunk slices {sl} B total")
        elif dec.in_strategy == "shard_halo":
            width = ch.chunk + (dec.halo[1] - dec.halo[0])
            sl = row * width * ch.num_chunks
            moved += sl
            parts.append(f"in: chunk slices + halo {sl} B total "
                         f"(vs {b * ch.num_devices} B broadcast)")
        if dec.out_strategy in ("identity", "partial"):
            sl = row * ch.padded_trip
            moved += sl
            parts.append(f"out: chunk slices {sl} B total")
            if plan.lowering == "master_worker":
                moved += b * ch.num_devices
                parts.append(f"out: re-broadcast {ch.num_devices} x {b} B")
        elif dec.out_strategy == "scatter":
            moved += 2 * b * ch.num_devices
            parts.append(f"out: masked all-reduce ~{2 * b} B/rank")
        elif dec.out_strategy == "put":
            moved += b * (2 if plan.lowering == "master_worker" else 1)
            parts.append(f"out: full array {b} B from last worker")
        elif dec.out_strategy == "reduce":
            rb = _bytes_of(info.write.value_shape, info.write.value_dtype)
            moved += rb * ch.num_devices
            parts.append(f"out: {ch.num_devices} partials x {rb} B")
        if parts:
            out.append(f"  {key:>12s}: " + "; ".join(parts))
        total += moved
    return out, total


def _comm_breakdown2(plan: DistPlan) -> tuple[list[str], int]:
    """Rank-2 traffic estimate: per-axis chunk windows instead of the
    1-D slab rows (same MPI-terms accounting)."""
    ch_i, ch_j = plan.chunks_axes
    out = []
    total = 0
    for key, dec in plan.vars.items():
        info = plan.context.vars[key]
        b = _bytes_of(info.shape, info.dtype)
        cell = _bytes_of(info.shape[2:], info.dtype) if len(info.shape) >= 2 \
            else b
        moved = 0
        parts = []
        if dec.in_strategy == "replicate":
            moved += b
            parts.append(f"in: broadcast {b} B")
        elif dec.in_strategy == "shard_halo":
            halos = dec.halo_axes or ((0, 0),)
            w_i = ch_i.chunk + halos[0][1] - halos[0][0]
            if dec.shard_ndim == 2:
                w_j = ch_j.chunk + halos[1][1] - halos[1][0]
                sl = cell * w_i * w_j * ch_i.num_chunks * ch_j.num_chunks
            else:
                row = _bytes_of(info.shape[1:], info.dtype)
                sl = row * w_i * ch_i.num_chunks
            moved += sl
            parts.append(f"in: 2-D chunk windows {sl} B total "
                         f"(vs {b * ch_i.num_devices * ch_j.num_devices} B "
                         "broadcast)")
        if dec.out_strategy in ("identity", "partial"):
            sl = cell * ch_i.padded_trip * ch_j.padded_trip
            moved += sl
            parts.append(f"out: chunk tiles {sl} B total")
        elif dec.out_strategy == "reduce":
            rb = _bytes_of(info.write.value_shape, info.write.value_dtype)
            p = ch_i.num_devices * ch_j.num_devices
            moved += rb * p
            parts.append(f"out: {p} partials x {rb} B")
        if parts:
            out.append(f"  {key:>12s}: " + "; ".join(parts))
        total += moved
    return out, total
