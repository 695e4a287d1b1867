"""A step's collectives, FLOPs and roofline terms — the counterpart of
:mod:`repro.launch.hlo_analysis`, read off a cell lowered on the ``meta``
device (:func:`repro_torch.launch.steps.lower_cell`) instead of XLA's
compiled HLO text.

What it keeps of the reference: the collective kinds
(:data:`COLLECTIVES`) and their per-device wire-cost model
(:func:`wire_bytes`, the reference's ``_wire_bytes``), a report of the
step's collectives with payload, wire bytes and group size
(:class:`StepReport`, the reference's ``HloReport``), and the three
roofline terms (:class:`RooflineTerms`, :func:`roofline_terms`).

What has no counterpart: the port has no HLO, so there is no
``analyze_hlo`` (no computation splitting, call graph or while-loop
trip-count parser: the step runs its Python loops and every collective
is logged as it happens) and no ``f32_param_convert_bytes`` (an artefact
of XLA's CPU backend).  The FLOPs are ``torch.utils.flop_counter``'s
count of the step's products; the collectives are the stacked mesh's
(:attr:`repro_torch.mesh.Mesh.log`), whose ops map onto the reference's
kinds: ``psum``/``pmax``/``pmin`` -> all-reduce, ``all_gather`` ->
all-gather, ``all_to_all`` -> all-to-all, ``ppermute`` ->
collective-permute.

The hardware constants are the card's, not the reference's TPU's.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: the stacked mesh's collectives by the reference's kind
MESH_KINDS = {"psum": "all-reduce", "pmax": "all-reduce",
              "pmin": "all-reduce", "all_gather": "all-gather",
              "all_to_all": "all-to-all", "ppermute": "collective-permute"}

# NVIDIA H100 SXM5 80GB at 700 W, the datasheet's figures: dense bf16
# tensor-core FLOP/s, HBM3 bytes/s, NVLink 4 bytes/s per direction (of
# its 900 GB/s both ways)
PEAK_FLOPS = 989e12
HBM_BW = 3.35e12
NVLINK_BW = 450e9
#: device memory of the card, bytes
HBM_BYTES = 80 * 10**9


def wire_bytes(kind: str, payload: float, group: int) -> float:
    """Per-device bytes on the wire of one collective of ``kind`` (a
    reference kind or a mesh op name) over ``group`` ranks, a ring's
    cost: ``payload`` is one rank's operand (all-reduce, all-to-all), its
    gathered result (all-gather), its scattered result (reduce-scatter)
    or its sent value (collective-permute)."""
    kind = MESH_KINDS.get(kind, kind)
    if group <= 1:
        return 0.0
    if kind == "all-reduce":
        return 2.0 * payload * (group - 1) / group
    if kind == "all-gather":
        return payload * (group - 1) / group
    if kind == "reduce-scatter":
        return payload * (group - 1)
    if kind == "all-to-all":
        return payload * (group - 1) / group
    return float(payload)


@dataclasses.dataclass
class CollectiveOp:
    kind: str                  # one of COLLECTIVES
    bytes_wire: int            # per-device wire bytes (cost model applied)
    bytes_payload: int
    group_size: int


@dataclasses.dataclass
class StepReport:
    """One lowered step's collectives and products."""

    collectives: list[CollectiveOp]
    dot_flops: float = 0.0

    @classmethod
    def from_lowered(cls, lowered) -> "StepReport":
        """The report of a :class:`repro_torch.launch.steps.Lowered`."""
        return cls([CollectiveOp(MESH_KINDS[op],
                                 int(wire_bytes(op, payload, group)),
                                 payload, group)
                    for op, group, payload in lowered.calls],
                   lowered.flops)

    @property
    def total_wire_bytes(self) -> float:
        return float(sum(c.bytes_wire for c in self.collectives))

    def by_kind(self) -> dict[str, float]:
        out: dict[str, float] = defaultdict(float)
        for c in self.collectives:
            out[c.kind] += c.bytes_wire
        return dict(out)


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float
    flops: float
    bytes: float
    wire_bytes: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_time_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def roofline_fraction(self) -> float:
        """compute_term / max(all terms): 1.0 = perfectly compute-bound."""
        t = self.bound_time_s
        return self.compute_s / t if t > 0 else 0.0


def roofline_terms(*, flops: float, bytes: float,
                   wire_bytes: float) -> RooflineTerms:
    """The three terms of one device's share of a step at the card's
    rates: ``flops`` at :data:`PEAK_FLOPS`, ``bytes`` at :data:`HBM_BW`,
    ``wire_bytes`` at :data:`NVLINK_BW` (all per device)."""
    return RooflineTerms(
        compute_s=flops / PEAK_FLOPS,
        memory_s=bytes / HBM_BW,
        collective_s=wire_bytes / NVLINK_BW,
        flops=flops,
        bytes=bytes,
        wire_bytes=wire_bytes,
    )
