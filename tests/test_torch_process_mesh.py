"""The port's process mesh (``repro_torch.mesh.ProcessMesh``: the first
axis's ranks split over the processes of a ``torch.distributed`` group)
on the CPU, in gloo groups of 2 and 4 fresh processes, held against the
stacked mesh (``repro_torch.mesh.Mesh``) on the same inputs.

One spawn a world size (``tests/_torch_process.py``; each child on one
torch thread): every collective on a ``("data",)`` mesh of 4 ranks and a
``("data", "model")`` mesh of (4, 2), bit for bit with equal counters and
logs; full and partial permutes; the gradients through ``ppermute``,
``all_gather`` and ``take``; at world 2 also GPipe over the whisper-small
smoke encoder (a stage a process), the int8 all-reduce and the refusals.
Tolerance: none; every value is compared bit for bit.
"""
import pytest
import torch

from tests import _torch_process as tproc


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The world-2 and world-4 groups' results, each spawned once."""
    tmp = tmp_path_factory.mktemp("process_mesh")
    return {2: tproc.spawn(tproc.world2, 2, tmp),
            4: [{"collectives": r} for r in
                tproc.spawn(tproc.collectives, 4, tmp)]}


def _same(want, got, label):
    if isinstance(want, dict):
        assert want.keys() == got.keys(), label
        for k in want:
            _same(want[k], got[k], f"{label}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(want) == len(got), label
        for i, (w, g) in enumerate(zip(want, got)):
            _same(w, g, f"{label}[{i}]")
    elif torch.is_tensor(want):
        assert want.dtype == got.dtype and want.shape == got.shape, (
            label, want.dtype, got.dtype, want.shape, got.shape)
        assert torch.equal(want, got), label
    else:
        assert want == got, (label, want, got)


@pytest.mark.parametrize("world", [2, 4])
def test_collectives_equal_the_stacked_mesh(runs, world):
    """psum/pmax/pmin (float32, bfloat16, int32; over the split axis, the
    whole one and both, in either order), all_gather, all_to_all,
    ppermute, axis_index, shard and unshard: each process's values equal
    the stacked mesh's (its ranks' rows of a per-rank result), and its
    counters and log equal the stacked mesh's."""
    for rank, res in enumerate(runs[world]):
        checks = res["collectives"]
        assert len([k for k in checks if not k.startswith("grad")]) >= 40
        for name, (want, got) in checks.items():
            _same(want, got, f"world {world} rank {rank} {name}")
        for key in ("1/counters", "2/counters"):
            assert checks[key][1]["launches"]["psum"] > 0


@pytest.mark.parametrize("world", [2, 4])
def test_ppermute_full_and_partial_and_its_gradient(runs, world):
    """A ring, a shift (rank 0 receives zeros) and a partial permute
    (ranks no pair targets receive zeros); the gradient of each is the
    inverse permute; ``all_gather``'s, each process differentiating its
    own ranks' terms of the loss (rank r's reading rank r + 1's value),
    is the stacked mesh's; ``take``'s, every process differentiating the
    same loss, is too."""
    for rank, res in enumerate(runs[world]):
        checks = res["collectives"]
        for name in ("ring", "shift", "partial"):
            want, got = checks[f"1/ppermute/{name}"]
            _same(want, got, f"rank {rank} {name}")
            _same(*checks[f"grad/ppermute/{name}"], f"rank {rank} grad {name}")
        _same(*checks["grad/all_gather"], f"rank {rank} grad all_gather")
        _same(*checks["grad/take"], f"rank {rank} grad take")
    # rank 0 of the shift received nothing
    assert not runs[world][0]["collectives"]["1/ppermute/shift"][1][0].any()


def test_gpipe_over_two_processes_equals_the_stacked_mesh(runs):
    """Whisper-small's smoke encoder, 4 blocks as 2 checkpointed stages of
    2, one stage a process, 3 microbatches of 2 utterances: the
    emissions, the loss and every stage parameter's gradient equal the
    stacked pipeline's bit for bit on both processes, with M+S-1
    ``ppermute`` launches each."""
    for rank, res in enumerate(runs[2]):
        g = res["gpipe"]
        st, pm = g["stacked"], g["process"]
        _same(st["y"], pm["y"], f"rank {rank} emissions")
        _same(st["loss"], pm["loss"], f"rank {rank} loss")
        assert len(st["grads"]) == 8          # every encoder leaf
        _same(st["grads"], pm["grads"], f"rank {rank} grads")
        assert st["ppermute"] == pm["ppermute"] == 3 + 2 - 1


def test_compressed_allreduce_over_two_processes(runs):
    """The int8 error-feedback all-reduce: the mean every rank receives,
    each rank's new errors and the counters (one all_to_all and three
    all_gathers a leaf) equal the stacked mesh's."""
    for rank, res in enumerate(runs[2]):
        got = res["int8"]
        for key in ("mean", "errors", "counters"):
            _same(*got[key], f"rank {rank} {key}")
        assert got["counters"][1]["launches"] == {"all_to_all": 2,
                                                  "all_gather": 6}


def test_refusals_name_their_reason(runs):
    """CUDA tensors over gloo; a first axis the world does not divide; a
    sequence sharded over data ranks in two processes; an MoE unit (one
    dispatch group over the batch) across two processes; the recovery of
    a program compiled on a process mesh (which now compiles)."""
    for res in runs[2]:
        got = res["refusals"]
        assert got["cuda"].startswith("ValueError") and "gloo" in got["cuda"]
        assert "does not split over 2 processes" in got["split"]
        assert "shard_seq" in got["shard_seq"]
        assert "MoE unit of 2 ranks" in got["moe_unit"]
        assert got["recovery"].startswith("NotImplementedError")
        assert "ROADMAP.md §1 item 2" in got["recovery"]
