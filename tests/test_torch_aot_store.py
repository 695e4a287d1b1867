"""The port's persistent compile store (``repro_torch.core.aot_store``)
on the CPU, twin of ``tests/test_aot_store.py``: fingerprints (equal to
the reference's on data-only parts), the on-disk format and its
robustness (corrupt, truncated, bad-magic and version-skewed entries are
counted misses), LRU eviction and its environment knob, and the compile
pipeline's persistence: a restored artifact skips planning, rebuilds its
passes when inspected, a corrupt entry compiles cold.  A second process
restoring what the first stored is
``tests/test_torch_aot_warm_start.py``, which uses this file's child
program."""
import enum
import glob
import json
import os
import struct
import textwrap

import numpy as np
import pytest
import torch

from repro.core import aot_store as jaot
from repro_torch import omp
from repro_torch.core import aot_store
from repro_torch.core.aot_store import AOTStore, fingerprint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mesh():
    return omp.make_mesh((2,), ("data",), device="cpu")


def _block(scale=2.0, n=16):
    @omp.parallel_for(stop=n, name="aotb")
    def block(i, env):
        return {"y": omp.at(i, env["x"][i] * scale + 1.0)}

    env = {"x": torch.arange(n, dtype=torch.float32),
           "y": torch.zeros(n, dtype=torch.float32)}
    return block, env


@pytest.fixture(autouse=True)
def _isolate_cache():
    """Each test starts from a fresh cache and no store."""
    omp.disable_persistent_cache()
    omp.clear_compile_cache()
    yield
    omp.disable_persistent_cache()
    omp.clear_compile_cache()


# ---------------------------------------------------------------------------
# fingerprint
# ---------------------------------------------------------------------------


def _make_fn(scale):
    def body(i, env):
        return {"y": omp.at(i, env["x"][i] * scale + 1.0)}
    return body


def _plain(a, b=2):
    return a * b + 1


class _Kind(enum.Enum):
    A = "a"
    B = 2


def test_fingerprint_stable_and_diverging():
    """Equal code and captured values hash alike across separately made
    closures; another captured value or other bytecode does not."""
    base = fingerprint(_make_fn(2.0))
    assert fingerprint(_make_fn(2.0)) == base
    assert fingerprint(_make_fn(3.0)) != base

    def other(i, env):
        return {"y": omp.at(i, env["x"][i] - 1.0)}

    assert fingerprint(other) != base
    t = torch.arange(6, dtype=torch.float32)
    assert fingerprint({"k": t}) == fingerprint({"k": t.clone()})
    assert fingerprint({"k": t}) != fingerprint({"k": t + 1})
    assert fingerprint(t) == fingerprint(t.numpy())     # tensor as array


def test_fingerprint_of_data_equals_the_reference():
    """Data-only parts (numpy arrays, containers, enums, scalars, a plain
    Python function) hash as the reference's ``fingerprint`` hashes
    them."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    parts = [
        ({"k": a, "t": (1, 2.5, "s", None)},),
        ([a, a + 1], {"x": {1, 2}}, frozenset({"p"})),
        (_Kind.A, _Kind.B, np.int32(7) * np.ones(3, np.int32)),
        (_plain,),
        ("compiled-run", 1, (("data", 2), "cpu"), b"raw"),
    ]
    for p in parts:
        assert fingerprint(*p) == jaot.fingerprint(*p), p


def test_stable_program_token_matches_across_recreation():
    from repro_torch.core.api import _stable_program_token

    b1, _ = _block(2.0)
    b2, _ = _block(2.0)
    b3, _ = _block(5.0)
    assert _stable_program_token(b1) == _stable_program_token(b2)
    assert _stable_program_token(b1) != _stable_program_token(b3)


# ---------------------------------------------------------------------------
# store format: save/load, corruption, skew
# ---------------------------------------------------------------------------

BODY = b"\x00entry body\xff" * 40


def test_save_load_round_trip_and_plain_miss(tmp_path):
    store = AOTStore(str(tmp_path))
    assert store.save("k1", BODY) is True
    assert store.stats["disk_bytes_written"] > 0
    assert store.entries() == ["k1"]
    assert store.load("k1") == BODY
    assert store.load("k1", decode=len) == len(BODY)
    assert store.stats["disk_hits"] == 2 and store.stats["disk_errors"] == 0
    fresh = AOTStore(str(tmp_path / "other"))
    assert fresh.load("absent") is None
    assert fresh.stats == {**aot_store.empty_stats(), "disk_misses": 1}


def test_corrupt_truncated_bad_magic_and_refused_entries(tmp_path):
    store = AOTStore(str(tmp_path))
    store.save("k1", BODY)
    path = store._entry_path("k1")
    blob = bytearray(open(path, "rb").read())
    blob[-10] ^= 0xFF                              # flip a body byte
    open(path, "wb").write(bytes(blob))
    assert store.load("k1") is None                # never raises
    assert store.stats["disk_errors"] == 1
    assert store.stats["disk_misses"] == 1
    assert not os.path.exists(path)                # bad entry removed
    assert store.load("k1") is None                # now a plain miss
    assert store.stats["disk_errors"] == 1
    open(store._entry_path("trunc"), "wb").write(b"RPRO")
    open(store._entry_path("junk"), "wb").write(b"\x00" * 64)
    assert store.load("trunc") is None and store.load("junk") is None
    store.save("dec", BODY)

    def refuse(body):
        raise ValueError("not an entry")

    assert store.load("dec", decode=refuse) is None   # a decoder refusing
    assert store.stats["disk_errors"] == 4
    assert store.entries() == []


@pytest.mark.parametrize("field,value", [
    ("store_version", 999), ("torch", "0.0.0"), ("triton", "0.0"),
    ("device", "sm_90")])
def test_version_skew_is_a_miss(tmp_path, field, value):
    store = AOTStore(str(tmp_path))
    store.save("k1", BODY)
    path = store._entry_path("k1")
    blob = open(path, "rb").read()
    off = len(aot_store._MAGIC)
    (hlen,) = struct.unpack_from("<I", blob, off)
    header = json.loads(blob[off + 4:off + 4 + hlen])
    header[field] = value
    header = json.dumps(header).encode()
    open(path, "wb").write(aot_store._MAGIC + struct.pack("<I", len(header))
                           + header + blob[off + 4 + hlen:])
    assert store.load("k1") is None
    assert store.stats["disk_errors"] == 1


# ---------------------------------------------------------------------------
# size-capped eviction
# ---------------------------------------------------------------------------


def _entry_size(tmp_path) -> int:
    probe = AOTStore(str(tmp_path / "probe"))
    probe.save("p", BODY)
    return os.path.getsize(probe._entry_path("p"))


def test_eviction_is_lru_and_spares_the_new_entry(tmp_path):
    size = _entry_size(tmp_path)
    store = AOTStore(str(tmp_path / "s"), max_bytes=2 * size + size // 2)
    debris = os.path.join(store.path, "README.txt")
    open(debris, "w").write("not an entry")        # ignored, never deleted
    for i, key in enumerate(["k0", "k1"]):
        store.save(key, BODY)
        os.utime(store._entry_path(key), (1000.0 + i, 1000.0 + i))
    assert store.load("k0") is not None            # touch: now the MRU
    assert os.path.getmtime(store._entry_path("k0")) > 1001.0
    store.save("k2", BODY)                         # sweeps k1, the LRU
    assert store.stats["evictions"] == 1
    assert store.stats["evicted_bytes"] >= size
    assert store.entries() == ["k0", "k2"]
    assert os.path.exists(debris)
    tiny = AOTStore(str(tmp_path / "t"), max_bytes=size // 2)  # < 1 entry
    assert tiny.save("only", BODY) and tiny.entries() == ["only"]
    tiny.save("next", BODY)
    assert tiny.entries() == ["next"]
    free = AOTStore(str(tmp_path / "u"))
    for key in ("a", "b", "c"):
        free.save(key, BODY)
    assert free.stats["evictions"] == 0 and free.entries() == ["a", "b", "c"]


def test_max_bytes_env_knob(tmp_path, monkeypatch):
    size = _entry_size(tmp_path)
    monkeypatch.setenv(aot_store.ENV_MAX_BYTES, str(size + size // 2))
    store = AOTStore(str(tmp_path / "s"))
    assert store.max_bytes == size + size // 2
    store.save("k0", BODY)
    os.utime(store._entry_path("k0"), (1000.0, 1000.0))
    store.save("k1", BODY)
    assert store.entries() == ["k1"]
    monkeypatch.setenv(aot_store.ENV_MAX_BYTES, "not-a-number")
    assert AOTStore(str(tmp_path / "s2")).max_bytes is None
    monkeypatch.setenv(aot_store.ENV_MAX_BYTES, "0")
    assert AOTStore(str(tmp_path / "s3")).max_bytes is None


# ---------------------------------------------------------------------------
# end to end through omp.compile
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lowering", ["collective", "kernel"])
def test_restored_artifact_skips_planning_and_rebuilds_passes(tmp_path,
                                                              lowering):
    """A cold compile stores its planned artifacts; after the in-memory
    state is dropped, the same program made again restores them (no
    planning: the cache counts no miss), runs to the same outputs, and
    rebuilds its passes when inspected."""
    from repro_torch.core import api

    assert omp.enable_persistent_cache(str(tmp_path)) == str(tmp_path)
    blk, env = _block(3.0)
    c1 = omp.compile(blk, _mesh(), lowering=lowering, env_like=env)
    want = c1(env)["y"]
    assert glob.glob(str(tmp_path / "*.aot")), "cold compile must persist"
    assert omp.compile_cache_stats()["disk_bytes_written"] > 0

    omp.clear_compile_cache()                      # a fresh process's state
    omp.enable_persistent_cache(str(tmp_path))
    b2, env2 = _block(3.0)
    c2 = omp.compile(b2, _mesh(), lowering=lowering, env_like=env2)
    assert c2.restored is True and c2._passes is None
    stats = omp.compile_cache_stats()
    assert stats["disk_hits"] == 1 and stats["misses"] == 0
    assert torch.equal(c2(env2)["y"], want)
    assert c2.restored and c2._passes is None      # still not planned
    # the restored plan references the new program's body
    assert c2._exe.program is b2
    names = [p.name for p in c2.passes]
    assert [n for n in names if n != "kernel"] == list(api.PASS_NAMES)
    assert c2.plan is not None
    if lowering == "kernel":
        assert "kernel" in names and c2.kernel_plan.spans
    assert torch.equal(c2(env2)["y"], want)


def test_corrupt_store_entry_recompiles_cold(tmp_path):
    omp.enable_persistent_cache(str(tmp_path))
    blk, env = _block(4.0)
    omp.compile(blk, _mesh(), env_like=env)
    (entry,) = glob.glob(str(tmp_path / "*.aot"))
    open(entry, "wb").write(b"garbage")

    omp.clear_compile_cache()
    omp.enable_persistent_cache(str(tmp_path))
    b2, env2 = _block(4.0)
    c2 = omp.compile(b2, _mesh(), env_like=env2)
    assert c2.restored is False                    # fell back to planning
    assert torch.equal(c2(env2)["y"], b2(env2)["y"])
    stats = omp.compile_cache_stats()
    assert stats["disk_errors"] >= 1 and stats["misses"] == 1


def test_host_glue_region_is_not_stored(tmp_path):
    """A staged region whose serial glue cannot be shape-traced defers
    its planning to run time: nothing to store, so its key builds cold,
    as the reference's unexportable executors do."""
    from tests.test_torch_region import _host_glue_region
    from repro_torch import convert

    omp.enable_persistent_cache(str(tmp_path))
    reg, env_np = _host_glue_region(omp, torch)
    env = convert.env_from_numpy(env_np, "cpu")
    c = omp.compile(reg, _mesh(), lowering="collective", env_like=env)
    assert torch.allclose(c(env)["y"], reg(env)["y"])
    assert not glob.glob(str(tmp_path / "*.aot"))


_CHILD = textwrap.dedent("""
    import json, sys
    import torch
    from repro_torch import omp

    scale = float(sys.argv[1])

    @omp.parallel_for(stop=16, name="xproc")
    def block(i, env):
        return {"y": omp.at(i, env["x"][i] * scale + 1.0)}

    env = {"x": torch.arange(16, dtype=torch.float32),
           "y": torch.zeros(16, dtype=torch.float32)}
    mesh = omp.make_mesh((2,), ("data",), device="cpu")
    c = omp.compile(block, mesh, lowering="kernel", env_like=env)
    out = c(env)
    s = omp.compile_cache_stats()
    print(json.dumps({"y": out["y"].tolist(), "restored": c.restored,
                      "disk_hits": s["disk_hits"],
                      "disk_misses": s["disk_misses"],
                      "jax": "jax" in sys.modules}))
""")


