"""Helpers of the port's multi-process tests (not collected): run a
function in a fresh gloo group of processes, and the bodies those
processes run.

A child imports torch and ``repro_torch`` only (this module imports no
JAX), runs torch on one thread so that the group does not crowd the
suite's other workers, joins its group through a file store under the
test's temporary directory (so two suite workers never meet on a port),
and hands back what its body returns through ``torch.save``.  A child
that raises makes :func:`spawn` raise.

Every body returns, for each check, the stacked mesh's value beside the
process mesh's (``(want, got)``, already cut to the ranks the process
holds where the value is per rank), and the two meshes' counters.
"""
from __future__ import annotations

import os
import warnings

import torch


def spawn(body, world: int, tmp, **kw) -> list:
    """``body(rank, world, **kw)`` in ``world`` fresh processes joined in
    one gloo group; every rank's returned value, in rank order."""
    return start(body, world, tmp, **kw)()


def start(body, world: int, tmp, **kw):
    """:func:`spawn` without waiting: returns the function that waits for
    the group and returns its values (the caller works meanwhile)."""
    import torch.multiprocessing as mp

    tmp = str(tmp)
    store = os.path.join(tmp, f"store_{body.__name__}_{world}")
    ctx = mp.start_processes(_entry, args=(world, store, body.__name__, tmp,
                                           kw),
                             nprocs=world, start_method="spawn", join=False)

    def results():
        while not ctx.join():
            pass
        return [torch.load(_out(tmp, body.__name__, world, r),
                           weights_only=False) for r in range(world)]

    return results


def _out(tmp, name, world, rank) -> str:
    return os.path.join(tmp, f"{name}_{world}_{rank}.pt")


def _entry(rank, world, store, name, tmp, kw):
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        torch.save(globals()[name](rank, world, **kw),
                   _out(tmp, name, world, rank))
    finally:
        dist.destroy_process_group()


def counters(mesh) -> dict:
    return {"launches": dict(mesh.launches), "bytes": dict(mesh.bytes),
            "log": list(mesh.log or [])}


# ---------------------------------------------------------------------------
# The collectives
# ---------------------------------------------------------------------------


def _pair(stacked, process):
    """(stacked mesh, process mesh) over the same global layout, their
    logs on."""
    stacked.log, process.log = [], []
    return stacked, process


def collectives(rank, world) -> dict:
    """Every collective of the process mesh beside the stacked mesh's, on
    a rank-1 ``("data",)`` mesh of 4 ranks and a ``("data", "model")``
    mesh of (4, 2): reductions (float32, bfloat16, int32), gathers,
    all-to-alls, permutes (full and partial, over the split axis and over
    the whole one), ``axis_index``, ``shard``/``unshard`` by several
    specs, and the gradients through ``ppermute`` and ``all_gather``."""
    from repro_torch.mesh import Mesh, ProcessMesh

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(100 + world)
    res: dict = {}

    def rand(*shape, dtype=torch.float32):
        x = torch.randn(shape, generator=g)
        if dtype == torch.int32:
            return (x * 100).to(torch.int32)
        return x.to(dtype)

    # -- rank 1 -------------------------------------------------------------
    st, pm = _pair(Mesh((4,), ("data",), cpu),
                   ProcessMesh((4,), ("data",), cpu))
    lo, hi = pm.offset, pm.offset + pm.block
    for dtype in (torch.float32, torch.bfloat16, torch.int32):
        x = rand(4, 6, 5, dtype=dtype)
        for op in ("psum", "pmax", "pmin"):
            res[f"1/{op}/{dtype}"] = (getattr(st, op)(x, "data"),
                                      getattr(pm, op)(x[lo:hi], "data"))
    x = rand(4, 7)
    # the split axis's gathers call no deprecated function (a
    # FutureWarning raises here)
    with warnings.catch_warnings():
        warnings.simplefilter("error", FutureWarning)
        res["1/all_gather"] = (st.all_gather(x, "data"),
                               pm.all_gather(x[lo:hi], "data"))
        res["1/psum/warnings"] = (st.psum(x, "data"),
                                  pm.psum(x[lo:hi], "data"))
    y = rand(4, 8, 4)
    for sa, ca in ((0, 1), (1, 0), (0, 0)):
        res[f"1/all_to_all/{sa}{ca}"] = (
            st.all_to_all(y, "data", sa, ca)[lo:hi],
            pm.all_to_all(y[lo:hi], "data", sa, ca))
    perms = {"ring": [(i, (i + 1) % 4) for i in range(4)],
             "partial": [(0, 3), (2, 1)],
             "shift": [(i, i + 1) for i in range(3)]}
    for name, perm in perms.items():
        res[f"1/ppermute/{name}"] = (st.ppermute(y, "data", perm)[lo:hi],
                                     pm.ppermute(y[lo:hi], "data", perm))
    res["1/axis_index"] = (st.axis_index("data")[lo:hi],
                           pm.axis_index("data"))
    w = rand(8, 8)
    for spec in (("data", None), (None, "data"), ()):
        blocks = st.shard(w, spec)
        mine = pm.shard(w, spec)
        cut = blocks[lo:hi] if spec and any(spec) else blocks
        res[f"1/shard/{spec}"] = (cut, mine)
        res[f"1/unshard/{spec}"] = (st.unshard(blocks, spec),
                                    pm.unshard(mine, spec))
    res["1/counters"] = (counters(st), counters(pm))

    # the gradients, each process differentiating its own ranks' share of
    # the loss: a permute's is the inverse permute, a gather's every
    # process's gradient of the stack summed into the sending ranks' rows
    for name, perm in perms.items():
        a = y.clone().requires_grad_()
        b = y[lo:hi].clone().requires_grad_()
        ga, = torch.autograd.grad((st.ppermute(a, "data", perm) ** 2
                                   * torch.arange(1., 5.)).sum(), a)
        gb, = torch.autograd.grad((pm.ppermute(b, "data", perm) ** 2
                                   * torch.arange(1., 5.)).sum(), b)
        res[f"grad/ppermute/{name}"] = (ga[lo:hi], gb)
    def per_rank(stack, ranks):
        """Rank r's term reads rank r + 1's value (mod 4): every row's
        gradient comes from one term, held by the next rank's process."""
        return sum(float(r + 1) * stack[(r + 1) % 4].pow(3).sum()
                   for r in ranks)

    a = y.clone().requires_grad_()
    b = y[lo:hi].clone().requires_grad_()
    ga, = torch.autograd.grad(per_rank(st.all_gather(a, "data"), range(4)),
                              a)
    gb, = torch.autograd.grad(per_rank(pm.all_gather(b, "data"),
                                       pm.local_ranks("data")), b)
    res["grad/all_gather"] = (ga[lo:hi], gb)
    a = y.clone().requires_grad_()
    b = y[lo:hi].clone().requires_grad_()
    ga, = torch.autograd.grad(st.take(a, "data", 3).square().sum(), a)
    gb, = torch.autograd.grad(pm.take(b, "data", 3).square().sum(), b)
    res["grad/take"] = (ga[lo:hi], gb)

    # -- ("data", "model") --------------------------------------------------
    st, pm = _pair(Mesh((4, 2), ("data", "model"), cpu),
                   ProcessMesh((4, 2), ("data", "model"), cpu))
    x = rand(4, 2, 5)
    for op in ("psum", "pmax", "pmin"):
        res[f"2/{op}/both"] = (getattr(st, op)(x, ("data", "model")),
                               getattr(pm, op)(x[lo:hi], ("data", "model")))
    res["2/psum/model,data"] = (
        st.psum(x.transpose(0, 1), ("model", "data")),
        pm.psum(x[lo:hi].transpose(0, 1), ("model", "data")))
    res["2/psum/data"] = (st.psum(x[:, 0], "data"),
                          pm.psum(x[lo:hi, 0], "data"))
    res["2/psum/model"] = (st.psum(x[0], "model"), pm.psum(x[0], "model"))
    res["2/all_gather/model"] = (st.all_gather(x[0], "model"),
                                 pm.all_gather(x[0], "model"))
    res["2/all_gather/data"] = (st.all_gather(x[:, 1], "data"),
                                pm.all_gather(x[lo:hi, 1], "data"))
    z = rand(2, 4, 3)
    res["2/all_to_all/model"] = (st.all_to_all(z, "model", 0, 1),
                                 pm.all_to_all(z, "model", 0, 1))
    zd = rand(4, 2, 8)
    res["2/all_to_all/data"] = (st.all_to_all(zd, "data", 1, 0)[lo:hi],
                                pm.all_to_all(zd[lo:hi], "data", 1, 0))
    res["2/ppermute/model"] = (st.ppermute(z, "model", [(0, 1), (1, 0)]),
                               pm.ppermute(z, "model", [(0, 1), (1, 0)]))
    ring = [(i, (i + 1) % 4) for i in range(4)]
    res["2/ppermute/data"] = (st.ppermute(x, "data", ring)[lo:hi],
                              pm.ppermute(x[lo:hi], "data", ring))
    res["2/ppermute/partial"] = (st.ppermute(x, "data", [(3, 0)])[lo:hi],
                                 pm.ppermute(x[lo:hi], "data", [(3, 0)]))
    res["2/axis_index"] = (
        (st.axis_index("data")[lo:hi], st.axis_index("model")),
        (pm.axis_index("data"), pm.axis_index("model")))
    w = rand(8, 8)
    for spec in (("data", "model"), (("data", "model"), None),
                 ("model", "data"), ("model", None), ()):
        blocks = st.shard(w, spec)
        mine = pm.shard(w, spec)
        cut = blocks[lo:hi] if any("data" in (e if isinstance(e, tuple)
                                              else (e,)) for e in spec) \
            else blocks
        res[f"2/shard/{spec}"] = (cut, mine)
        res[f"2/unshard/{spec}"] = (st.unshard(blocks, spec),
                                    pm.unshard(mine, spec))
    res["2/counters"] = (counters(st), counters(pm))
    return res


# ---------------------------------------------------------------------------
# GPipe, the int8 all-reduce and the refusals
# ---------------------------------------------------------------------------


def gpipe(rank, world) -> dict:
    """The whisper-small smoke encoder's blocks as GPipe stages, one
    stage a process (checkpointed), 3 microbatches: outputs, loss and
    the stage parameters' gradients on the stacked mesh and on the
    process mesh; their ``ppermute`` counts."""
    import dataclasses

    from repro_torch.configs import smoke_config
    from repro_torch.core.pipeline import make_pipeline
    from repro_torch.mesh import Mesh, ProcessMesh
    from repro_torch.models import blocks as blk
    from repro_torch.models import build_model
    from repro_torch.pytree import flatten_with_paths, tree_map

    cpu = torch.device("cpu")
    cfg = smoke_config("whisper-small")
    cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(
        cfg.encoder, n_layers=2 * world))
    model = build_model(cfg)
    enc = model.init(torch.Generator().manual_seed(0))[0]["encoder"]
    m, f, d = 3, cfg.encoder.n_frames, cfg.d_model
    per = model.n_enc // world
    frames = torch.randn((m, 2, f, d), generator=torch.Generator()
                         .manual_seed(1))

    def stage(p, x):
        pos = torch.arange(x.shape[1], dtype=torch.int32).expand(
            x.shape[0], x.shape[1])
        for i in range(per):
            x = blk.block_apply(tree_map(lambda t: t[i], p), x, cfg,
                                "attn:global:dense", positions=pos,
                                impl="full", attn_mode="bidir")[0]
        return x

    stacked = tree_map(lambda t: t.reshape((world, per) + t.shape[1:]), enc)
    out = {}
    for name, mesh in (("stacked", Mesh((world,), ("stage",), cpu)),
                       ("process", ProcessMesh((world,), ("stage",), cpu))):
        lo, hi = (0, world) if name == "stacked" else (
            mesh.offset, mesh.offset + mesh.block)
        params = tree_map(lambda t: t[lo:hi].clone().requires_grad_(),
                          stacked)
        run = make_pipeline(stage, mesh, axis="stage", checkpoint=True)
        y = run(params, frames)
        loss = (y.double() ** 2).sum()
        _, leaves = flatten_with_paths(params)
        grads = torch.autograd.grad(loss, leaves)
        out[name] = {"y": y.detach(), "loss": loss.detach(),
                     "grads": [gr[rank - lo:rank - lo + 1] if name ==
                               "stacked" else gr for gr in grads],
                     "ppermute": mesh.launches["ppermute"]}
    return out


def int8_allreduce(rank, world) -> dict:
    """``compressed_allreduce_tree`` at world 2 on both meshes: the mean,
    the new errors of the process's ranks, the counters."""
    from repro_torch.mesh import Mesh, ProcessMesh
    from repro_torch.optim import compressed_allreduce_tree

    cpu = torch.device("cpu")
    g = torch.Generator().manual_seed(7)
    grads = {"a": torch.randn((2, 37), generator=g),
             "b": {"c": torch.randn((2, 4, 6), generator=g)}}
    errs = {"a": torch.randn((2, 37), generator=g) * 1e-3,
            "b": {"c": torch.zeros((2, 4, 6))}}
    st, pm = _pair(Mesh((2,), ("dp",), cpu), ProcessMesh((2,), ("dp",), cpu))
    want = compressed_allreduce_tree(grads, errs, mesh=st, axis="dp")
    cut = {"a": grads["a"][rank:rank + 1],
           "b": {"c": grads["b"]["c"][rank:rank + 1]}}
    ecut = {"a": errs["a"][rank:rank + 1],
            "b": {"c": errs["b"]["c"][rank:rank + 1]}}
    got = compressed_allreduce_tree(cut, ecut, mesh=pm, axis="dp")
    return {"mean": (want[0], got[0]),
            "errors": ({"a": want[1]["a"][rank:rank + 1],
                        "b": {"c": want[1]["b"]["c"][rank:rank + 1]}},
                       got[1]),
            "counters": (counters(st), counters(pm))}


def _refused(fn) -> str:
    try:
        fn()
    except (ValueError, NotImplementedError) as e:
        return f"{type(e).__name__}: {e}"
    return "not refused"


def refusals(rank, world) -> dict:
    """What the process mesh refuses, as ``"<Error>: <message>"``: among
    them the recovery of a compiled program over it."""
    from repro_torch import omp, polybench
    from repro_torch.configs import ShapeConfig, TrainConfig, smoke_config
    from repro_torch.launch import steps
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.mesh import ProcessMesh
    from repro_torch.runtime import ResilientExecutor, RetryPolicy

    cpu = torch.device("cpu")
    out = {
        "cuda": _refused(lambda: ProcessMesh((2,), ("data",),
                                             torch.device("cuda"))),
        "split": _refused(lambda: ProcessMesh((3, 2), ("data", "model"),
                                              cpu)),
        "shard_seq": _refused(lambda: steps.make_prefill_cell(
            smoke_config("gemma3-1b"), ShapeConfig("p", 16, 1, "prefill"),
            make_process_mesh(1, ranks=2, device=cpu))),
    }
    # one dispatch group over the whole batch: a unit of both ranks
    old = steps.moe_groups
    steps.moe_groups = lambda groups, rows: 1
    try:
        out["moe_unit"] = _refused(lambda: steps.make_train_cell(
            smoke_config("qwen2-moe-a2.7b"), ShapeConfig("t", 16, 4, "train"),
            make_process_mesh(1, ranks=2, device=cpu),
            TrainConfig(microbatch=1)))
    finally:
        steps.moe_groups = old
    kern = polybench.make("gemm", dict(ni=8, nj=8, nk=8))
    compiled = omp.compile(kern.programs[0],
                           make_process_mesh(1, ranks=2, device=cpu))
    out["recovery"] = _refused(lambda: ResilientExecutor(
        compiled, policy=RetryPolicy(max_retries=0))._recover(
            kern.env_fn("cpu")))
    return out


# ---------------------------------------------------------------------------
# The compiler
# ---------------------------------------------------------------------------


def _tapped(log: list):
    """Patch the staging, the dense-value merges and K1's wrapper to note
    the rank dim (dim 1) of every staged slab and every span's and
    merge's dense values in ``log``; returns the undo."""
    from repro_torch.core import kernel_lower as kl
    from repro_torch.core import nest
    from repro_torch.kernels import span_kernel

    saved = []

    def tap(mod, name, pick):
        fn = getattr(mod, name)

        def wrapped(*a, **k):
            out = fn(*a, **k)
            log.extend(int(t.shape[1]) for t in pick(a, k, out))
            return out
        saved.append((mod, name, fn))
        setattr(mod, name, wrapped)

    for name in ("pad_reshape", "halo_slabs", "halo_slabs2"):
        tap(nest, name, lambda a, k, out: [out])
    for name in ("merge_chunk_values", "merge_chunk_values2"):
        tap(kl, name, lambda a, k, out: a[1].values())
    tap(span_kernel, "span_stage_values", lambda a, k, out: [
        t for st in a[0] for t in st.ext_windows.values()] + [
        t for vals in out for t in vals.values()])

    def undo():
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    return undo


def _outcome(mesh, program, env, options):
    """``omp.compile`` and one run on ``mesh``: the result, the plan
    artifacts (the rendered report, the cost summary, the chunk plans,
    the kernel spans) and the counters; or the refusal."""
    from repro_torch import omp
    from repro_torch.core.loop import LoopNotCanonical

    mesh.reset_counters()
    mesh.log = []
    try:
        c = omp.compile(program, mesh, **options)
        out = c(env)
    except (omp.CompileError, LoopNotCanonical, NotImplementedError) as e:
        return {"refused": f"{type(e).__name__}: {e}"}
    kp = c.kernel_plan
    return {"out": out, "report": c.report(), "cost": c.cost_summary(),
            "schedule": repr(c.passes[1].output),
            "spans": None if kp is None else list(kp.spans),
            "counters": counters(mesh)}


def _shared_store(store) -> dict:
    """Every process of the group compiles one program on the process
    mesh with the persistent store in the one directory ``store`` (cold:
    process 0 alone writes the entry), then again after the in-memory
    cache is dropped (every process restores it); the entries on disk and
    each compile's ``restored``; a :class:`CompileService` on the
    process mesh serving four concurrent requests of one cold key; and one
    serving requests of three programs, queued at once in one order on
    every process (their collectives pair only if each process runs them
    in that order), then one more through ``run``."""
    import torch.distributed as dist

    from repro_torch import omp, polybench
    from repro_torch.mesh import ProcessMesh
    from repro_torch.serving.compile_service import CompileService

    kern = polybench.make("gemm", dict(ni=12, nj=10, nk=8))
    env = kern.env_fn("cpu")
    mesh = ProcessMesh((4,), ("data",), torch.device("cpu"))
    omp.enable_persistent_cache(store)
    try:
        restored, written = [], []
        for _ in range(2):
            omp.clear_compile_cache()
            c = omp.compile(kern.programs[0], mesh, lowering="kernel")
            out = c(env)
            restored.append(c.restored)
            written.append(omp.compile_cache_stats()["disk_bytes_written"])
            dist.barrier()
        entries = sorted(os.listdir(store))
    finally:
        omp.disable_persistent_cache()
    # four concurrent requests of one cold key to a service on each
    # process: one compile, each request's result the stacked mesh's
    svc = CompileService(mesh, options=omp.Options(lowering="collective"))
    futures = [svc.submit(kern.programs[0], env) for _ in range(4)]
    served = [f.result()["C"] for f in futures]
    svc.shutdown()
    cold = svc.stats.cold_compiles
    stacked_mesh = omp.make_mesh((4,), ("data",), device="cpu")
    stacked = omp.compile(kern.programs[0], stacked_mesh,
                          lowering="collective")(env)["C"]
    # gemm joins its result, bicg's s and atax's fold each psum a payload
    # of their own size: out of order, the processes' collectives mismatch
    small = dict(m=12, n=10)
    progs = {"gemm": (kern.programs[0], env, "C")}
    for name, i, key in (("bicg", 1, "s"), ("atax", 2, "y")):
        k = polybench.make(name, small)
        progs[name] = (k.programs[i], k.env_fn("cpu"), key)
    order = ["gemm", "bicg", "atax", "bicg", "gemm", "atax", "bicg"]
    svc = CompileService(mesh, options=omp.Options(lowering="collective"))
    futures = [svc.submit(progs[n][0], progs[n][1]) for n in order]
    mixed = [(n, f.result()[progs[n][2]]) for n, f in zip(order, futures)]
    mixed.append(("atax", svc.run(progs["atax"][0],
                                  progs["atax"][1])["y"]))
    svc.shutdown()
    want = {n: omp.compile(p, stacked_mesh, lowering="collective")(e)[key]
            for n, (p, e, key) in progs.items()}
    return {"restored": restored, "entries": entries, "out": out["C"],
            "written": written, "served": served, "stacked": stacked,
            "cold_compiles": cold, "mixed": mixed, "mixed_want": want,
            "mixed_cold_compiles": svc.stats.cold_compiles}


def compile_cases(rank, world, inputs, store=None) -> dict:
    """Each case of ``inputs`` (a file holding a pickled list of (name,
    program, env, mesh shape, axes, [options])): compiled and run on the
    stacked mesh and on a process mesh of the same shape, ``(want, got)``
    per option set; and for the process mesh the rank dims of what it
    staged and computed (``dims``, every one its block where the first
    nest axis is split), beside that block.  With ``store``, also
    :func:`_shared_store` (under the key ``"store"``)."""
    import pickle

    from repro_torch.mesh import Mesh, ProcessMesh

    cpu = torch.device("cpu")
    with open(inputs, "rb") as fh:
        cases = pickle.load(fh)
    res = {}
    if store is not None:
        res["store"] = _shared_store(store)
    for name, program, env, shape, axes, options in cases:
        st = Mesh(shape, axes, cpu)
        pm = ProcessMesh(shape, axes, cpu)
        for i, opts in enumerate(options):
            want = _outcome(st, program, env, opts)
            dims: list = []
            undo = _tapped(dims)
            try:
                got = _outcome(pm, program, env, opts)
            finally:
                undo()
            res[(name, i)] = {"want": want, "got": got, "dims": sorted(
                set(dims)), "block": pm.block}
    return res


def world2(rank, world) -> dict:
    """Everything the two-process group of ``test_torch_process_mesh.py``
    checks, in one spawn."""
    return {"collectives": collectives(rank, world),
            "gpipe": gpipe(rank, world),
            "int8": int8_allreduce(rank, world),
            "refusals": refusals(rank, world)}


# ---------------------------------------------------------------------------
# The train and serve cells
# ---------------------------------------------------------------------------


def train_cells(rank, world, inputs) -> dict:
    """Each case of ``inputs`` (a file holding a list of (name, cfg, mesh
    shape, TrainConfig, params, state, global batch, steps) and serve
    cases) on a process mesh: the metrics of every step, the gathered
    parameters and optimizer state, the counters; and each serve case's
    local logits and gathered caches."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch.mesh import make_process_mesh
    from repro_torch.launch.steps import (make_decode_cell,
                                          make_prefill_cell, make_train_cell)

    cpu = torch.device("cpu")
    spec = torch.load(inputs, weights_only=False)
    out = {}
    for name, cfg, (dp, mp), tcfg, params, state, batch, steps in \
            spec["train"]:
        mesh = make_process_mesh(mp, ranks=dp * mp, device=cpu)
        mesh.log = []
        b, s = batch["labels"].shape
        cell = make_train_cell(cfg, ShapeConfig("t", s, b, "train"), mesh,
                               tcfg)
        p, st = cell.place(params, state)
        rows = b // world
        mine = {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()}
        metrics = []
        for i in steps:
            p, st, m = cell.step_fn(p, st, mine, i)
            metrics.append({k: v.detach() for k, v in m.items()})
        out[name] = {"metrics": metrics, "state": cell.gather(p, st),
                     "counters": counters(mesh)}
    for name, cfg, (dp, mp), params, batch, (toks, poss) in spec["serve"]:
        mesh = make_process_mesh(mp, ranks=dp * mp, device=cpu)
        b, s = next(iter(batch.values())).shape[:2]
        rows = b // world
        pcell = make_prefill_cell(cfg, ShapeConfig("prefill", s, b,
                                                   "prefill"), mesh)
        dcell = make_decode_cell(cfg, ShapeConfig("decode", s, b, "decode"),
                                 mesh)
        p, c = pcell.place(params)
        logits, c = pcell.step_fn(
            p, {k: v[rank * rows:(rank + 1) * rows] for k, v in batch.items()},
            c)
        got = [(logits, pcell.gather(p, c)[1])]
        for tok, pos in zip(toks, poss):
            logits, c = dcell.step_fn(p, c, tok[rank * rows:(rank + 1) * rows],
                                      pos[rank * rows:(rank + 1) * rows])
            got.append((logits, dcell.gather(p, c)[1]))
        out[name] = got
    return out
