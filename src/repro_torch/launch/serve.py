"""Serving driver: batched requests through the continuous-batching
engine — counterpart of :mod:`repro.launch.serve`.

Example (on the CUDA card; ``--smoke --device cpu`` runs a reduced model
on the CPU)::

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \\
      --requests 8 --max-new 16
  PYTHONPATH=src python -m repro_torch.launch.serve \\
      --arch qwen2-moe-a2.7b --weights-dtype bfloat16 --requests 8

The weights are random, drawn from a ``torch.Generator`` seeded with
``--seed`` and stored as ``--weights-dtype`` (qwen2-moe-a2.7b's 14.3 B
parameters take 29 GB in bfloat16); prompts are random token ids.  The
engine computes in float32, and every prefill's attention runs K2 (its
plain version on the CPU); an SSM model (``--arch mamba2-130m``)
prefills with the chunked scan and decodes with its recurrence, a
hybrid (``--arch jamba-1.5-large-398b --smoke``) keeps both caches, and
an MoE model dispatches each call's tokens to its experts.
"""
from __future__ import annotations

import argparse
import logging
import time

import numpy as np
import torch

log = logging.getLogger("repro_torch.serve")


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--weights-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s %(name)s %(message)s")

    from repro_torch.configs import get_config, smoke_config
    from repro_torch.mesh import resolve_device
    from repro_torch.models import build_model
    from repro_torch.serving import Request, ServeEngine

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if cfg.embedding_stub:
        raise SystemExit(f"{cfg.name}: serving needs token inputs "
                         "(the vlm stub arch serves via the embeds API)")
    model = build_model(cfg)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params, _ = model.init(gen, dtype=getattr(torch, args.weights_dtype))
    engine = ServeEngine(model, params, n_slots=args.slots,
                         cache_len=args.cache_len,
                         temperature=args.temperature,
                         compute_dtype=torch.float32, seed=args.seed)
    rng = np.random.default_rng(args.seed)
    reqs = []
    for rid in range(args.requests):
        prompt = rng.integers(1, cfg.vocab_size,
                              size=rng.integers(3, 12)).tolist()
        req = Request(rid=rid, prompt=prompt, max_new_tokens=args.max_new)
        reqs.append(req)
        engine.submit(req)

    t0 = time.perf_counter()
    ticks = 0
    while any(not r.done for r in reqs):
        engine.tick()
        ticks += 1
        if ticks > 10_000:
            raise RuntimeError("engine did not drain")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    total_tokens = sum(len(r.output) for r in reqs)
    log.info("served %d requests, %d tokens in %.2fs (%.1f tok/s, "
             "%d ticks) on %s", len(reqs), total_tokens, dt,
             total_tokens / max(dt, 1e-9), ticks, device)
    for r in reqs[:4]:
        log.info("req %d: prompt=%s -> %s", r.rid, r.prompt, r.output)
    return reqs


if __name__ == "__main__":
    main()
