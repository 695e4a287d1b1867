"""Serving example: continuous batching over a small LM — the
counterpart of ``examples/serve_lm.py``.

Submits a queue of prompts to the slot-based engine; decode steps are
batched across live requests, and finished slots are immediately
refilled from the queue (vLLM-style continuous batching).  The weights
are random, drawn from a seeded ``torch.Generator``.  Runs on the CUDA
card unless ``--device cpu`` is given.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_lm
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.mesh import resolve_device
from repro_torch.models import build_model
from repro_torch.serving import Request, ServeEngine


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--requests", type=int, default=10)
    ap.add_argument("--new-tokens", type=int, default=12)
    ap.add_argument("--device", default=None,
                    help="cpu, or a CUDA device (default: the card)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cfg = smoke_config("gemma3-1b")
    model = build_model(cfg)
    params, _ = model.init(torch.Generator(device=device).manual_seed(0))
    engine = ServeEngine(model, params, n_slots=4, cache_len=128,
                         compute_dtype=torch.float32)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size,
                                        size=rng.integers(4, 10)).tolist(),
                    max_new_tokens=args.new_tokens)
            for i in range(args.requests)]
    for r in reqs:
        engine.submit(r)

    t0 = time.time()
    ticks = 0
    while any(not r.done for r in reqs):
        live = engine.tick()
        ticks += 1
        if ticks % 5 == 0:
            done = sum(r.done for r in reqs)
            print(f"tick {ticks:3d}: {live} live slots, {done} done")
    dt = time.time() - t0
    tokens = sum(len(r.output) for r in reqs)
    print(f"\nserved {len(reqs)} requests / {tokens} tokens "
          f"in {dt:.2f}s over {ticks} ticks")
    for r in reqs[:3]:
        print(f"  req {r.rid}: {r.prompt} -> {r.output}")
    return reqs


if __name__ == "__main__":
    main()
