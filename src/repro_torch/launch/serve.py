"""Paged serving launcher (PyTorch port of ``repro/launch/serve.py``).

  # on the card, full width (random weights from --seed):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-15b \
      --no-reduced --paged --param-dtype bfloat16 --requests 8 --slots 8

  # on the CPU, reduced config:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-15b \
      --reduced --paged --device cpu

Only the ``--paged`` path (PagedServeEngine) is ported; the dense wave
engine raises until it is (ROADMAP Queue 1: serving).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import build
from repro_torch.serve import GenerationConfig, PagedServeEngine

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="serve the arch's .reduced() smoke variant "
                         "(--no-reduced: full width)")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true",
                    help="continuous batching over a paged KV cache "
                         "(PagedServeEngine); the only path ported so far")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged KV page size in tokens")
    ap.add_argument("--budget-mb", type=float, default=0.0,
                    help="paged pool byte budget (0 => size for "
                         "slots x max_len)")
    ap.add_argument("--decode-impl", default="auto", choices=list(IMPLS),
                    help="flash-decode dispatch for the paged path")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; cpu runs the plain "
                         "kernel versions)")
    ap.add_argument("--param-dtype", default="float32",
                    choices=sorted(DTYPES))
    args = ap.parse_args(argv)

    if not args.paged:
        raise NotImplementedError(
            "the dense wave-batched ServeEngine is not ported yet "
            "(ROADMAP Queue 1: serving); pass --paged")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but CUDA is not available; pass "
                           "--device cpu to run on the CPU")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    bundle = build(cfg, param_dtype=DTYPES[args.param_dtype],
                   decode_impl=args.decode_impl, device=device)
    params = bundle.init(torch.Generator(device=device).manual_seed(args.seed))
    max_len = args.prompt_len + args.max_new
    gen = GenerationConfig(max_new_tokens=args.max_new,
                           temperature=args.temperature, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    reqs = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
            .astype(np.int32) for _ in range(args.requests)]
    t0 = time.time()
    budget = int(args.budget_mb * 2 ** 20) or None
    engine = PagedServeEngine(
        bundle, params, slots=args.slots, page_size=args.block_size,
        max_len=max_len, budget_bytes=budget, gen=gen)
    results = engine.serve_queue(reqs)
    dt = time.time() - t0
    total_new = sum(r.steps for r in results)
    total_steps = sum(r.decode_steps for r in results)
    for r in results[:4]:
        print(f"req {r.request_id}: prompt[-4:]={r.prompt[-4:]} "
              f"-> {r.tokens[:8]}")
    print(f"{len(results)} requests, {total_new} tokens / {total_steps} "
          f"decode steps in {dt:.1f}s on {device} ({total_new/dt:.1f} tok/s "
          f"incl. pool allocation)")
    print(f"pool: {engine.alloc.n_pages - 1} pages of {args.block_size} "
          f"tokens, peak in use {engine.alloc.peak_in_use}")
    s = engine.steady_state_summary()
    print(f"steady-state: engine={s['engine']} tok/s={s['tokens_per_s']} "
          f"wasted={s['wasted_ratio']} occupancy={s['mean_occupancy']} "
          f"refills={s['refill_events']} "
          f"peak_pages={s['peak_pages_in_use']}/{s['pool_pages']}")


if __name__ == "__main__":
    main()
