"""Serving launcher (PyTorch port of ``repro/launch/serve.py``).

  # on the CPU, reduced config, wave batching (ServeEngine):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch rwkv6-1.6b \
      --device cpu

  # paged continuous batching (PagedServeEngine), with telemetry rows:
  PYTHONPATH=src python -m repro_torch.launch.serve --arch yi-34b \
      --paged --device cpu --metrics-out serve.jsonl

  # on the card, full width (random weights from --seed):
  PYTHONPATH=src python -m repro_torch.launch.serve --arch starcoder2-15b \
      --no-reduced --paged --param-dtype bfloat16 --requests 8 --slots 8

The encoder-decoder (seamless-m4t-large-v2) serves on stub audio frames
(``cfg.frontend_tokens`` of them a request, drawn from --seed) that every
prefill takes beside its prompts.  The RWKV-6 and Hymba LMs and the
encoder-decoder serve through ``ServeEngine`` only: ``--paged`` gets the
paged engine's refusal.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.kernels.ops import IMPLS
from repro_torch.models import build
from repro_torch.models.stubs import audio_frame_embeds
from repro_torch.serve import GenerationConfig, PagedServeEngine, ServeEngine
from repro_torch.telemetry import MetricsLogger

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def with_stub_frames(bundle, n: int, seed: int):
    """The bundle with a prefill that takes, beside each wave's prompts,
    the first rows of ``n`` stub frame sequences drawn from ``seed``."""
    cfg = bundle.cfg
    frames = audio_frame_embeds(
        torch.Generator(device=bundle.device).manual_seed(seed), n,
        cfg.frontend_tokens, cfg.d_model)

    def prefill(params, batch):
        b = batch["tokens"].shape[0]
        return bundle.prefill(params, dict(batch, frames=frames[:b]))

    return dataclasses.replace(bundle, prefill=prefill)


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
                         "(PagedServeEngine) instead of wave batching")
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
    ap.add_argument("--metrics-out", default=None,
                    help="write telemetry rows (serve_step per decode "
                         "step on the paged path, serve_summary per "
                         "queue) to this JSONL file")
    args = ap.parse_args(argv)

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
    if cfg.is_encoder_decoder:
        bundle = with_stub_frames(bundle, args.slots, args.seed)
    max_len = args.prompt_len + args.max_new
    gen = GenerationConfig(max_new_tokens=args.max_new,
                           temperature=args.temperature, seed=args.seed)

    rng = np.random.default_rng(args.seed)
    reqs = [rng.integers(0, cfg.vocab_size, size=args.prompt_len)
            .astype(np.int32) for _ in range(args.requests)]
    logger = MetricsLogger(args.metrics_out) if args.metrics_out else None
    t0 = time.time()
    if args.paged:
        budget = int(args.budget_mb * 2 ** 20) or None
        engine = PagedServeEngine(
            bundle, params, slots=args.slots, page_size=args.block_size,
            max_len=max_len, budget_bytes=budget, gen=gen, metrics=logger)
        results = engine.serve_queue(reqs)
    else:
        engine = ServeEngine(bundle, params, max_len=max_len, gen=gen,
                             metrics=logger)
        results = engine.serve_queue(reqs, slots=args.slots)
    dt = time.time() - t0
    total_new = sum(r.steps for r in results)
    total_steps = sum(r.decode_steps for r in results)
    for r in results[:4]:
        print(f"req {r.request_id}: prompt[-4:]={r.prompt[-4:]} "
              f"-> {r.tokens[:8]}")
    print(f"{len(results)} requests, {total_new} tokens / {total_steps} "
          f"decode steps in {dt:.1f}s on {device} ({total_new/dt:.1f} tok/s "
          f"incl. cache allocation)")
    if args.paged:
        print(f"pool: {engine.alloc.n_pages - 1} pages of "
              f"{args.block_size} tokens, peak in use "
              f"{engine.alloc.peak_in_use}")
    s = engine.steady_state_summary()
    print(f"steady-state: engine={s['engine']} tok/s={s['tokens_per_s']} "
          f"wasted={s['wasted_ratio']} occupancy={s['mean_occupancy']} "
          f"refills={s['refill_events']} "
          f"peak_pages={s['peak_pages_in_use']}/{s['pool_pages']}")
    if logger is not None:
        logger.close()
        print(f"telemetry rows -> {args.metrics_out}")


if __name__ == "__main__":
    main()
