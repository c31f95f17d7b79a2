"""Batched serving example (the port of ``examples/serve_batch.py``): the
Qwen2-VL backbone (reduced) answering a queue of mixed-length requests
through the slot-based engine, including the vision-embedding stub path
for one multimodal prefill.  Where the reference prints its jit trace
counts, the port prints its engines' prefill and decode call counts.

    PYTHONPATH=src python -m repro_torch.examples.serve_batch [--device cpu]
"""
import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.examples import example_device
from repro_torch.models import build
from repro_torch.models.stubs import mrope_positions, vision_patch_embeds
from repro_torch.serve import (GenerationConfig, PagedServeEngine,
                               ServeEngine)
from repro_torch.serve.kvcache import describe_cache


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = example_device(ap.parse_args(argv).device)

    cfg = get_config("qwen2-vl-2b").reduced()
    bundle = build(cfg, cache_dtype=torch.float32, device=dev)
    params = bundle.init(torch.Generator(device=dev).manual_seed(0))
    engine = ServeEngine(bundle, params, max_len=96,
                         gen=GenerationConfig(max_new_tokens=8,
                                              temperature=0.7, seed=1))

    # --- text request queue (mixed lengths, slot-batched) ---
    rng = np.random.default_rng(0)
    requests = [rng.integers(0, cfg.vocab_size, size=n).astype(np.int32)
                for n in (12, 12, 20, 20, 20, 8)]
    t0 = time.time()
    results = engine.serve_queue(requests, slots=2)
    dt = time.time() - t0
    print(f"served {len(results)} text requests in {dt:.1f}s")
    for r in results[:3]:
        print(f"  req {r.request_id}: {len(r.prompt)} prompt toks -> "
              f"{r.tokens.tolist()}")

    # --- one multimodal request: stub ViT patches + text, M-RoPE ---
    nv, st = 16, 8
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, st)),
                             dtype=torch.int32, device=dev)
    extras = {
        "vision_embeds": vision_patch_embeds(
            torch.Generator(device=dev).manual_seed(2), 1, nv, cfg.d_model),
        "positions": mrope_positions(1, nv, st, device=dev),
    }
    out = engine.generate(tokens, extras=extras)
    print(f"multimodal generate ({nv} patches + {st} text): "
          f"{out[0].tolist()}")
    print("decode cache:", describe_cache(cfg, batch=1, max_len=96))
    print(f"dense engine: {engine.prefill_traces} prefill calls, "
          f"{engine.decode_traces} decode loops")

    # --- same queue through the paged engine: continuous batching means a
    # finished request's slot (and its KV pages) is refilled mid-stream
    # instead of waiting for its wave ---
    paged = PagedServeEngine(bundle, params, slots=2, page_size=8,
                             max_len=96, prefill_chunk=8,
                             cache_dtype=torch.float32,
                             gen=GenerationConfig(max_new_tokens=8,
                                                  temperature=0.7, seed=1))
    chunks = [0]
    prefill_chunk = paged._prefill_chunk

    def counted(*a):
        chunks[0] += 1
        return prefill_chunk(*a)

    paged._prefill_chunk = counted
    t0 = time.time()
    presults = paged.serve_queue(requests)
    dt = time.time() - t0
    print(f"paged: served {len(presults)} requests in {dt:.1f}s "
          f"(pool {paged.alloc.n_pages - 1} pages, "
          f"peak {paged.alloc.peak_in_use} in use, "
          f"{chunks[0]} prefill chunk calls + {paged.decode_calls} decode "
          f"steps)")
    for r in presults[:3]:
        print(f"  req {r.request_id}: {len(r.prompt)} prompt toks -> "
              f"{r.tokens.tolist()} in {r.decode_steps} decode steps")


if __name__ == "__main__":
    main()
