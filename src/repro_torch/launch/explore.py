"""Interactive roofline explorer — napkin math as a CLI (PyTorch port of
``repro/launch/explore.py``).

Evaluate any (arch x shape x layout x K1/K2 x mesh) through the analytic
model (``launch/analytic.py``, an H100's constants) without tracing; the
workflow is: explore here, then check the winner with ``dryrun
--layout``.  The projected MFU divides by the H100's peak
(``analytic.PEAK_FLOPS``).  Host arithmetic: it runs anywhere, and takes
``--device`` as every entry point of the port does.

  PYTHONPATH=src python -m repro_torch.launch.explore --arch rwkv6-1.6b \
      --shape train_4k --layout 32x4x1x2:1 --k2 8
  PYTHONPATH=src python -m repro_torch.launch.explore \
      --arch mistral-large-123b --shape train_4k --sweep-k2 --multi-pod
"""
from __future__ import annotations

import argparse
import dataclasses

from repro_torch.configs import get_config
from repro_torch.configs.base import HierAvgParams
from repro_torch.launch.analytic import PEAK_FLOPS, analytic_roofline
from repro_torch.launch.cases import parse_layout


def show(cfg, shape, *, multi_pod, hier):
    r = analytic_roofline(cfg, shape, multi_pod=multi_pod, hier=hier)
    lay = cfg.layout
    print(f"{cfg.name} x {shape} on {'2pod/512' if multi_pod else '1pod/256'}"
          f"  layout={lay.groups}x{lay.local}x{lay.fsdp}x{lay.tp}"
          f":{lay.microbatch}  K1={hier.k1} K2={hier.k2}")
    print(f"  compute    {1e3*r.compute_s:10.2f} ms")
    print(f"  memory     {1e3*r.memory_s:10.2f} ms")
    print(f"  collective {1e3*r.collective_s:10.2f} ms"
          f"   <- bottleneck: {r.bottleneck}")
    for k, v in sorted(r.collective_parts.items(), key=lambda kv: -kv[1]):
        print(f"      {k:12s} {1e3*v:10.2f} ms")
    mfu = r.model_flops_per_device / (
        max(r.compute_s, r.memory_s, r.collective_s) * PEAK_FLOPS)
    print(f"  projected MFU at the binding term: {mfu:.1%}")
    return r


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--layout", default=None)
    ap.add_argument("--k1", type=int, default=4)
    ap.add_argument("--k2", type=int, default=8)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--sweep-k2", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="the card by default; cpu runs without one")
    args = ap.parse_args(argv)
    import torch
    if torch.device(args.device).type == "cuda" \
            and not torch.cuda.is_available():
        raise SystemExit("launch.explore runs on the card by default, and "
                         "CUDA is not available: pass --device cpu")

    cfg = get_config(args.arch)
    if args.layout:
        cfg = dataclasses.replace(cfg, layout=parse_layout(args.layout))
    if args.sweep_k2:
        for k2 in (1, 2, 4, 8, 16, 32, 64):
            k1 = min(args.k1, k2)
            r = analytic_roofline(cfg, args.shape, multi_pod=args.multi_pod,
                                  hier=HierAvgParams(k1, k2))
            g = r.collective_parts.get("global_avg", 0.0)
            lo = r.collective_parts.get("local_avg", 0.0)
            print(f"K2={k2:3d}: global_avg={1e3*g:8.3f} ms "
                  f"local_avg={1e3*lo:8.3f} ms "
                  f"total_coll={1e3*r.collective_s:9.2f} ms")
        return
    show(cfg, args.shape, multi_pod=args.multi_pod,
         hier=HierAvgParams(args.k1, args.k2))


if __name__ == "__main__":
    main()
