"""Tiny cells for the CPU tests: a copy of the benchmark under a
temporary root, with small configurations and mixes beside the real
ones."""
from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO), str(REPO / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

RESNET = {
    "name": "resnet-tiny", "model": "resnet", "inputs": "images",
    "width": 4, "depth_blocks": [1, 1], "n_classes": 5, "image_size": 8,
    "channels": 3, "reduced": ["width", "depth_blocks", "image_size"],
    "precision": {"params": "float32", "compute": "float32", "tf32": False,
                  "cudnn_deterministic": True},
    "topology": [1, 2, 2], "optimizer": {"name": "sgd", "lr": 0.1},
    "kernels": [],
}
RWKV = {
    "name": "rwkv6-tiny", "model": "rwkv6", "arch": "rwkv6-1.6b",
    "inputs": "tokens", "n_layers": 1, "d_model": 32, "head_dim": 8,
    "ssm_heads": 4, "d_ff": 64, "vocab_size": 128, "norm_eps": 1e-5,
    "reduced": ["n_layers", "d_model", "head_dim", "ssm_heads", "d_ff",
                "vocab_size"],
    "precision": RESNET["precision"], "topology": [1, 2, 2],
    "optimizer": {"name": "sgd", "lr": 0.1}, "kernels": [],
}
TOPK = {"plan": "local@2/global@4:topk:0.25", "bucket_bytes": 0,
        "overlap": True, "batch_per_learner": 4, "noise": 0.6}
QINT8 = dict(TOPK, plan="local@2:qint8/global@4:topk:0.25",
             bucket_bytes=2048)
TOKENS = dict(TOPK, batch_per_learner=2, seq=16, markov_vocab=16,
              markov_temperature=1.5, pool_rounds=4)
LIMITS = {"loss_gap": 1e-4, "grad_gap": 1e-4, "change_gap": 1e-3,
          "ef_gap": 1e-3, "ref_gap": 1e-3}
CELLS = {"tiny-resnet-topk": ("resnet-tiny", "tiny-topk"),
         "tiny-resnet-qint8": ("resnet-tiny", "tiny-qint8"),
         "tiny-rwkv-topk": ("rwkv6-tiny", "tiny-tokens")}


def make_root(tmp: Path) -> Path:
    """A checkout's benchmark at ``tmp``: the real BENCHMARK.json and
    perfbench/, plus the tiny configurations, mixes and cells."""
    root = Path(tmp)
    shutil.copytree(REPO / "perfbench", root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    rules = json.loads((REPO / "perfbench" / "configs"
                        / "resnet18-cifar10.json").read_text())["init"]
    lm_rules = json.loads((REPO / "perfbench" / "configs"
                           / "rwkv6-1.6b.json").read_text())["init"]
    for cfg, init in ((RESNET, rules), (RWKV, lm_rules)):
        path = f"perfbench/configs/{cfg['name']}.json"
        (root / path).write_text(json.dumps(dict(cfg, init=init)))
        bench["configs"].append({"name": cfg["name"], "source": "tiny",
                                 "file": path, "reduced": cfg["reduced"],
                                 "why": "CPU tests"})
    for name, mix in (("tiny-topk", TOPK), ("tiny-qint8", QINT8),
                      ("tiny-tokens", TOKENS)):
        (root / "perfbench" / "traffic" / f"{name}.json").write_text(
            json.dumps(mix))
    for cell, (cfg, mix) in CELLS.items():
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": mix, "chips": 1,
                                   "why": "CPU tests"})
        (root / "perfbench" / "limits" / f"{cell}.json").write_text(
            json.dumps({"limits": LIMITS}))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
