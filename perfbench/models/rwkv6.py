"""The RWKV-6 language model: how the benchmark builds it in the system
under test, its plain reference, its multiply-adds and the bytes of its
WKV6 calls."""
from __future__ import annotations

import dataclasses
from typing import Dict

from perfbench.bench import yardstick
from perfbench.reference import rwkv6 as ref

UNIT = "sequences"
WIDTHS = ("n_layers", "d_model", "head_dim", "ssm_heads", "d_ff",
          "vocab_size", "norm_eps")


def param_specs(cfg: Dict):
    return ref.param_specs(cfg)


def program(cfg: Dict, device, impl: str = "auto"):
    """(loss_fn, a template of the parameter tree on the meta device) of
    the system under test, at the configuration's sizes; ``impl`` picks
    the WKV recurrence (kernels/ops.py: "plain" is the port's own plain
    version, a witness)."""
    from repro_torch.configs import get_config
    from repro_torch.models import build
    arch = dataclasses.replace(get_config(cfg["arch"]),
                               **{k: cfg[k] for k in WIDTHS})
    bundle = build(arch, device=device, impl=impl)
    return bundle.loss_fn, build(arch, device="meta").init_train()


def reference_grads(cfg: Dict):
    return lambda params, batch: ref.learner_grads(params, batch, cfg)


def macs_per_token(cfg: Dict) -> int:
    """Multiply-adds of one token's forward pass: every product with a
    weight, the WKV recurrence (r against S + u k v^T, and the state
    update: 3 D^2 a head), and the output head over the padded vocab."""
    d, f, h, hd = (cfg["d_model"], cfg["d_ff"], cfg["ssm_heads"],
                   cfg["head_dim"])
    a = h * hd
    v = -(-cfg["vocab_size"] // 128) * 128
    tm = (d * 5 * ref.LORA + ref.LORA * 5 * d + 4 * d * a
          + d * ref.DECAY_LORA + ref.DECAY_LORA * a + a * d
          + 3 * h * hd * hd)
    cm = d * f + f * d + d * d
    return cfg["n_layers"] * (tm + cm) + d * v


def macs_per_sample(cfg: Dict, traffic: Dict) -> int:
    return macs_per_token(cfg) * traffic["seq"]


def round_kernel_bytes(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """WKV6 forward and backward bytes a round: one call of each per
    layer and step, on all learners' sequences at once."""
    b = yardstick.learners(cfg) * traffic["batch_per_learner"]
    fwd, bwd = yardstick.wkv_bytes(b, traffic["seq"], cfg["ssm_heads"],
                                   cfg["head_dim"])
    calls = cfg["n_layers"] * yardstick.steps_per_round(traffic)
    return {"wkv6_fwd": calls * fwd, "wkv6_bwd": calls * bwd}
