"""ResNet-18 in the CIFAR form: how the benchmark builds it in the system
under test, its plain reference, and its multiply-adds."""
from __future__ import annotations

import math
from typing import Dict

from perfbench.reference import resnet as ref

UNIT = "images"


def param_specs(cfg: Dict):
    return ref.param_specs(cfg)


def program(cfg: Dict, device, impl: str = "auto"):
    """(loss_fn, a template of the parameter tree on the meta device) of
    the system under test (its model has no kernel of its own: ``impl``
    changes nothing)."""
    from repro_torch.configs.resnet18_cifar import CNNConfig
    from repro_torch.models.resnet import resnet_init, resnet_loss
    cnn = CNNConfig(width=cfg["width"],
                    depth_blocks=tuple(cfg["depth_blocks"]),
                    n_classes=cfg["n_classes"],
                    image_size=cfg["image_size"], channels=cfg["channels"])

    def loss_fn(p, b):
        return resnet_loss(p, b, cnn)

    return loss_fn, resnet_init(None, cnn, device="meta")


def reference_grads(cfg: Dict):
    return lambda params, batch: ref.learner_grads(params, batch, cfg)


def macs_per_sample(cfg: Dict, traffic: Dict) -> int:
    """Multiply-adds of one image's forward pass: every convolution at
    its output size ("SAME": ceil(in / stride)), and the head."""
    size = cfg["image_size"]
    total = 9 * cfg["channels"] * cfg["width"] * size * size
    c = cfg["width"]
    for stage, n in enumerate(cfg["depth_blocks"]):
        cout = cfg["width"] * 2 ** stage
        for b in range(n):
            out = math.ceil(size / (2 if b == 0 and stage > 0 else 1))
            total += 9 * c * cout * out * out + 9 * cout * cout * out * out
            if c != cout:
                total += c * cout * out * out
            c, size = cout, out
    return total + c * cfg["n_classes"]


def round_kernel_bytes(cfg: Dict, traffic: Dict) -> Dict[str, int]:
    """The model's own hand-written kernels' bytes a round: none."""
    return {}
