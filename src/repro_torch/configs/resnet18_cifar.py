"""The paper's own experimental model family.

The Hier-AVG paper trains ResNet-18 / GoogLeNet / MobileNet / VGG19 on
CIFAR-10 (and ResNet on ImageNet-1K).  For the paper-validation benchmarks we
provide a compact JAX ResNet (models/resnet.py) plus an MLP classifier for
fast CPU sweeps.  These configs drive benchmarks/, not the dry-run pool.
"""
from dataclasses import dataclass
from typing import Tuple


@dataclass(frozen=True)
class CNNConfig:
    name: str = "resnet18-cifar"
    depth_blocks: Tuple[int, ...] = (2, 2, 2, 2)   # resnet-18 layout
    width: int = 16                                 # narrow for CPU sims
    n_classes: int = 10
    image_size: int = 32
    channels: int = 3


@dataclass(frozen=True)
class MLPConfig:
    name: str = "mlp-classifier"
    in_dim: int = 64
    hidden: Tuple[int, ...] = (128, 128)
    n_classes: int = 10


def resnet18_cifar() -> CNNConfig:
    return CNNConfig()


def mlp_classifier() -> MLPConfig:
    return MLPConfig()
