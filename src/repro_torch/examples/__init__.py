"""The reference's four examples (``examples/*.py``), as modules of the
port, each run as ``python -m repro_torch.examples.<name>`` on the card
(``--device cpu`` on the CPU): ``quickstart``, ``train_lm``,
``serve_batch`` and ``topology_demo``."""
from __future__ import annotations

import torch


def example_device(name: str) -> torch.device:
    """The device an example runs on: the card unless ``--device cpu``;
    an example refuses to start on the card's default without CUDA."""
    dev = torch.device(name)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("this example runs on the card by default, and "
                         "CUDA is not available: pass --device cpu")
    return dev
