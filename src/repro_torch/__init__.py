"""PyTorch / CUDA port of the ``repro`` package.

It mirrors the JAX package's module paths and function names, imports
nothing of JAX or of ``repro``, and runs its entry points on ``cuda``
unless the caller asks for ``device="cpu"``.  Ported so far: paged serving
of the dense GQA decoders (``launch/serve.py --paged``) with a hand-written
flash-decode kernel for Hopper, and the Hier-AVG trainer
(``core/simulator.py::Simulator``) with every compressed reduction of the
reference (mean, cast, top-k, random-k, qint8, PowerSGD), per leaf or on
the bucket engine, through hand-written top-k, qint8 pack/unpack and
batched-QR kernels; elastic membership (``elastic/``), checkpoints
(``checkpoint/``), telemetry (``telemetry/``) and the cost model
(``core/theory.py``).
"""
