"""PyTorch and CUDA port of the executable stack of ``repro``.

The package mirrors ``repro``'s layout (``configs``, ``core``, ``kernels``,
``models``, ``serving``, ``launch``) and imports nothing of it, nor JAX.
Entry points run on ``cuda`` unless the caller passes ``device="cpu"``; each
kernel wrapper launches its hand-written Hopper kernel for a CUDA tensor and
runs its plain PyTorch version for a CPU tensor.
"""
