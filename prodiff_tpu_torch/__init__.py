"""PyTorch/CUDA port of ProDiff-TPU for NVIDIA Hopper.

A second package beside ``prodiff_tpu`` (the JAX reference, which it is held
against). Layout mirrors the JAX package: ``models/``, ``ops/``,
``vocoders/``, ``infer/``, ``serve/``, ``utils/``. Public functions keep the
JAX package's ``[B, T, C]`` layout. The kernels that the JAX package wrote in
Pallas for the TPU are CUDA C++ for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use on a CUDA tensor (``ops/cuda_build.py``).

This package imports ``torch`` and never ``jax`` or ``flax``. It shares the
framework-free modules of ``prodiff_tpu`` (pitch/text/audio utilities, the
collate helpers and the diffusion schedules) instead of copying them.
"""

from prodiff_tpu_torch import device  # noqa: F401  (applies the precision policy)

__version__ = "0.1.0"
