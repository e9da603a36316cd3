"""PyTorch/CUDA port of ProDiff-TPU for NVIDIA Hopper.

A second package beside ``prodiff_tpu`` (the JAX reference, which it is held
against). Layout mirrors the JAX package: ``models/``, ``ops/``,
``vocoders/``, ``pe/``, ``infer/``, ``serve/``, ``data/``, ``tasks/``,
``training/``, ``utils/``. Public functions keep the
JAX package's ``[B, T, C]`` layout. The kernels that the JAX package wrote in
Pallas for the TPU are CUDA C++ for ``sm_90a`` under ``csrc/``, built with
``nvcc`` at first use on a CUDA tensor (``ops/cuda_build.py``).

This package imports ``torch`` and never ``jax``, ``flax`` or
``prodiff_tpu``: it keeps its own copies of the framework-free modules it
needs (text/pitch/audio utilities, config, schedules, collation, the
indexed dataset, the mel filterbank and the ACF pitch tracker's host part),
under the JAX package's module names.
"""

from prodiff_tpu_torch import device  # noqa: F401  (applies the precision policy)

__version__ = "0.1.0"
