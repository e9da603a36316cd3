"""Device and precision policy: the one switch every kernel and module reads.

Stands in for the JAX package's ``dot_precision`` contract
(``prodiff_tpu/ops/pallas/__init__.py``). The only mode today is ``parity``:
float32 operands and float32 accumulation everywhere, with TF32 off for both
matrix products (``torch.backends.cuda.matmul.allow_tf32``) and cuDNN
convolutions (``torch.backends.cudnn.allow_tf32``, which PyTorch leaves ON by
default). A convolution that quietly ran in TF32 would drift by ~1e-3 over
the 20 denoiser layers and break parity with the JAX reference.

The policy is applied when this module is imported, so every entry point of
the package runs in parity mode unless told otherwise.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

PARITY = "parity"
_MODES = (PARITY,)
_mode = PARITY


def set_precision(mode: str = PARITY) -> None:
    """Select the precision mode and set PyTorch's global flags to match."""
    global _mode
    if mode not in _MODES:
        raise NotImplementedError(
            f"precision mode {mode!r}: only {_MODES} exists; bf16 operands "
            "land with a later performance slice"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _mode = mode


def precision() -> str:
    return _mode


def compute_dtype() -> torch.dtype:
    """Operand dtype of every kernel and module under the current mode."""
    return torch.float32


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """``None`` picks the first CUDA card when there is one, else the CPU."""
    if device is None:
        return torch.device("cuda" if torch.cuda.is_available() else "cpu")
    return torch.device(device)


set_precision(PARITY)
