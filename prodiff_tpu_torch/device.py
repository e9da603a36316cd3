"""Device and precision policy: the one switch every kernel and module reads.

Stands in for the JAX package's choice of backend and its ``dot_precision``
contract (``prodiff_tpu/ops/pallas/__init__.py``). Two modes:

- ``parity`` (the default): what the JAX package computes on the CPU. Every
  "on the accelerator" rule of its config resolves off: ``bf16: null`` trains
  in float32 and the WaveNet stack's products take float32 operands unless
  ``bf16``/``amp`` is true.
- ``fast``: what the JAX package computes on its accelerator, with the CUDA
  card in the TPU's place: ``bf16: null`` trains with the bf16 compute policy
  (``prodiff_tpu/models/prodiff.py:resolve_train_bf16``), a render's
  WaveNet stack streams its weights in ``pallas_wavenet_dtype`` (bfloat16 by
  default), as the JAX kernel route does, NSF-HiFiGAN's resblock stages take
  bf16 tap stacks (``nsf_fused_res_dtype``, :func:`resblock_tap_dtype`) and
  FastDiff's fused-layer route computes its KernelPredictor, and so its
  window kernels, in bf16 (:func:`kernel_predictor_dtype`).

Both modes keep TF32 off for matrix products
(``torch.backends.cuda.matmul.allow_tf32``) and cuDNN convolutions
(``torch.backends.cudnn.allow_tf32``, which PyTorch leaves ON by default): a
float32 product runs in float32, and ``fast`` changes only the dtypes that
the config's keys name. A convolution that quietly ran in TF32 would drift
by ~1e-3 over the 20 denoiser layers and break parity with the JAX
reference.

The policy is applied when this module is imported, so every entry point of
the package runs in parity mode unless told otherwise.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Union

import torch

PARITY = "parity"
FAST = "fast"
_MODES = (PARITY, FAST)
_mode = PARITY

Device = Union[str, torch.device]


def set_precision(mode: str = PARITY) -> None:
    """Select the precision mode and set PyTorch's global flags to match."""
    global _mode
    if mode not in _MODES:
        raise NotImplementedError(
            f"precision mode {mode!r}: the modes are {_MODES}; bf16 operands are "
            "chosen by the config's bf16/amp/pallas_wavenet_dtype keys, not by a mode"
        )
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    _mode = mode


def precision() -> str:
    return _mode


def compute_dtype() -> torch.dtype:
    """Operand dtype of every float32 kernel and module: the dtype of the
    activations, carries and biases in both modes (bf16 operands are named
    by the config, per module)."""
    return torch.float32


def _on_card(device: Optional[Device]) -> bool:
    return _mode == FAST and device is not None and torch.device(device).type == "cuda"


def resolve_train_bf16(hp: Dict[str, Any], device: Optional[Device]) -> Dict[str, Any]:
    """The tri-state ``bf16`` hparam for training (port of
    ``prodiff_tpu/models/prodiff.py:resolve_train_bf16``): ``bf16: true`` or
    ``amp: true`` force the bf16 compute policy on, ``bf16: false`` forces
    it off, and ``bf16: null`` is on only in ``fast`` mode on a CUDA device
    (the JAX package's "on the accelerator"). Returns ``hp`` itself when a
    key decides, else a copy with ``bf16`` set."""
    if hp.get("bf16", None) is not None or hp.get("amp", False):
        return hp
    return dict(hp, bf16=_on_card(device))


def module_dtype(hp: Dict[str, Any]) -> Optional[torch.dtype]:
    """flax's ``dtype=`` of the teacher's encoder and WaveNet
    (``prodiff_tpu/models/prodiff.py:63-66``): bfloat16 where ``bf16`` or
    ``amp`` is true, else None (float32)."""
    return torch.bfloat16 if (hp.get("bf16", False) or hp.get("amp", False)) else None


def stream_dtype(hp: Dict[str, Any]) -> torch.dtype:
    """``pallas_wavenet_dtype`` (default ``bfloat16``) as the JAX teacher
    reads it (``prodiff_tpu/models/prodiff.py:112-116``)."""
    return torch.float32 if hp.get("pallas_wavenet_dtype", "bfloat16") == "float32" else torch.bfloat16


def kernel_operand_dtype(dtype: Optional[torch.dtype], stream: torch.dtype,
                         train: bool) -> torch.dtype:
    """Operand dtype of the WaveNet stack's products on the kernel route (the
    card's) for a module of compute dtype ``dtype`` and weight stream
    ``stream``: in training the module's dtype; at inference ``stream`` in
    ``fast`` mode (the JAX kernel route), else the module's dtype."""
    if not train and _mode == FAST:
        return stream
    return dtype or torch.float32


FUSED_RES_DTYPES = ("auto", "float32", "off")


def resblock_tap_dtype(hp: Dict[str, Any], device: Optional[Device]) -> torch.dtype:
    """Tap dtype of NSF-HiFiGAN's resblock stages, read from
    ``nsf_fused_res_dtype`` as ``prodiff_tpu/vocoders/nsf_hifigan.py:99-106``
    reads it: ``auto`` (the default; also an empty value) gives bfloat16 tap
    stacks on the JAX package's packed accelerator route (``nsf_packed``
    unset or true), here ``fast`` mode on a CUDA device, else float32;
    ``float32`` and ``off`` give float32. ``off`` selects the JAX package's
    packed-XLA stages, which the port does not have: it runs the float32
    kernel, the same function. Any other value raises, as the JAX dict lookup
    does. Which stages take the bf16 stacks is the model's stage gate
    (``models/nsf_hifigan.py:stage_tap_dtypes``)."""
    value = hp.get("nsf_fused_res_dtype", "auto") or "auto"
    if value not in FUSED_RES_DTYPES:
        raise KeyError(f"nsf_fused_res_dtype {value!r}: one of {FUSED_RES_DTYPES}")
    packed = hp.get("nsf_packed", None) is not False
    return torch.bfloat16 if value == "auto" and packed and _on_card(device) else torch.float32


def hifigan_tap_dtype(hp: Dict[str, Any], device: Optional[Device]) -> torch.dtype:
    """Tap dtype of HiFiGAN's resblock stages (``vocoders/hifigan.py``):
    bfloat16 where the JAX ``HifiGAN`` renders through its packed runner
    with ``fused_res_dtype="auto"`` on the accelerator
    (``prodiff_tpu/vocoders/hifigan.py:81-84``, ``prodiff_tpu/models/hifigan.py:198-201``):
    ``hifigan_packed`` unset or true, here ``fast`` mode on a CUDA device;
    else float32. Which stages take the bf16 stacks is the model's stage
    gate (``models/hifigan.py:HifiGanGenerator._packed_supported``)."""
    packed = hp.get("hifigan_packed", None) is not False
    return torch.bfloat16 if packed and _on_card(device) else torch.float32


def kernel_predictor_dtype(fused_layer: bool, device: Optional[Device]) -> torch.dtype:
    """Compute dtype of FastDiff's KernelPredictor: bfloat16 on the fused-layer
    route in ``fast`` mode on a CUDA device, as the JAX packed route builds
    it off interpret mode (``prodiff_tpu/models/fastdiff.py:522-535``,
    ``:675-721``), so the window kernels come out bf16; float32 otherwise,
    and always on the unfused route (``fastdiff_packed: false``), whose JAX
    counterpart (the linen route) builds it with the module's dtype, which
    no config sets."""
    return torch.bfloat16 if fused_layer and _on_card(device) else torch.float32


def check_tp_dilation(hp: Dict[str, Any]) -> None:
    """``model_parallel > 1`` with ``dilation_cycle_length != 1`` raises the
    JAX teacher's ``ValueError``, word for word
    (``prodiff_tpu/models/wavenet.py:100-112``): the tensor-parallel
    denoiser needs one dilation in every layer."""
    cycle = hp.get("dilation_cycle_length", 1)
    if hp.get("model_parallel", 1) > 1 and cycle != 1:
        raise ValueError(
            "model_parallel > 1 requires dilation_cycle_length == 1 "
            f"(got {cycle}); the TP denoiser stacks "
            "per-layer params and needs uniform dilation"
        )


def resolve_device(device: Optional[Device] = None, local_rank: Optional[int] = None) -> torch.device:
    """``None`` means the CUDA card: ``cuda:local_rank`` where a launcher
    gave the process a local rank. The CPU is used only when named; asking
    for a card where there is none raises."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA card (torch.cuda.is_available() is false): the port runs on "
            "the card unless the caller names the CPU (device='cpu', --device cpu)"
        )
    if device.type == "cuda" and device.index is None and local_rank is not None:
        device = torch.device("cuda", local_rank)
    return device


set_precision(PARITY)
