"""Spectrogram training losses (port of the ProDiff part of
``prodiff_tpu/ops/losses.py``): l1 / mse / ssim with non-padding masking, on
the ``[B, F, T, M]`` layout. The rectified-flow and duration losses belong
to the variance slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from prodiff_tpu_torch.ops.ssim import ssim


def parse_loss_spec(spec: str) -> Dict[str, float]:
    """Parse ``"l1:0.5|ssim:0.5"`` / ``"l1"`` into {name: weight}."""
    out: Dict[str, float] = {}
    for part in spec.split("|"):
        if ":" in part:
            name, w = part.split(":")
            out[name] = float(w)
        else:
            out[part] = 1.0
    return out


def ssim_loss(pred: torch.Tensor, target: torch.Tensor, bias: float = 6.0) -> torch.Tensor:
    """1 - SSIM with the reference's +6.0 brightness bias. Inputs [B, F, T, M]."""
    return 1 - ssim(pred + bias, target + bias)


def spec_loss_prodiff(pred_spec: torch.Tensor, gt_spec: torch.Tensor,
                      non_padding: Optional[torch.Tensor], loss_type: Dict[str, float],
                      name: str = "spec") -> Dict[str, torch.Tensor]:
    """x0-prediction losses. pred/gt: [B, F, T, M]; non_padding: [B, T]."""
    if non_padding is not None:
        mask = non_padding[:, None, :, None].to(pred_spec.dtype)
        pred_spec = pred_spec * mask
        gt_spec = gt_spec * mask
    losses = {}
    for loss_name, lbd in loss_type.items():
        if loss_name == "l1":
            loss = (pred_spec - gt_spec).abs().mean()
        elif loss_name in ("mse", "l2"):
            loss = (pred_spec - gt_spec).square().mean()
        elif loss_name == "ssim":
            loss = ssim_loss(pred_spec, gt_spec)
        else:
            raise NotImplementedError(loss_name)
        losses[f"{name}_{loss_name}"] = loss * lbd
    return losses
