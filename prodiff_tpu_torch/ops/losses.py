"""Training losses (port of ``prodiff_tpu/ops/losses.py``): the ProDiff
spectrogram losses (l1 / mse / ssim with non-padding masking), the
rectified flow's velocity loss with logit-normal time weighting, and the
three-level (phoneme / word / sentence) log-domain duration loss. Specs are
``[B, F, T, M]``.
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


def spec_loss_reflow(v_pred: torch.Tensor, v_gt: torch.Tensor, t: torch.Tensor,
                     non_padding: Optional[torch.Tensor], loss_type: str, log_norm: bool = True,
                     name: str = "spec") -> Dict[str, torch.Tensor]:
    """Velocity-matching loss. v_pred/v_gt [B, F, T, M], t [B] in [0, 1],
    non_padding [B, T]. With ``log_norm`` each item is weighted by the
    logit-normal density of its t (clipped to [1e-7, 1 - 1e-7] in float32)."""
    if non_padding is not None:
        mask = non_padding[:, None, :, None].to(v_pred.dtype)
        v_pred = v_pred * mask
        v_gt = v_gt * mask
    if loss_type == "l1":
        loss = (v_pred - v_gt).abs()
    elif loss_type in ("l2", "mse"):
        loss = (v_pred - v_gt).square()
    else:
        raise NotImplementedError(loss_type)
    if log_norm:
        eps = 1e-7
        tc = t.float().clamp(eps, 1 - eps)
        weights = 0.398942 / tc / (1 - tc) * torch.exp(-0.5 * torch.log(tc / (1 - tc)) ** 2) + eps
        loss = weights[:, None, None, None] * loss
    return {name: loss.mean()}


def dur_loss(dur_pred: torch.Tensor, dur_tgt: torch.Tensor, onset: torch.Tensor,
             log_offset: float, lambda_pdur: float, lambda_wdur: float, lambda_sdur: float,
             max_words: Optional[int] = None) -> torch.Tensor:
    """MSE of log(d + log_offset) at the phoneme, word and sentence levels.

    dur_pred/dur_tgt [B, T_ph] (linear domain), onset [B, T_ph] 0/1 word
    starts. Words are ``ph2word = cumsum(onset)`` (1-indexed), summed over
    ``max_words + 1`` segments (default ``T_ph + 1``) and read from segment
    1 on, as the JAX ``segment_sum``: padded phonemes, whose onset is 0,
    join the last word. Predictions are clipped at 0 for the word and
    sentence terms only."""
    def linear2log(x):
        return torch.log(x + log_offset)

    def mse(a, b):
        return (a - b).square().mean()

    pdur = lambda_pdur * mse(linear2log(dur_pred), linear2log(dur_tgt))
    dur_pred = dur_pred.clamp_min(0.0)
    ph2word = torch.cumsum(onset.long(), dim=1)
    n_seg = (max_words if max_words is not None else dur_pred.shape[1]) + 1

    def seg(d):
        out = d.new_zeros(d.shape[0], n_seg)
        return out.scatter_add(1, ph2word, d)[:, 1:]

    wdur = lambda_wdur * mse(linear2log(seg(dur_pred)), linear2log(seg(dur_tgt.to(dur_pred.dtype))))
    sdur = lambda_sdur * mse(linear2log(dur_pred.sum(dim=1)), linear2log(dur_tgt.sum(dim=1)))
    return pdur + wdur + sdur
