"""Training losses: CTC, label-smoothed CE, and their hybrid (the port of
the JAX package's `training/losses.py`): L = l*CTC + (1-l)*CE."""

from __future__ import annotations

import torch

from pytorch_end2end_speech_recognition_tpu_torch.models.decoder_transformer import (  # noqa: E501
    SOS_EOS_ID,
)
from pytorch_end2end_speech_recognition_tpu_torch.ops.ctc import ctc_loss


def attention_ce_loss(logps: torch.Tensor, tokens: torch.Tensor,
                      token_lens: torch.Tensor,
                      label_smoothing: float = 0.0) -> torch.Tensor:
    """Per-utterance mean CE over the targets [tokens, eos] (eos placed at
    token_lens), with label smoothing toward the uniform distribution; 0
    for pad rows. logps (B, U+1, V), tokens (B, U) -> (B,)."""
    B, U1, V = logps.shape
    targets = torch.cat([tokens.long(), tokens.new_zeros((B, 1)).long()], 1)
    targets = targets.scatter(1, token_lens.long()[:, None], SOS_EOS_ID)
    mask = torch.arange(U1, device=logps.device)[None, :] <= token_lens[:, None]
    nll = -logps.gather(-1, targets[..., None])[..., 0]
    if label_smoothing > 0.0:
        uniform = -logps.mean(dim=-1)
        nll = (1.0 - label_smoothing) * nll + label_smoothing * uniform
    zero = torch.zeros((), device=logps.device)
    n = torch.clamp(token_lens + 1, min=1).to(logps.dtype)
    per_utt = torch.where(mask, nll, zero).sum(dim=1) / n
    return torch.where(token_lens == 0, zero, per_utt)


def hybrid_loss(ctc_logits, enc_lens, att_logps, tokens, token_lens,
                ctc_weight: float, label_smoothing: float = 0.0,
                ctc_impl: str = "torch"):
    """(batch-mean hybrid loss, metrics): the CTC NLL divided by
    max(token_len, 1), both terms summed over rows and divided by the number
    of rows with token_len > 0 (at least 1)."""
    n_valid = torch.clamp((token_lens > 0).sum(), min=1).float()
    metrics = {}
    total = torch.zeros((), device=ctc_logits.device)
    if ctc_weight > 0.0:
        per_utt = ctc_loss(ctc_logits, enc_lens, tokens, token_lens,
                           impl=ctc_impl)
        ctc_mean = (per_utt / torch.clamp(token_lens, min=1)).sum() / n_valid
        metrics["ctc_loss"] = ctc_mean
        total = total + ctc_weight * ctc_mean
    if att_logps is not None and ctc_weight < 1.0:
        ce = attention_ce_loss(att_logps, tokens, token_lens, label_smoothing)
        ce_mean = ce.sum() / n_valid
        metrics["att_loss"] = ce_mean
        total = total + (1.0 - ctc_weight) * ce_mean
    metrics["loss"] = total
    return total, metrics
