"""Attention-branch losses and the joint CTC-attention objective.

Counterpart of ``gluon_e2e_asr_tpu/ops/losses.py``: the teacher-forcing
inputs and targets (``make_decoder_io``), the padding-masked
cross-entropy with label smoothing, and
L = mtl_alpha * L_ctc + (1 - mtl_alpha) * L_att.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch


def make_decoder_io(labels: torch.Tensor, label_lens: torch.Tensor,
                    sos_id: int, eos_id: int, pad_id: int = 0):
    """labels [B, L] (padded with pad_id) ->
      tokens_in [B, L+1] = [sos, y_1..y_L]
      targets   [B, L+1] = [y_1..y_L, eos at position label_len]
      tgt_mask  [B, L+1] = positions <= label_len (f32)"""
    B, L = labels.shape
    dev = labels.device
    tokens_in = torch.cat(
        [torch.full((B, 1), sos_id, dtype=labels.dtype, device=dev), labels], 1)
    pos = torch.arange(L + 1, device=dev)[None, :]
    targets = torch.cat(
        [labels, torch.full((B, 1), pad_id, dtype=labels.dtype, device=dev)], 1)
    targets = torch.where(pos == label_lens[:, None],
                          torch.full_like(targets, eos_id), targets)
    tgt_mask = (pos <= label_lens[:, None]).float()
    return tokens_in, targets, tgt_mask


def ce_label_smoothing_loss(logits: torch.Tensor, targets: torch.Tensor,
                            mask: torch.Tensor, smoothing: float = 0.1
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(per-sample summed CE [B], per-sample token accuracy [B]) of
    logits [B,L,V] against targets [B,L] under mask [B,L]. The smoothed
    target puts 1-eps on the gold token and eps uniformly over the whole
    vocabulary; the accuracy takes the first maximum, as jnp.argmax."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    gold = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    uniform = logp.mean(dim=-1)
    nll = -((1.0 - smoothing) * gold + smoothing * uniform)
    loss = (nll * mask).sum(dim=-1)
    pred = torch.argmax(logits, dim=-1)
    acc = ((pred == targets.long()).float() * mask).sum(dim=-1)
    denom = torch.clamp(mask.sum(dim=-1), min=1.0)
    return loss, acc / denom


def hybrid_loss(ctc_nll: torch.Tensor, att_ce: torch.Tensor,
                label_lens: torch.Tensor, mtl_alpha: float,
                num_real: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per-token-normalized mtl_alpha * L_ctc + (1 - mtl_alpha) * L_att,
    averaged over the real (non-pad) rows. Pad rows carry zero loss
    already."""
    denom_tok = torch.clamp(label_lens.float(), min=1.0)
    ctc_per = ctc_nll / denom_tok
    att_per = att_ce / (denom_tok + 1.0)  # +1 for the eos target
    n = torch.clamp(num_real.float(), min=1.0)
    ctc_mean = ctc_per.sum() / n
    att_mean = att_per.sum() / n
    total = mtl_alpha * ctc_mean + (1.0 - mtl_alpha) * att_mean
    return {"loss": total, "loss_ctc": ctc_mean, "loss_att": att_mean}
