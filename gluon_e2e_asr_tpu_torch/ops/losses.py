"""The joint CTC-attention objective. Counterpart of
``gluon_e2e_asr_tpu/ops/losses.py``; ``make_decoder_io`` and the
label-smoothed CE arrive with the attention decoder."""

from __future__ import annotations

from typing import Dict

import torch


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
