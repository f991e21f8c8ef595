"""CTC operations. Counterpart of ``gluon_e2e_asr_tpu/ops/ctc.py``;
this slice needs greedy decoding only (the loss and its kernels K2/K3
arrive with training)."""

from __future__ import annotations

import torch


def ctc_greedy_decode(logits: torch.Tensor, input_lens: torch.Tensor,
                      blank_id: int = 0):
    """Greedy CTC decode: framewise argmax (the first maximum, as JAX's);
    repeats and blanks are collapsed on the device. Returns (ids [B, T],
    lengths [B] int32) where each row holds the collapsed symbols
    left-justified, padded with blank."""
    B, T, _ = logits.shape
    best = torch.argmax(logits, dim=-1)  # [B,T]
    prev = torch.nn.functional.pad(best, (1, 0), value=blank_id)[:, :-1]
    t = torch.arange(T, device=logits.device)[None, :]
    keep = (best != blank_id) & (best != prev) & (t < input_lens[:, None])
    # Left-justify kept symbols: position = cumsum(keep) - 1. Dropped
    # symbols all go to T-1, which the length mask below clears unless
    # every frame was kept (and then none was dropped).
    pos = torch.cumsum(keep, dim=1) - 1
    out_len = keep.sum(dim=1).to(torch.int32)
    blank = torch.full_like(best, blank_id)
    out = blank.clone().scatter_(
        1, torch.where(keep, pos, torch.full_like(pos, T - 1)),
        torch.where(keep, best, blank))
    return torch.where(t < out_len[:, None], out, blank), out_len
