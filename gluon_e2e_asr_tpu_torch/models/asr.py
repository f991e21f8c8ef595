"""The ASR model: encoder + CTC head.

Counterpart of ``gluon_e2e_asr_tpu/models/asr.py``. This slice serves
greedy CTC decoding, which needs no attention decoder; the decoder
(and the ``decoder_*`` methods of the JAX model) arrives with beam
search. The frontend stays a pure function (``frontend.features``).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from gluon_e2e_asr_tpu_torch.config import Config, ModelConfig
from gluon_e2e_asr_tpu_torch.models.encoder import BiLSTMEncoder


class ASRModel(nn.Module):
    def __init__(self, cfg: ModelConfig, vocab_size: int, in_dim: int):
        super().__init__()
        self.cfg = cfg
        self.encoder = BiLSTMEncoder(cfg, vocab_size, in_dim)

    def forward(self, feats: torch.Tensor,
                feat_len: torch.Tensor) -> Dict[str, torch.Tensor]:
        enc, enc_len, ctc_logits = self.encoder(feats, feat_len)
        return {"enc": enc, "enc_len": enc_len, "ctc_logits": ctc_logits}

    def encode(self, feats: torch.Tensor, feat_len: torch.Tensor):
        return self.encoder(feats, feat_len)


def build_model(config: Config, vocab_size: int) -> ASRModel:
    """The model for ``config``, parameters initialized as flax would
    (call ``model.encoder.reset_parameters(generator)`` for a seed)."""
    in_dim = config.frontend.n_mels * (1 + int(config.frontend.deltas))
    return ASRModel(config.model, vocab_size, in_dim)
