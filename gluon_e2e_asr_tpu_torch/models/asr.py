"""The hybrid CTC/attention ASR model: encoder + CTC head + LAS decoder.

Counterpart of ``gluon_e2e_asr_tpu/models/asr.py``. The decoder is part
of the model when ``loss.mtl_alpha < 1`` (the hybrid objective), as
``build_model`` there decides. The frontend stays a pure function
(``frontend.features``).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from gluon_e2e_asr_tpu_torch.config import Config, ModelConfig
from gluon_e2e_asr_tpu_torch.models.decoder import AttentionDecoder, check_ported
from gluon_e2e_asr_tpu_torch.models.encoder import BiLSTMEncoder


class ASRModel(nn.Module):
    """Encoder and CTC head, and with ``use_decoder`` the attention
    decoder (``build_model`` decides as the JAX package does)."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, in_dim: int,
                 sos_id: int = 2, eos_id: int = 3, use_decoder: bool = False):
        super().__init__()
        self.cfg = cfg
        self.sos_id, self.eos_id = sos_id, eos_id
        self.use_decoder = use_decoder
        self.encoder = BiLSTMEncoder(cfg, vocab_size, in_dim)
        if use_decoder:
            self.decoder = AttentionDecoder(cfg, vocab_size, sos_id, eos_id)

    def forward(self, feats: torch.Tensor, feat_len: torch.Tensor,
                tokens_in: Optional[torch.Tensor] = None,
                coins: Optional[torch.Tensor] = None,
                drop_masks=None) -> Dict[str, torch.Tensor]:
        """``coins`` [L,B] bool: the scheduled-sampling draws (None: gold
        tokens only); ``drop_masks``: the encoder dropout's keep masks
        (None: no dropout)."""
        enc, enc_len, ctc_logits = self.encoder(feats, feat_len, drop_masks)
        out = {"enc": enc, "enc_len": enc_len, "ctc_logits": ctc_logits}
        if self.use_decoder and tokens_in is not None:
            out["att_logits"] = self.decoder(enc, enc_len, tokens_in, coins)
        return out

    # The sub-paths of decoding, as the JAX model exposes them.
    def encode(self, feats: torch.Tensor, feat_len: torch.Tensor):
        return self.encoder(feats, feat_len)

    def decoder_precompute(self, enc):
        return self.decoder.precompute(enc)

    def decoder_init_state(self, batch, enc_frames):
        return self.decoder.init_state(batch, enc_frames)

    def decoder_step(self, state, token, enc, enc_proj, enc_mask,
                     loc_band=None):
        return self.decoder.step(state, token, enc, enc_proj, enc_mask,
                                 loc_band)

    def decoder_init_state_beam(self, batch, beams, enc_frames):
        return self.decoder.init_state_beam(batch, beams, enc_frames)

    def decoder_step_beam(self, state, token, enc, enc_proj, enc_mask,
                          beams, loc_band=None):
        return self.decoder.step_beam(state, token, enc, enc_proj, enc_mask,
                                      beams, loc_band)

    def decoder_loc_band(self, enc_frames):
        if self.cfg.att_type != "loc":
            return None
        return self.decoder.build_loc_band(enc_frames)


def build_model(config: Config, vocab_size: int, train: bool = False,
                sos_id: int = 2, eos_id: int = 3,
                use_decoder: Optional[bool] = None) -> ASRModel:
    """The model for ``config``, parameters initialized as flax would
    (``reset_parameters(generator)`` of the encoder and the decoder for a
    seed). The decoder is built when ``use_decoder``, by default when
    ``loss.mtl_alpha < 1``; training (``train``) checks that the port
    runs its configuration."""
    if use_decoder is None:
        use_decoder = config.loss.mtl_alpha < 1.0
    if train and use_decoder:
        check_ported(config.model)
    in_dim = config.frontend.n_mels * (1 + int(config.frontend.deltas))
    return ASRModel(config.model, vocab_size, in_dim, sos_id, eos_id,
                    use_decoder)
