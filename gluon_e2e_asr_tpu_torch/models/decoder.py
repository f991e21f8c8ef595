"""LAS-style attention decoder (unidirectional LSTM + attention).

Counterpart of ``gluon_e2e_asr_tpu/models/decoder.py``. The parameters
keep the flax names and layouts of every ``att_type`` (``embed`` [V,E],
``cell0_wx`` [E+D,4H], ``cell0_b``, ``cell0_wh`` [H,4H], ``att_q``
[H,A], ``att_k`` [D,A], ``att_b``/``att_v`` for add and loc,
``loc_filter`` [w,1,C]/``loc_proj`` [C,A] for loc, ``out_w`` [H+D,V],
``out_b``), so every checkpoint of the repo bridges by name
(``bridge.py``).

- ``precompute``: the encoder key projection enc . att_k, once per
  utterance (a large product outside the decoder kernel).
- ``build_loc_band`` / ``_loc_feature``: the location feature of the
  previous attention weights, as a product with the banded filter
  matrix, or a convolution where the band would be too large.
- ``step`` / ``step_beam``: one decode step over an explicit state, the
  JAX signatures (``ops/las_decoder.py::decoder_step``); the beam layout
  keeps the encoder tensors [B,T,*] and puts the beam axis on the
  decoder state only.
- ``forward``: the teacher-forced pass over L steps with the
  scheduled-sampling coins as an input, through
  ``ops/las_decoder.py::las_decoder`` (K4-fwd/K4-bwd on a CUDA tensor,
  the plain loop over ``step`` on a CPU tensor).

``dec_impl`` keeps its meaning: ``pallas`` rounds every decoder
product's operands to ``compute_dtype``; ``scan`` rounds only those of
``precompute`` and runs the steps in f32.

Stacked layers (``dec_layers > 1``; ``cell{l}_*``, layer l > 0 taking
layer l-1's h, the state's h and c [L,B,H]) follow the JAX route, where
``_use_fused`` is False whatever ``dec_impl`` says: the teacher-forced
pass is the loop over ``step`` in f32 (only ``precompute`` rounds to
``compute_dtype``), plain torch with autograd on every device. The route
is chosen by ``dec_layers`` alone; K4 never sees such a model.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from gluon_e2e_asr_tpu_torch.config import ModelConfig
from gluon_e2e_asr_tpu_torch.models.encoder import lecun_normal_
from gluon_e2e_asr_tpu_torch.models.lstm import matmul_cd
from gluon_e2e_asr_tpu_torch.ops.las_decoder import (
    ATT_KINDS, Weights, decoder_step, init_state, las_decoder)

# build_loc_band returns None above this many band entries (T*T*C, 64 MB
# of f32), as the JAX decoder does; the convolution runs instead.
MAX_BAND_ENTRIES = 16_000_000


def check_ported(cfg: ModelConfig) -> None:
    """Raise for a decoder configuration the port does not know."""
    if cfg.att_type not in ATT_KINDS:
        raise ValueError(f"unknown att_type {cfg.att_type!r}")
    if cfg.dec_layers < 1:
        raise ValueError(f"model.dec_layers={cfg.dec_layers}")
    if cfg.dec_impl not in ("scan", "pallas"):
        raise ValueError(f"unknown dec_impl {cfg.dec_impl!r}")


def _lecun_normal(t: torch.Tensor, generator) -> torch.Tensor:
    """flax ``lecun_normal`` for any rank: fan_in is the product of every
    axis but the last (a conv kernel's window times its input channels)."""
    flat = t.view(-1, t.shape[-1])
    lecun_normal_(flat, generator)
    return t


class AttentionDecoder(nn.Module):
    def __init__(self, cfg: ModelConfig, vocab_size: int, sos_id: int = 2,
                 eos_id: int = 3):
        super().__init__()
        self.cfg = cfg
        self.vocab_size = vocab_size
        self.sos_id, self.eos_id = sos_id, eos_id
        V, E, H, A = vocab_size, cfg.dec_embed, cfg.dec_hidden, cfg.att_dim
        D = 2 * cfg.enc_hidden
        shapes = {"embed": (V, E)}
        in_dims = [E + D] + [H] * (cfg.dec_layers - 1)
        for layer in range(cfg.dec_layers):
            shapes[f"cell{layer}_wx"] = (in_dims[layer], 4 * H)
            shapes[f"cell{layer}_b"] = (4 * H,)
            shapes[f"cell{layer}_wh"] = (H, 4 * H)
        shapes["att_q"] = (H, A)
        shapes["att_k"] = (D, A)
        if cfg.att_type in ("add", "loc"):
            shapes["att_b"] = (A,)
            shapes["att_v"] = (A, 1)
        if cfg.att_type == "loc":
            shapes["loc_filter"] = (cfg.loc_conv_width, 1, cfg.loc_conv_channels)
            shapes["loc_proj"] = (cfg.loc_conv_channels, A)
        shapes["out_w"] = (H + D, V)
        shapes["out_b"] = (V,)
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.zeros(shape)))
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initializers: normal(1/sqrt(E)) for the embedding,
        lecun_normal for the dense and conv kernels, orthogonal for the
        recurrent kernels, zeros for the biases."""
        for name, p in self.named_parameters():
            if name == "embed":
                p.normal_(0.0, 1.0 / math.sqrt(p.shape[1]), generator=generator)
            elif name.endswith("_wh"):
                nn.init.orthogonal_(p, generator=generator)
            elif name.endswith("_b") or name == "out_b":
                p.zero_()
            else:
                _lecun_normal(p, generator)

    def compute_dtype(self) -> torch.dtype:
        return getattr(torch, self.cfg.compute_dtype)

    def cells(self):
        """Each LSTM layer's (w_x, b_x, w_h)."""
        return tuple((getattr(self, f"cell{layer}_wx"),
                      getattr(self, f"cell{layer}_b"),
                      getattr(self, f"cell{layer}_wh"))
                     for layer in range(self.cfg.dec_layers))

    def weights(self) -> Weights:
        """Layer 0's parameters in ``ops/las_decoder.py``'s order;
        constant zeros for what the attention type has not (att_b and
        att_v for dot, loc_proj unless loc)."""
        A = self.cfg.att_dim
        has_av = self.cfg.att_type in ("add", "loc")
        dev = self.att_q.device
        return Weights(
            self.embed, self.cell0_wx, self.cell0_b, self.cell0_wh,
            self.att_q,
            self.att_b if has_av else torch.zeros(A, device=dev),
            self.att_v if has_av else torch.zeros(A, 1, device=dev),
            self.loc_proj if self.cfg.att_type == "loc"
            else torch.zeros(1, A, device=dev),
            self.out_w, self.out_b)

    def precompute(self, enc: torch.Tensor) -> torch.Tensor:
        """Encoder key projection [B,T,A], f32 sums of compute-dtype
        operands."""
        return matmul_cd(enc, self.att_k, self.compute_dtype())

    # ------------------------------------------------------------------
    # The location feature
    # ------------------------------------------------------------------
    def build_loc_band(self, T: int) -> Optional[torch.Tensor]:
        """The location convolution as a banded matrix [T, T*C], (t,c)
        minor: band[s, t*C + c] = filter[s - t + (w-1)//2, 0, c]. None
        when T*T*C exceeds MAX_BAND_ENTRIES (the JAX ``build_loc_band``)."""
        C, w = self.cfg.loc_conv_channels, self.cfg.loc_conv_width
        if T * T * C > MAX_BAND_ENTRIES:
            return None
        dev = self.loc_filter.device
        k = (torch.arange(T, device=dev)[:, None]
             - torch.arange(T, device=dev)[None, :] + (w - 1) // 2)
        valid = (k >= 0) & (k < w)
        band = torch.where(valid[..., None],
                           self.loc_filter[k.clamp(0, w - 1), 0, :],
                           torch.zeros((), device=dev))
        return band.reshape(T, T * C)

    def _loc_feature(self, att_prev: torch.Tensor,
                     loc_band: Optional[torch.Tensor]) -> torch.Tensor:
        """att_prev [N,T] -> [N,T,C]: the band product when there is a
        band, else the convolution with XLA's SAME padding ((w-1)//2 frames
        before, the rest after), in true f32 (cuDNN's TF32 off)."""
        N, T = att_prev.shape
        if loc_band is not None:
            return torch.matmul(att_prev, loc_band).view(N, T, -1)
        w = self.cfg.loc_conv_width
        x = F.pad(att_prev[:, None, :], ((w - 1) // 2, w - 1 - (w - 1) // 2))
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            f = F.conv1d(x, self.loc_filter.permute(2, 1, 0))  # [N,C,T]
        return f.transpose(1, 2)

    # ------------------------------------------------------------------
    # Single decode steps (greedy and beam search)
    # ------------------------------------------------------------------
    def init_state(self, batch: int, enc_frames: int) -> Dict[str, torch.Tensor]:
        return init_state(batch, enc_frames, self.cfg.dec_hidden,
                          2 * self.cfg.enc_hidden, self.att_q.device,
                          self.cfg.dec_layers)

    def init_state_beam(self, batch: int, beams: int, enc_frames: int
                        ) -> Dict[str, torch.Tensor]:
        """The beam layout's zeros: h, c [L,B*K,H], att_w [B,K,T], context
        [B*K,D]."""
        state = self.init_state(batch * beams, enc_frames)
        state["att_w"] = state["att_w"].view(batch, beams, enc_frames)
        return state

    def _step(self, state, token, enc, enc_proj, enc_mask, loc_band, beams):
        check_ported(self.cfg)
        feature = None
        if self.cfg.att_type == "loc":
            feature = lambda a: self._loc_feature(a, loc_band)  # noqa: E731
        return decoder_step(self.weights(), state, token, enc, enc_proj,
                            enc_mask, torch.float32, self.cfg.att_type,
                            feature, beams, self.cells())

    def step(self, state, token, enc, enc_proj, enc_mask, loc_band=None):
        """One decode step. token [B] -> (new_state, logits [B,V]); the
        products in f32, as the JAX ``step``. ``loc_band`` (loc only):
        ``build_loc_band``'s matrix, built once outside the loop; None
        runs the convolution."""
        return self._step(state, token, enc, enc_proj, enc_mask, loc_band,
                          None)

    def step_beam(self, state, token, enc, enc_proj, enc_mask, beams: int,
                  loc_band=None):
        """One decode step over B*K flattened beams with shared encoder
        tensors. token [B*K] -> (new_state, logits [B*K,V])."""
        return self._step(state, token, enc, enc_proj, enc_mask, loc_band,
                          beams)

    def forward(self, enc: torch.Tensor, enc_len: torch.Tensor,
                tokens_in: torch.Tensor,
                coins: Optional[torch.Tensor] = None) -> torch.Tensor:
        """enc [B,T,D], enc_len [B], tokens_in [B,L] (tokens_in[:,0] is
        sos), coins [L,B] bool (feed the previous step's argmax; None for
        none; step 0 always takes sos). Returns logits [B,L,V] predicting
        tokens_in shifted by one."""
        check_ported(self.cfg)
        B, L = tokens_in.shape
        coins_bl = (torch.zeros(B, L, dtype=torch.bool, device=enc.device)
                    if coins is None else coins.T.to(enc.device).bool().clone())
        coins_bl[:, 0] = False
        if self.cfg.dec_layers > 1:
            return self._stacked(enc, enc_len, tokens_in, coins_bl)
        cd = self.compute_dtype() if self.cfg.dec_impl == "pallas" else torch.float32
        return las_decoder(
            tokens_in, coins_bl, enc, self.precompute(enc), enc_len,
            self.weights(), cd, self.cfg.att_type,
            self.loc_filter if self.cfg.att_type == "loc" else None)

    def _stacked(self, enc, enc_len, tokens_in, coins_bl) -> torch.Tensor:
        """The JAX ``lax.scan`` over ``step`` (its route for stacked
        layers), plain torch: the previous step's argmax where the coin
        says so, step 0 the gold sos."""
        B, T = enc.shape[0], enc.shape[1]
        enc_mask = (torch.arange(T, device=enc.device)[None, :]
                    < enc_len.to(enc.device)[:, None]).float()
        enc_proj = self.precompute(enc)
        loc_band = (self.build_loc_band(T) if self.cfg.att_type == "loc"
                    else None)
        state = self.init_state(B, T)
        pred = tokens_in[:, 0]
        out = []
        for i in range(tokens_in.shape[1]):
            tok = torch.where(coins_bl[:, i], pred, tokens_in[:, i])
            state, logits = self.step(state, tok, enc, enc_proj, enc_mask,
                                      loc_band)
            pred = torch.argmax(logits, dim=-1).to(tokens_in.dtype)
            out.append(logits)
        return torch.stack(out, dim=1)
