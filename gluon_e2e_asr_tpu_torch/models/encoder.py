"""Pyramidal BiLSTM encoder + CTC projection head.

Counterpart of ``gluon_e2e_asr_tpu/models/encoder.py`` for
``enc_type: blstm``. Parameters keep the flax names and layouts
(``l{n}_in_w`` [D, 8H] with the forward gates first, ``l{n}_in_b``
[8H], ``l{n}_rec_f`` / ``l{n}_rec_b`` [H, 4H], ``ctc_head.kernel``
[in, out]), so ``bridge.py`` maps a JAX tree by name alone. Every layer
runs ``ops/bilstm.py::bilstm_fused``: the kernel on a CUDA tensor, the
plain version on a CPU tensor. ``lstm_impl`` selects the semantics of
the JAX path it stands for (see that module).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
from torch import nn

from gluon_e2e_asr_tpu_torch.config import ModelConfig
from gluon_e2e_asr_tpu_torch.ops.bilstm import bilstm_fused


def subsample_concat(x: torch.Tensor, lens: torch.Tensor, factor: int):
    """Pyramidal reduction: concatenate ``factor`` consecutive frames and
    stride by ``factor``. [B,T,D] -> [B,ceil(T/f),f*D]; len -> ceil(len/f)."""
    if factor == 1:
        return x, lens
    B, T, D = x.shape
    pad = (-T) % factor
    if pad:
        x = nn.functional.pad(x, (0, 0, 0, pad))
    x = x.reshape(B, (T + pad) // factor, factor * D)
    return x, (lens + factor - 1) // factor


def lecun_normal_(t: torch.Tensor, generator: Optional[torch.Generator]):
    """flax ``lecun_normal``: truncated normal (2 std) of variance
    1/fan_in, fan_in being the first axis of an [in, out] kernel."""
    std = math.sqrt(1.0 / t.shape[0]) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std,
                                 generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense`` layout: kernel [in, out], bias [out]. With a
    bf16 ``compute_dtype`` the product, the bias and the sum are in bf16,
    as flax computes them; the result is returned in f32."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype):
        cd = compute_dtype
        out = torch.matmul(x.to(cd), self.kernel.to(cd)) + self.bias.to(cd)
        return out.float()


class BiLSTMEncoder(nn.Module):
    """Stacked BiLSTM with per-layer subsampling and a CTC head."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, in_dim: int):
        super().__init__()
        if cfg.enc_type == "vggblstm":
            raise NotImplementedError(
                "enc_type=vggblstm (the VGG2L conv front) is not ported yet; "
                "see ROADMAP.md")
        if cfg.enc_type != "blstm":
            raise ValueError(f"unknown enc_type {cfg.enc_type!r}")
        if cfg.lstm_impl not in ("scan", "pallas"):
            raise ValueError(f"unknown lstm_impl {cfg.lstm_impl!r}")
        self.cfg = cfg
        self.compute_dtype = getattr(torch, cfg.compute_dtype)
        # lstm_impl=scan rounds the projection to the compute dtype.
        self.round_xg = cfg.lstm_impl == "scan"
        H = cfg.enc_hidden
        self.subsample = tuple(int(f) for f in cfg.enc_subsample) + (1,) * max(
            0, cfg.enc_layers - len(cfg.enc_subsample))
        D = in_dim
        for layer in range(cfg.enc_layers):
            D *= self.subsample[layer]
            self.register_parameter(
                f"l{layer}_in_w", nn.Parameter(torch.empty(D, 8 * H)))
            self.register_parameter(
                f"l{layer}_in_b", nn.Parameter(torch.zeros(8 * H)))
            self.register_parameter(
                f"l{layer}_rec_f", nn.Parameter(torch.empty(H, 4 * H)))
            self.register_parameter(
                f"l{layer}_rec_b", nn.Parameter(torch.empty(H, 4 * H)))
            D = 2 * H
        self.ctc_head = Dense(D, vocab_size)
        self.reset_parameters()

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """The flax initializers: lecun_normal input kernels, orthogonal
        recurrent kernels, zero biases."""
        for layer in range(self.cfg.enc_layers):
            lecun_normal_(getattr(self, f"l{layer}_in_w"), generator)
            getattr(self, f"l{layer}_in_b").zero_()
            for d in ("f", "b"):
                nn.init.orthogonal_(getattr(self, f"l{layer}_rec_{d}"),
                                    generator=generator)
        lecun_normal_(self.ctc_head.kernel, generator)
        self.ctc_head.bias.zero_()

    def forward(self, feats: torch.Tensor, feat_len: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """feats [B,T,in_dim] f32, feat_len [B] -> (enc [B,T',2H] f32,
        enc_len [B] int32, ctc_logits [B,T',V] f32)."""
        x, lens = feats, feat_len.to(torch.int32)
        for layer in range(self.cfg.enc_layers):
            x, lens = subsample_concat(x, lens, self.subsample[layer])
            x = bilstm_fused(
                x.float().contiguous(), lens,
                getattr(self, f"l{layer}_in_w"),
                getattr(self, f"l{layer}_in_b"),
                getattr(self, f"l{layer}_rec_f"),
                getattr(self, f"l{layer}_rec_b"),
                self.compute_dtype, self.round_xg)
        ctc_logits = self.ctc_head(x, self.compute_dtype)
        return x, lens, ctc_logits
