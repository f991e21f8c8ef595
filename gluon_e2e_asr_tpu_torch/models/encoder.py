"""Pyramidal BiLSTM encoder + CTC projection head, with the VGG2L conv
front for ``enc_type: vggblstm``.

Counterpart of ``gluon_e2e_asr_tpu/models/encoder.py``. Parameters keep
the flax names and layouts (``l{n}_in_w`` [D, 8H] with the forward gates
first, ``l{n}_in_b`` [8H], ``l{n}_rec_f`` / ``l{n}_rec_b`` [H, 4H],
``ctc_head.kernel`` [in, out], ``vgg.conv{s}_{k}.kernel`` [3, 3, Cin,
Cout] and ``.bias``), so ``bridge.py`` maps a JAX tree by name alone.
Every BiLSTM layer runs ``ops/bilstm.py::bilstm_fused``: the kernel on a
CUDA tensor, the plain version on a CPU tensor, with its gradient
(K1-bwd or the plain backward) when the parameters require one.
``lstm_impl`` selects the semantics of the JAX path it stands for (see
that module). In training the encoder dropout (``enc_dropout``) takes
its keep masks as an input, one per layer, and applies them to each
layer's output between the kernels. The VGG2L convs are cuDNN
convolutions on the card, as the JAX package's are plain XLA ops.
"""

from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

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


class Conv3x3(nn.Module):
    """flax ``nn.Conv(ch, (3, 3), padding="SAME")`` layout: kernel [3, 3,
    Cin, Cout], bias [Cout]."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(3, 3, cin, cout))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor, compute_dtype: torch.dtype):
        """x [B, Cin, T, F] (NCHW) in ``compute_dtype`` -> [B, Cout, T, F]
        in ``compute_dtype``: flax casts the input, the kernel and the bias
        to its ``dtype``. TF32 stays off in f32."""
        cd = compute_dtype
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            return nn.functional.conv2d(
                x, self.kernel.permute(3, 2, 0, 1).to(cd), self.bias.to(cd),
                padding=1)


class VGG2L(nn.Module):
    """The VGG2L conv front (JAX ``VGG2L``): per stage two 3x3 SAME convs
    with ReLU, the frames past ``lens`` set to zero after each, then a
    2x2 SAME max-pool (``ceil_mode``) and ``lens = (lens + 1) // 2``. The
    feature axis [static | d | dd] splits into ``vgg_in_channels`` conv
    channels; the output is [B, T', F' * C] f32, (f, c) with c minor as
    flax's NHWC reshape gives it."""

    def __init__(self, cfg: ModelConfig, in_dim: int):
        super().__init__()
        C = int(cfg.vgg_in_channels)
        if in_dim % C:
            raise ValueError(
                f"feature dim {in_dim} is not divisible by vgg_in_channels="
                f"{C} (set vgg_in_channels = 1 + frontend.deltas)")
        self.in_channels = C
        feat = in_dim // C
        cin = C
        for stage, ch in enumerate(cfg.vgg_channels):
            for sub in range(2):
                self.add_module(f"conv{stage + 1}_{sub + 1}",
                                Conv3x3(cin, int(ch)))
                cin = int(ch)
            feat = (feat + 1) // 2
        self.stages = len(cfg.vgg_channels)
        self.out_dim = feat * cin

    def convs(self):
        return [getattr(self, f"conv{s + 1}_{k + 1}")
                for s in range(self.stages) for k in range(2)]

    def forward(self, feats: torch.Tensor, lens: torch.Tensor,
                compute_dtype: torch.dtype):
        B, T, D = feats.shape
        C = self.in_channels
        # [B,T,C,F] -> NCHW [B,C,T,F] (H = time, W = the mel bins)
        x = feats.reshape(B, T, C, D // C).permute(0, 2, 1, 3)
        x = x.to(compute_dtype)
        convs = self.convs()
        for stage in range(self.stages):
            valid = (torch.arange(x.shape[2], device=x.device)[None, :]
                     < lens[:, None])[:, None, :, None]
            for conv in convs[2 * stage:2 * stage + 2]:
                x = torch.relu(conv(x, compute_dtype))
                x = torch.where(valid, x, torch.zeros((), dtype=x.dtype,
                                                      device=x.device))
            x = nn.functional.max_pool2d(x, 2, 2, ceil_mode=True)
            lens = (lens + 1) // 2
        Tr = x.shape[2]
        out = x.permute(0, 2, 3, 1).reshape(B, Tr, -1).float()
        return out, lens.to(torch.int32)


class BiLSTMEncoder(nn.Module):
    """Stacked BiLSTM with per-layer subsampling and a CTC head, behind
    the VGG2L front for ``enc_type: vggblstm``."""

    def __init__(self, cfg: ModelConfig, vocab_size: int, in_dim: int):
        super().__init__()
        if cfg.enc_type not in ("blstm", "vggblstm"):
            raise ValueError(f"unknown enc_type {cfg.enc_type!r}")
        self.vgg = None
        if cfg.enc_type == "vggblstm":
            self.vgg = VGG2L(cfg, in_dim)
            in_dim = self.vgg.out_dim
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
        """The flax initializers: lecun_normal input and conv kernels (a
        conv's fan-in is its window times its input channels), orthogonal
        recurrent kernels, zero biases. The VGG2L convs draw first."""
        for conv in self.vgg.convs() if self.vgg is not None else ():
            lecun_normal_(conv.kernel.view(-1, conv.kernel.shape[-1]),
                          generator)
            conv.bias.zero_()
        for layer in range(self.cfg.enc_layers):
            lecun_normal_(getattr(self, f"l{layer}_in_w"), generator)
            getattr(self, f"l{layer}_in_b").zero_()
            for d in ("f", "b"):
                nn.init.orthogonal_(getattr(self, f"l{layer}_rec_{d}"),
                                    generator=generator)
        lecun_normal_(self.ctc_head.kernel, generator)
        self.ctc_head.bias.zero_()

    def layer_frames(self, frames: int) -> List[int]:
        """The output frames of each BiLSTM layer for ``frames`` feature
        frames."""
        out = []
        for _ in range(self.vgg.stages if self.vgg is not None else 0):
            frames = (frames + 1) // 2
        for f in self.subsample:
            frames = -(-frames // f)
            out.append(frames)
        return out

    def forward(self, feats: torch.Tensor, feat_len: torch.Tensor,
                drop_masks: Optional[Sequence[torch.Tensor]] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """feats [B,T,in_dim] f32, feat_len [B] -> (enc [B,T',2H] f32,
        enc_len [B] int32, ctc_logits [B,T',V] f32). ``drop_masks``: the
        encoder dropout's keep masks, one [B, T_l, 2H] bool per layer
        (``training/train_step.py::draw_dropout``), applied to each
        layer's output as flax's ``nn.Dropout``: kept entries scaled by
        1 / (1 - enc_dropout), the others zero. None: no dropout."""
        x, lens = feats, feat_len.to(torch.int32)
        if self.vgg is not None:
            x, lens = self.vgg(x, lens, self.compute_dtype)
        keep = 1.0 - float(self.cfg.enc_dropout)
        for layer in range(self.cfg.enc_layers):
            x, lens = subsample_concat(x, lens, self.subsample[layer])
            x = bilstm_fused(
                x.float().contiguous(), lens,
                getattr(self, f"l{layer}_in_w"),
                getattr(self, f"l{layer}_in_b"),
                getattr(self, f"l{layer}_rec_f"),
                getattr(self, f"l{layer}_rec_b"),
                self.compute_dtype, self.round_xg)
            if drop_masks is not None:
                x = torch.where(drop_masks[layer], x / keep,
                                torch.zeros((), device=x.device))
        ctc_logits = self.ctc_head(x, self.compute_dtype)
        return x, lens, ctc_logits
