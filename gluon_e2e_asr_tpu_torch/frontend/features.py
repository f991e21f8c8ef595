"""Acoustic frontend: framing -> STFT -> log-Mel -> CMVN -> deltas.

Counterpart of ``gluon_e2e_asr_tpu/frontend/features.py`` (the
``impl: jnp`` path), with SpecAugment in training. The STFT is a framed matmul against a
DFT basis with the Hann window folded in, applied per hop-aligned
window segment, then power spectrum, mel matmul and log. Those are
plain large matmuls, left to ``torch.matmul`` as the JAX package leaves
them to XLA, and they must run in true f32: log-domain features amplify
the cancellation noise of reduced-precision products near the power
floor, so on a CUDA tensor TF32 matmuls must be off
(``torch.backends.cuda.matmul.allow_tf32 = False``).

SpecAugment's mask geometry is an input: ``draw_spec_augment`` draws the
four raw values from a ``torch.Generator``, and ``spec_augment`` applies
the JAX package's formulas to them, so a test can feed it the JAX draws.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import FrontendConfig


def num_frames(num_samples, win_length: int, hop_length: int):
    """Frame count under 'valid' framing (no centering). Works on ints and
    tensors. feat_len = 1 + floor((n - win) / hop), min 0."""
    if isinstance(num_samples, (int, np.integer)):
        return max(0, 1 + (int(num_samples) - win_length) // hop_length)
    n = torch.div(num_samples - win_length, hop_length,
                  rounding_mode="floor") + 1
    return torch.clamp(n, min=0)


@functools.lru_cache(maxsize=None)
def dft_basis(win_length: int, n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real-DFT basis restricted to the first ``win_length`` rows. Returns
    (cos, sin) with shape [win_length, n_fft//2 + 1], float32."""
    n_freq = n_fft // 2 + 1
    n = np.arange(win_length)[:, None]
    k = np.arange(n_freq)[None, :]
    ang = 2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), (-np.sin(ang)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def hann_window(win_length: int) -> np.ndarray:
    """Periodic Hann window (matches scipy.signal 'hann', sym=False)."""
    n = np.arange(win_length)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * n / win_length)).astype(np.float32)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(
    n_mels: int, n_fft: int, sample_rate: int, fmin: float, fmax: float
) -> np.ndarray:
    """HTK-style triangular mel filterbank, shape [n_freq, n_mels]."""
    n_freq = n_fft // 2 + 1
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bin_hz = np.arange(n_freq) * (sample_rate / n_fft)
    fb = np.zeros((n_freq, n_mels), np.float32)
    for m in range(n_mels):
        lo, ctr, hi = hz_pts[m], hz_pts[m + 1], hz_pts[m + 2]
        up = (bin_hz - lo) / max(ctr - lo, 1e-9)
        down = (hi - bin_hz) / max(hi - ctr, 1e-9)
        fb[:, m] = np.maximum(0.0, np.minimum(up, down))
    return fb


def frame_signal(audio: torch.Tensor, win_length: int,
                 hop_length: int) -> torch.Tensor:
    """[B, S] -> [B, F, win] overlapping frames."""
    F = num_frames(audio.shape[-1], win_length, hop_length)
    return audio.unfold(-1, win_length, hop_length)[..., :F, :]


def _f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if a.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "the frontend needs true f32 matmuls: set "
            "torch.backends.cuda.matmul.allow_tf32 = False")
    return torch.matmul(a, b)


def log_mel_spectrogram(audio: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """[B, S] -> [B, F, n_mels] log-mel features (no CMVN).

    The audio is reshaped into hop-sized rows and the windowed DFT basis
    is applied as one matmul per hop-aligned window segment, so no
    overlapping frames are materialized."""
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    cos_b, sin_b = dft_basis(cfg.win_length, cfg.n_fft)
    win = hann_window(cfg.win_length)
    mel = mel_filterbank(cfg.n_mels, cfg.n_fft, cfg.sample_rate, cfg.fmin,
                         float(fmax))
    B, S = audio.shape
    hop, winlen = cfg.hop_length, cfg.win_length
    F = num_frames(S, winlen, hop)
    basis = torch.from_numpy(np.concatenate(
        [cos_b * win[:, None], sin_b * win[:, None]], axis=1)).to(audio.device)
    n_hops = -(-winlen // hop)
    SP = (F + n_hops) * hop
    padded = torch.nn.functional.pad(audio, (0, max(0, SP - S)))
    rows = padded[:, :SP].reshape(B, -1, hop)
    out = None
    off = 0
    for k in range(n_hops):
        take = min(hop, winlen - off)
        piece = _f32_matmul(rows[:, k:k + F, :take], basis[off:off + take])
        out = piece if out is None else out + piece
        off += take
    n_freq = cos_b.shape[1]
    power = out[..., :n_freq] ** 2 + out[..., n_freq:] ** 2  # [B,F,n_freq]
    melspec = _f32_matmul(power, torch.from_numpy(mel).to(audio.device))
    return torch.log(torch.clamp(melspec, min=cfg.log_floor))


def _frame_mask(F: int, feat_len: torch.Tensor) -> torch.Tensor:
    return torch.arange(F, device=feat_len.device)[None, :] < feat_len[:, None]


def apply_cmvn(
    feats: torch.Tensor,
    feat_len: torch.Tensor,
    mode: str,
    stats: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
) -> torch.Tensor:
    """Cepstral mean/variance normalization: "utterance" (stats over each
    utterance's valid frames), "global" ((mean, std) of shape [n_mels]
    stored beside the checkpoint) or "none"."""
    if mode == "none":
        return feats
    if mode == "global":
        if stats is None:
            raise ValueError("global CMVN requires stats")
        mean, std = (torch.as_tensor(s, dtype=torch.float32,
                                     device=feats.device) for s in stats)
        return (feats - mean) / torch.clamp(std, min=1e-5)
    if mode != "utterance":
        raise ValueError(f"unknown cmvn mode {mode!r}")
    mask = _frame_mask(feats.shape[1], feat_len).to(feats.dtype)
    denom = torch.clamp(mask.sum(dim=1, keepdim=True), min=1.0)[..., None]
    mean = (feats * mask[..., None]).sum(dim=1, keepdim=True) / denom
    var = ((feats - mean) ** 2 * mask[..., None]).sum(dim=1, keepdim=True) / denom
    return (feats - mean) / torch.sqrt(var + 1e-10)


def add_deltas(feats: torch.Tensor, feat_len: torch.Tensor, order: int,
               window: int = 2) -> torch.Tensor:
    """Append Kaldi-style regression deltas: [B,F,M] -> [B,F,M*(1+order)],
    with indices clamped per utterance to its valid frames. Frames past
    ``feat_len`` stay zero."""
    if order <= 0:
        return feats
    B, F, M = feats.shape
    denom = 2.0 * sum(n * n for n in range(1, window + 1))
    t = torch.arange(F, device=feats.device)[None, :]
    hi = torch.clamp(feat_len[:, None].long() - 1, min=0)
    blocks = [feats]
    cur = feats
    for _ in range(order):
        acc = torch.zeros_like(cur)
        for n in range(1, window + 1):
            ip = torch.minimum(torch.clamp(t + n, min=0), hi)
            im = torch.minimum(torch.clamp(t - n, min=0), hi)
            acc = acc + n * (
                torch.gather(cur, 1, ip[..., None].expand(B, F, M))
                - torch.gather(cur, 1, im[..., None].expand(B, F, M)))
        cur = acc / denom
        blocks.append(cur)
    out = torch.cat(blocks, dim=-1)
    valid = _frame_mask(F, feat_len)[..., None]
    return torch.where(valid, out, torch.zeros_like(out))


class SpecAugDraws(NamedTuple):
    """The raw draws of SpecAugment, each [B, n_masks, 1] int64 (None
    where that kind of mask is off): mask widths in [0, width], frequency
    starts below max(n_mels - w + 1, 1), time starts in [0, F) before the
    per-utterance wrap."""
    freq_width: Optional[torch.Tensor]
    freq_start: Optional[torch.Tensor]
    time_width: Optional[torch.Tensor]
    time_start: Optional[torch.Tensor]


def specaug_on(cfg: FrontendConfig) -> bool:
    return cfg.specaug_freq_masks > 0 or cfg.specaug_time_masks > 0


def draw_spec_augment(cfg: FrontendConfig, batch: int, frames: int,
                      generator: torch.Generator,
                      device: torch.device = torch.device("cpu")
                      ) -> SpecAugDraws:
    """SpecAugment's raw draws for ``batch`` utterances of ``frames``
    frames, from ``generator`` (drawn on its device, moved to
    ``device``)."""
    def randint(high, n):
        return torch.randint(0, high, (batch, n, 1), generator=generator)

    fw = fs = tw = ts = None
    if cfg.specaug_freq_masks > 0 and cfg.specaug_freq_width > 0:
        fw = randint(cfg.specaug_freq_width + 1, cfg.specaug_freq_masks)
        span = torch.clamp(cfg.n_mels - fw + 1, min=1)
        u = torch.rand(fw.shape, generator=generator, dtype=torch.float64)
        fs = torch.minimum((u * span).long(), span - 1)
    if cfg.specaug_time_masks > 0 and cfg.specaug_time_width > 0:
        tw = randint(cfg.specaug_time_width + 1, cfg.specaug_time_masks)
        ts = randint(max(frames, 1), cfg.specaug_time_masks)
    return SpecAugDraws(*(None if d is None else d.to(device)
                          for d in (fw, fs, tw, ts)))


def spec_augment(feats: torch.Tensor, feat_len: torch.Tensor,
                 draws: SpecAugDraws, time_width: int) -> torch.Tensor:
    """SpecAugment time/frequency masking with the geometry in ``draws``:
    masked cells are zeroed (post-CMVN zero is the feature mean). Each
    time mask is capped at min(time_width, max(len // 5, 1)) and starts
    at ``time_start % max(len - w + 1, 1)``, as in the JAX package."""
    B, F, M = feats.shape
    if draws.freq_width is not None:
        fidx = torch.arange(M, device=feats.device)[None, None, :]
        hit = (fidx >= draws.freq_start) & (
            fidx < draws.freq_start + draws.freq_width)
        fmask = ~torch.any(hit, dim=1)  # [B,M]
        feats = feats * fmask[:, None, :].to(feats.dtype)
    if draws.time_width is not None:
        lens = feat_len.long()[:, None, None]
        max_w = torch.clamp(torch.clamp(lens // 5, min=1), max=time_width)
        w = torch.minimum(draws.time_width, max_w)
        span = torch.clamp(lens - w + 1, min=1)
        start = draws.time_start % span
        tidx = torch.arange(F, device=feats.device)[None, None, :]
        hit = (tidx >= start) & (tidx < start + w)
        tmask = ~torch.any(hit, dim=1)  # [B,F]
        feats = feats * tmask[:, :, None].to(feats.dtype)
    return feats


def compute_features(
    cfg: FrontendConfig,
    audio: torch.Tensor,
    audio_len: torch.Tensor,
    *,
    train: bool = False,
    spec_draws: Optional[SpecAugDraws] = None,
    cmvn_stats=None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B,S] audio -> ([B,F,n_mels], feat_len int32). In training with
    SpecAugment on, ``spec_draws`` gives the masks. Frames past
    ``feat_len`` are zeroed."""
    feats = log_mel_spectrogram(audio, cfg)
    feat_len = num_frames(audio_len, cfg.win_length,
                          cfg.hop_length).to(torch.int32)
    feats = apply_cmvn(feats, feat_len, cfg.cmvn, cmvn_stats)
    if train and specaug_on(cfg):
        if spec_draws is None:
            raise ValueError("SpecAugment in training needs spec_draws "
                             "(draw_spec_augment)")
        feats = spec_augment(feats, feat_len, spec_draws,
                             cfg.specaug_time_width)
    valid = _frame_mask(feats.shape[1], feat_len)[..., None]
    return torch.where(valid, feats, torch.zeros_like(feats)), feat_len


def frontend_apply(cfg: FrontendConfig, audio: torch.Tensor,
                   audio_len: torch.Tensor, *, train: bool = False,
                   spec_draws: Optional[SpecAugDraws] = None,
                   cmvn_stats=None):
    """Implementation-selecting wrapper: ``cfg.impl`` "jnp"
    (``compute_features``), "pallas" (K5) or "pallas_regrid" (K6; both in
    ``frontend/fused.py``). int16 audio (the loader's
    ``data.transfer_dtype: int16``) is dequantized by the exact
    power-of-two scale 2^-15 first, and deltas follow, for every impl.
    ``train`` applies SpecAugment with ``spec_draws``."""
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) * (2.0 ** -15)
    if cfg.impl in ("pallas", "pallas_regrid"):
        from gluon_e2e_asr_tpu_torch.frontend import fused

        fn = (fused.compute_features_pallas if cfg.impl == "pallas"
              else fused.compute_features_pallas_regrid)
    elif cfg.impl == "jnp":
        fn = compute_features
    else:
        raise ValueError(
            f"frontend.impl={cfg.impl!r} not in ('jnp', 'pallas', "
            "'pallas_regrid')")
    feats, feat_len = fn(cfg, audio.float(), audio_len, train=train,
                         spec_draws=spec_draws, cmvn_stats=cmvn_stats)
    if cfg.deltas > 0:
        feats = add_deltas(feats, feat_len, cfg.deltas, cfg.delta_window)
    return feats, feat_len
