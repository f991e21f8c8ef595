"""The fused frontend: K5 (``frontend.impl: pallas``) and K6
(``frontend.impl: pallas_regrid``).

Counterpart of ``gluon_e2e_asr_tpu/frontend/pallas_frontend.py``:
``compute_features_pallas`` and ``compute_features_pallas_regrid`` with
JAX's names and signatures, ``spec_draws`` (``features.SpecAugDraws``) in
place of ``rng``. Each has two versions:

- plain PyTorch (``*_plain``): ``features.py``'s log-mel, CMVN,
  SpecAugment and valid mask, the ``impl: jnp`` path's arithmetic (which
  is what the TPU kernels compute). The CPU path, and the references the
  kernels are held against on the card.
- hand-written Hopper kernels (``*_kernel``, ``csrc/frontend.cu``): K5
  runs the spectral stage with the epilogue fused for cmvn global/none
  and a second kernel for utterance CMVN; K6 runs the spectral stage and,
  for utterance CMVN, finishes in torch as the TPU wrapper finishes in
  XLA.

``_route`` dispatches on the audio's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor, and nothing else; no path falls
back from a kernel to a plain version.

SpecAugment is an input. The TPU kernels draw their mask geometry from
the TPU's in-kernel generator (and K5's start formulas there differ from
the jnp path's); that stream exists on no other device. Here both
versions apply ``features.spec_augment``'s formulas to the trainer's
draws, so with the same draws ``impl: pallas``, ``pallas_regrid`` and
``jnp`` give the same features, as the JAX package's interpret-mode
paths do on the CPU.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.config import FrontendConfig
from gluon_e2e_asr_tpu_torch.frontend.features import (
    SpecAugDraws, _frame_mask, apply_cmvn, compute_features, dft_basis,
    hann_window, mel_filterbank, num_frames, spec_augment, specaug_on)

_CMVN = {"none": 0, "global": 1, "utterance": 2}
MAX_MELS = 128  # 16 mel lanes x 8 mels a thread in the spectral kernel


def _frames(cfg: FrontendConfig, audio: torch.Tensor) -> int:
    """The frame count of a bucket; raises where the JAX wrappers assert."""
    if cfg.win_length > 3 * cfg.hop_length:
        raise ValueError("kernel framing assumes win <= 3*hop "
                         f"(win {cfg.win_length}, hop {cfg.hop_length})")
    if audio.dim() != 2:
        raise ValueError(f"audio must be [B,S], got {tuple(audio.shape)}")
    F = num_frames(int(audio.shape[1]), cfg.win_length, cfg.hop_length)
    if F <= 0:
        raise ValueError(f"bucket of {audio.shape[1]} samples is shorter "
                         f"than one window ({cfg.win_length})")
    return F


def _plain(cfg, audio, audio_len, train, spec_draws, cmvn_stats):
    _frames(cfg, audio)
    return compute_features(cfg, audio, audio_len, train=train,
                            spec_draws=spec_draws, cmvn_stats=cmvn_stats)


def compute_features_pallas_plain(cfg, audio, audio_len, *, train=False,
                                  spec_draws=None, cmvn_stats=None):
    """K5's plain version: [B,S] audio -> ([B,F,n_mels], feat_len int32)."""
    compute_features_pallas_plain.calls += 1
    return _plain(cfg, audio, audio_len, train, spec_draws, cmvn_stats)


compute_features_pallas_plain.calls = 0


def compute_features_pallas_regrid_plain(cfg, audio, audio_len, *,
                                         train=False, spec_draws=None,
                                         cmvn_stats=None):
    """K6's plain version: the same function as K5's."""
    compute_features_pallas_regrid_plain.calls += 1
    return _plain(cfg, audio, audio_len, train, spec_draws, cmvn_stats)


compute_features_pallas_regrid_plain.calls = 0


@functools.lru_cache(maxsize=None)
def _constants(key, device: torch.device):
    """(basis [win, ld] with frequency k's windowed (cos, sin) at columns
    2k, 2k+1 and ld a multiple of 4; mel [n_freq, n_mels]) on ``device``."""
    win, n_fft, n_mels, sr, fmin, fmax = key
    cos_b, sin_b = dft_basis(win, n_fft)
    w = hann_window(win)[:, None]
    n_freq = cos_b.shape[1]
    ld = -(-2 * n_freq // 4) * 4
    basis = np.zeros((win, ld), np.float32)
    basis[:, 0:2 * n_freq:2] = w * cos_b
    basis[:, 1:2 * n_freq:2] = w * sin_b
    mel = mel_filterbank(n_mels, n_fft, sr, fmin, fmax)
    return (torch.from_numpy(basis).to(device),
            torch.from_numpy(np.ascontiguousarray(mel)).to(device))


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("frontend")
    if lib.frontend_error_string.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        P, I = ctypes.c_void_p, ctypes.c_int
        args = [P, P, P, P, I, P, P, P, P, P, I, P, P, I, I, P, I, I, I, I,
                I, I, I, ctypes.c_float, I, P]
        for fn in (lib.frontend_k5, lib.frontend_k6):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.frontend_error_string.argtypes = [ctypes.c_int]
        lib.frontend_error_string.restype = ctypes.c_char_p
    return lib


def _draws(d: Optional[torch.Tensor], B: int, dev) -> Optional[torch.Tensor]:
    """A [B, n, 1] draw as int32 [B, n] on ``dev``."""
    if d is None:
        return None
    if d.device != dev or d.shape[0] != B:
        raise ValueError(f"SpecAugment draws must be [B={B}, n, 1] on {dev}, "
                         f"got {tuple(d.shape)} on {d.device}")
    return d.reshape(B, -1).to(torch.int32).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(entry: str, cfg: FrontendConfig, audio, audio_len, train,
            spec_draws, cmvn_stats):
    """Launch ``frontend_k5`` or ``frontend_k6`` on ``audio``'s device.
    Returns (feats [B,F,M] f32, feat_len int32, which the kernel computes
    from audio_len): finished for cmvn global/none and, with K5,
    utterance; raw log-mel (0 past feat_len) for K6 with utterance
    CMVN."""
    if audio.device.type != "cuda":
        raise ValueError(f"{entry} needs a CUDA tensor, got {audio.device}")
    if audio.dtype != torch.float32 or not audio.is_contiguous():
        raise ValueError(f"audio must be contiguous float32, got {audio.dtype}")
    if cfg.cmvn not in _CMVN:
        raise ValueError(f"unknown cmvn mode {cfg.cmvn!r}")
    if not 0 < cfg.n_mels <= MAX_MELS:
        raise ValueError(f"n_mels {cfg.n_mels} outside the kernel's "
                         f"1..{MAX_MELS}")
    F = _frames(cfg, audio)
    dev = audio.device
    B, S = audio.shape
    if tuple(audio_len.shape) != (B,) or audio_len.device != dev:
        raise ValueError(f"audio_len must be [{B}] on {dev}, got "
                         f"{tuple(audio_len.shape)} on {audio_len.device}")
    if cfg.hop_length % 4:
        raise ValueError(f"the kernel reads 4 samples at a time: hop_length "
                         f"{cfg.hop_length} must be a multiple of 4")
    audio_len = audio_len.to(torch.int32).contiguous()
    feat_len = torch.empty(B, device=dev, dtype=torch.int32)  # the kernel's
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    basis, mel = _constants((cfg.win_length, cfg.n_fft, cfg.n_mels,
                             cfg.sample_rate, float(cfg.fmin), float(fmax)),
                            dev)
    mean = std = None
    if cfg.cmvn == "global":
        if cmvn_stats is None:
            raise ValueError("global CMVN requires stats")
        mean, std = (torch.as_tensor(s, dtype=torch.float32, device=dev)
                     .reshape(cfg.n_mels).contiguous() for s in cmvn_stats)
    fw = fs = tw = ts = None
    if train and specaug_on(cfg):
        if spec_draws is None:
            raise ValueError("SpecAugment in training needs spec_draws "
                             "(draw_spec_augment)")
        fw, fs, tw, ts = (_draws(d, B, dev) for d in spec_draws)
    out = torch.empty(B, F, cfg.n_mels, device=dev, dtype=torch.float32)
    if B:
        lib = _lib()
        with torch.cuda.device(dev):
            rc = getattr(lib, entry)(
                audio.data_ptr(), audio_len.data_ptr(), feat_len.data_ptr(),
                basis.data_ptr(),
                basis.shape[1], mel.data_ptr(), _ptr(mean), _ptr(std),
                _ptr(fw), _ptr(fs), 0 if fw is None else fw.shape[1],
                _ptr(tw), _ptr(ts), 0 if tw is None else tw.shape[1],
                cfg.specaug_time_width, out.data_ptr(), B, S, F,
                cfg.win_length, cfg.hop_length, mel.shape[0],
                cfg.n_mels, cfg.log_floor, _CMVN[cfg.cmvn],
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{entry} launch failed: "
                f"{lib.frontend_error_string(rc).decode()} "
                f"(B={B} S={S} F={F} cmvn={cfg.cmvn})")
    return out, feat_len


def compute_features_pallas_kernel(cfg, audio, audio_len, *, train=False,
                                   spec_draws=None, cmvn_stats=None):
    """K5 on the card: contiguous f32 audio [B,S] on a CUDA device."""
    out = _launch("frontend_k5", cfg, audio, audio_len, train, spec_draws,
                  cmvn_stats)
    compute_features_pallas_kernel.launches += 1
    return out


compute_features_pallas_kernel.launches = 0


def compute_features_pallas_regrid_kernel(cfg, audio, audio_len, *,
                                          train=False, spec_draws=None,
                                          cmvn_stats=None):
    """K6 on the card; utterance CMVN, SpecAugment and the valid mask then
    run in torch (pallas_frontend.py:399-412)."""
    feats, feat_len = _launch("frontend_k6", cfg, audio, audio_len, train,
                              spec_draws, cmvn_stats)
    compute_features_pallas_regrid_kernel.launches += 1
    if cfg.cmvn != "utterance":
        return feats, feat_len
    feats = apply_cmvn(feats, feat_len, cfg.cmvn, cmvn_stats)
    if train and specaug_on(cfg):
        feats = spec_augment(feats, feat_len, spec_draws,
                             cfg.specaug_time_width)
    valid = _frame_mask(feats.shape[1], feat_len)[..., None]
    return torch.where(valid, feats, torch.zeros_like(feats)), feat_len


compute_features_pallas_regrid_kernel.launches = 0


def _route(audio: torch.Tensor) -> str:
    """"plain" for a CPU tensor, "kernel" for a CUDA tensor."""
    if audio.device.type == "cpu":
        return "plain"
    if audio.device.type == "cuda":
        return "kernel"
    raise ValueError(f"fused frontend: no implementation for device "
                     f"{audio.device}")


def compute_features_pallas(cfg: FrontendConfig, audio: torch.Tensor,
                            audio_len: torch.Tensor, *, train: bool = False,
                            spec_draws: Optional[SpecAugDraws] = None,
                            cmvn_stats=None):
    """``frontend.impl: pallas``: [B,S] audio -> ([B,F,n_mels], feat_len
    int32), frames past feat_len 0; SpecAugment from ``spec_draws`` in
    training."""
    fn = (compute_features_pallas_plain if _route(audio) == "plain"
          else compute_features_pallas_kernel)
    return fn(cfg, audio, audio_len, train=train, spec_draws=spec_draws,
              cmvn_stats=cmvn_stats)


def compute_features_pallas_regrid(cfg: FrontendConfig, audio: torch.Tensor,
                                   audio_len: torch.Tensor, *,
                                   train: bool = False,
                                   spec_draws: Optional[SpecAugDraws] = None,
                                   cmvn_stats=None):
    """``frontend.impl: pallas_regrid``: as ``compute_features_pallas``."""
    fn = (compute_features_pallas_regrid_plain if _route(audio) == "plain"
          else compute_features_pallas_regrid_kernel)
    return fn(cfg, audio, audio_len, train=train, spec_draws=spec_draws,
              cmvn_stats=cmvn_stats)
