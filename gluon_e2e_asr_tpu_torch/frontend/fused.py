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
- hand-written Hopper kernels (``*_kernel``, ``csrc/frontend.cu``). K5
  and K6 compute the same function, and on the card one kernel serves
  both, chosen by shape alone (``fft_plan``, the mirror of the source's
  ``fe_fft_plan``): ``fft_kernel`` (a cluster of 8 CTAs an utterance, a
  real FFT a warp per frame, the mel product over each filter's band,
  utterance CMVN through distributed shared memory: one launch a call)
  where n_fft is a power of two in its range and the plan fits a block's
  shared memory (every config of the repo), else ``spectral_kernel``
  (the DFT product; with ``cmvn_kernel`` for utterance CMVN).

``_route`` dispatches on the audio's device: the plain version for a CPU
tensor, the kernel for a CUDA tensor, and nothing else; no path falls
back from a kernel to a plain version, nor from one kernel to the
other.

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
    SpecAugDraws, compute_features, dft_basis, hann_window, mel_filterbank,
    num_frames, specaug_on)

_CMVN = {"none": 0, "global": 1, "utterance": 2}
MAX_MELS = 128  # 16 mel lanes x 8 mels a thread in the spectral kernel
# csrc/frontend.cu's FFT route: CTAs an utterance, warps a CTA, frames a
# staged chunk, the n_fft range, a block's dynamic shared memory
CLUSTER, WARPS, CHUNK = 8, 16, 64
MIN_FFT, MAX_FFT = 128, 2048
MAX_SMEM = 232448
ROUTES = {"spectral": 0, "fft": 1}


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


@functools.lru_cache(maxsize=None)
def fft_tables(key):
    """The FFT route's constants, as numpy: consts [3 n_fft] f32 (the
    twiddles W^k = (cos, -sin)(2 pi k / n_fft), k < n_fft, computed in
    f64 with the values within 1e-12 of 0 made exactly 0, then the Hann
    window, zero past win), bands [M, 3] int32 and weights f32. Mel m's
    run is ``bands[m]`` = (first bin, bins, offset in weights), each a
    multiple of 4: the bins from its first nonzero weight rounded down to
    a multiple of 4, in whole groups of 4, to its last; its weights the
    filterbank's column on those bins (its nonzeros at their bins, zeros
    elsewhere, zeros past n_fft/2), which the kernel sums in bin order
    (a zero weight adds exactly nothing). A mel with no nonzero weight
    has no bins. weights holds at least 4 values."""
    win, n_fft, n_mels, sr, fmin, fmax = key
    ang = 2.0 * np.pi * np.arange(n_fft) / n_fft
    tw = np.stack([np.cos(ang), -np.sin(ang)], 1)
    tw[np.abs(tw) < 1e-12] = 0.0
    window = np.zeros(n_fft, np.float32)
    window[:win] = hann_window(win)
    consts = np.concatenate([tw.astype(np.float32).ravel(), window])
    fb = mel_filterbank(n_mels, n_fft, sr, fmin, fmax)
    padded = np.concatenate([fb, np.zeros((4, n_mels), np.float32)])
    bands = np.zeros((n_mels, 3), np.int32)
    runs = []
    for m in range(n_mels):
        nz = np.flatnonzero(fb[:, m])
        bands[m, 2] = sum(len(r) for r in runs)
        if len(nz):
            first = nz[0] // 4 * 4
            bins = -(-(nz[-1] + 1 - first) // 4) * 4
            bands[m, :2] = first, bins
            runs.append(padded[first:first + bins, m])
    weights = np.concatenate(runs) if runs else np.zeros(4, np.float32)
    return consts, bands, weights.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _fft_constants(key, device: torch.device):
    """``fft_tables`` on ``device``."""
    return tuple(torch.from_numpy(t).to(device) for t in fft_tables(key))


def _r4(n: int) -> int:
    return (n + 3) & ~3


def fft_plan(F: int, win: int, hop: int, n_fft: int, M: int):
    """(route, P, Q, smem): how ``csrc/frontend.cu::fe_fft_plan`` covers
    [B, F] frames, by shape alone: "fft" (``fft_kernel``) where n_fft is
    a power of two in [MIN_FFT, MAX_FFT], win <= n_fft, M <= MAX_MELS and
    the shared memory fits a block, else "spectral"; P frames a CTA at
    most (ceil(F / CLUSTER)); Q frames a staged chunk; the FFT kernel's
    shared memory in bytes (twiddles 2 n_fft, window n_fft, a slice of
    9 n_fft / 8 a warp, the CMVN sums 2 CLUSTER MAX_MELS + 32 WARPS, the
    log-mel P M and the chunk's audio (Q - 1) hop + n_fft floats, each
    rounded up to 4)."""
    P = -(-F // CLUSTER)
    Q = min(P, CHUNK)
    smem = 4 * (3 * n_fft + WARPS * (9 * n_fft // 8) + 2 * CLUSTER * MAX_MELS
                + 32 * WARPS + _r4(P * M) + _r4((Q - 1) * hop + n_fft))
    shape = (MIN_FFT <= n_fft <= MAX_FFT and n_fft & (n_fft - 1) == 0
             and win <= n_fft and M <= MAX_MELS)
    return ("fft" if shape and smem <= MAX_SMEM else "spectral"), P, Q, smem


def route(cfg: FrontendConfig, F: int) -> str:
    """The kernel a CUDA call of F frames takes: "fft" or "spectral"."""
    return fft_plan(F, cfg.win_length, cfg.hop_length, cfg.n_fft,
                    cfg.n_mels)[0]


def _lib() -> ctypes.CDLL:
    lib = _build.load_library("frontend")
    if lib.frontend_error_string.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        P, I = ctypes.c_void_p, ctypes.c_int
        args = [P, P, P, I, P, I, P, P, P, P, P, P, P, P, I, P, P, I, I, P,
                I, I, I, I, I, I, I, ctypes.c_float, I, P]
        for fn in (lib.frontend_k5, lib.frontend_k6):
            fn.argtypes = args
            fn.restype = ctypes.c_int
        lib.frontend_plan.argtypes = [I] * 5 + [P]
        lib.frontend_plan.restype = I
        lib.frontend_error_string.argtypes = [ctypes.c_int]
        lib.frontend_error_string.restype = ctypes.c_char_p
    return lib


def _draws(d: Optional[torch.Tensor], B: int, dev) -> Optional[torch.Tensor]:
    """A [B, n, 1] draw as int64 [B, n] on ``dev`` (draw_spec_augment's
    tensors as they are: a view, no copy)."""
    if d is None:
        return None
    if d.device != dev or d.shape[0] != B:
        raise ValueError(f"SpecAugment draws must be [B={B}, n, 1] on {dev}, "
                         f"got {tuple(d.shape)} on {d.device}")
    return d.reshape(B, -1).to(torch.int64).contiguous()


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch(fn, entry: str, cfg: FrontendConfig, audio, audio_len, train,
            spec_draws, cmvn_stats):
    """Launch ``frontend_k5`` or ``frontend_k6`` on ``audio``'s device,
    counting the call on ``fn`` (``.launches``; ``.fft_launches`` where
    it took ``fft_kernel``). Returns (feats [B,F,M] f32, finished, and
    feat_len int32, which the kernel computes from audio_len)."""
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
    key = (cfg.win_length, cfg.n_fft, cfg.n_mels, cfg.sample_rate,
           float(cfg.fmin), float(fmax))
    kind = route(cfg, F)
    basis = mel = consts = bands = weights = None
    if kind == "fft":
        consts, bands, weights = _fft_constants(key, dev)
    else:
        basis, mel = _constants(key, dev)
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
                ROUTES[kind], _ptr(basis),
                0 if basis is None else basis.shape[1], _ptr(mel),
                _ptr(consts), _ptr(bands), _ptr(weights),
                _ptr(mean), _ptr(std),
                _ptr(fw), _ptr(fs), 0 if fw is None else fw.shape[1],
                _ptr(tw), _ptr(ts), 0 if tw is None else tw.shape[1],
                cfg.specaug_time_width, out.data_ptr(), B, S, F,
                cfg.win_length, cfg.hop_length, cfg.n_fft,
                cfg.n_mels, cfg.log_floor, _CMVN[cfg.cmvn],
                torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(
                f"{entry} launch failed: "
                f"{lib.frontend_error_string(rc).decode()} "
                f"(B={B} S={S} F={F} n_fft={cfg.n_fft} route {kind} "
                f"cmvn={cfg.cmvn})")
        fn.launches += 1
        fn.fft_launches += kind == "fft"
    return out, feat_len


def compute_features_pallas_kernel(cfg, audio, audio_len, *, train=False,
                                   spec_draws=None, cmvn_stats=None):
    """K5 on the card: contiguous f32 audio [B,S] on a CUDA device."""
    return _launch(compute_features_pallas_kernel, "frontend_k5", cfg, audio,
                   audio_len, train, spec_draws, cmvn_stats)


compute_features_pallas_kernel.launches = 0
compute_features_pallas_kernel.fft_launches = 0


def compute_features_pallas_regrid_kernel(cfg, audio, audio_len, *,
                                          train=False, spec_draws=None,
                                          cmvn_stats=None):
    """K6 on the card: the same kernels as K5's (the TPU kernels differ
    only in their tiling)."""
    return _launch(compute_features_pallas_regrid_kernel, "frontend_k6", cfg,
                   audio, audio_len, train, spec_draws, cmvn_stats)


compute_features_pallas_regrid_kernel.launches = 0
compute_features_pallas_regrid_kernel.fft_launches = 0


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
