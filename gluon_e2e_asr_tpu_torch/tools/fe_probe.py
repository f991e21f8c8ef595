"""K5 and K6 (the fused frontend, ``csrc/frontend.cu``) alone on one card:
the FFT design beside the first design in one process.

Run from the root of a checkout on a machine with the card and nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.fe_probe [--ablate] [--phases]
        [--only old]

For each shape chip_smoke.py holds the frontend at (milestone 2's 2.0 s
and 4.0 s buckets at B=16, the flagship's 4.0 s bucket and bench.py's
12.8 s at B=96; bench.py's seeded audio, rows from half to all of the
bucket), utterance CMVN, eval, one JSON line: for K5 and K6 and each
design, in turns (old, new, new, old), the time of a call as the path
makes it (CUDA events, median of 10 after a warm-up, the wrapper's host
work included), the device time of its CUDA kernels alone (torch.profiler,
mean over 10 calls), the host time a call takes to return and the
kernels one call launches; the plain
version's time; each design's largest difference from the plain
version. The first design is the build variant ``FE_FFT 0`` (the DFT
product, ``spectral_kernel``, with ``cmvn_kernel`` for K5 and torch for
K6's utterance CMVN) driven through a copy of its wrapper. ``--only old``
times the first design alone.

``--ablate`` also times the FFT design's K5 built with one piece cut
(each such build computes wrong features; only its device time counts):
the mel product and the log (``FE_MEL 0``: the FFT only), the utterance
CMVN reduction across the cluster (``FE_REDUCE 0``) and the features'
stores (``FE_STORES 0``). ``--phases`` builds the variant that counts
SM cycles by phase (``FE_TIMING 1``: thread 0 of every CTA, summed over
the CTAs of one K5 call) and gives each phase's cycles a CTA and share.

``audio_batch`` and ``hard_audio`` make the seeded batches the card tests
and ``chip_smoke.py`` use too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import time

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.config import FrontendConfig
from gluon_e2e_asr_tpu_torch.frontend import fused
from gluon_e2e_asr_tpu_torch.frontend.features import _frame_mask, apply_cmvn
from gluon_e2e_asr_tpu_torch.tools.ctc_probe import _device_events, one_call

SHAPES = (("milestone2 2.0 s", 16, 2.0), ("milestone2 4.0 s", 16, 4.0),
          ("flagship 4.0 s", 96, 4.0), ("bench.py", 96, 12.8))
N = 10
# name -> (text of csrc/frontend.cu, its replacement): the build variants
OLD_DESIGN = ("#define FE_FFT 1", "#define FE_FFT 0")
CUTS = {"fft only": ("#define FE_MEL 1", "#define FE_MEL 0"),
        "no cmvn reduction": ("#define FE_REDUCE 1", "#define FE_REDUCE 0"),
        "no stores": ("#define FE_STORES 1", "#define FE_STORES 0")}
TIMING = ("#define FE_TIMING 0", "#define FE_TIMING 1")
# fft_kernel's phases, in the order FE_TIMING counts them (FftPhase)
PHASES = ("stage", "fft", "mel and log", "frames wait", "cmvn mean",
          "cmvn deviations", "cmvn std", "stores", "exit")
# the kernels of both designs, as torch.profiler names them
KERNELS = ("fft_kernel", "spectral_kernel", "cmvn_kernel")


def audio_batch(B: int, seconds: float, dev, seed: int = 0):
    """bench.py's batch: seeded noise, lengths from half to all."""
    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    audio = rng.randn(B, n).astype(np.float32) * 0.1
    lens = np.full((B,), n, np.int32)
    lens[1:] = rng.randint(n // 2, n + 1, size=B - 1)
    return torch.from_numpy(audio).to(dev), torch.from_numpy(lens).to(dev)


def hard_audio(B: int, S: int, seed: int = 0):
    """Tones with digital silence and a -60 dB stretch, which put cells at
    the power floor (bench.py's noise never does), as numpy: row b is a
    tone of 200 + 170 b Hz plus a little noise (the JAX suite's frontend
    batch, tests/test_pallas_frontend.py), with its second quarter zero
    and its third at -60 dB; lengths from half to all of S."""
    rng = np.random.RandomState(seed)
    t = np.arange(S) / 16000.0
    q = S // 4
    audio = np.zeros((B, S), np.float32)
    for b in range(B):
        x = 0.5 * np.sin(2 * np.pi * (200 + 170 * b) * t) + 0.01 * rng.randn(S)
        x[q:2 * q] = 0.0
        x[2 * q:3 * q] *= 1e-3
        audio[b] = x
    lens = np.full((B,), S, np.int32)
    lens[1:] = rng.randint(S // 2, S + 1, size=B - 1)
    return audio, lens


def fft_work(cfg, shape, audio_len):
    """(operations, bytes) that the FFT route needs for [B, S] audio of
    these row lengths: for each live frame the complex FFT of n_fft/2
    points (5 N2 log2 N2), the real split and the power (13 a bin, N2 + 1
    bins), the band mel product (2 a nonzero weight) and the window (win);
    against the live frames' audio in (each sample once), the features
    [B, F, M] out, the tables and the lengths."""
    B, S = shape
    win, hop, n_fft, M = cfg.win_length, cfg.hop_length, cfg.n_fft, cfg.n_mels
    F = max(0, 1 + (S - win) // hop)
    live = np.minimum(np.maximum(0, 1 + (np.asarray(audio_len) - win) // hop), F)
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    _, bands, _ = fused.fft_tables((win, n_fft, M, cfg.sample_rate,
                                    float(cfg.fmin), float(fmax)))
    nnz = int(bands[:, 1].sum())
    N2 = n_fft // 2
    per_frame = 5 * N2 * np.log2(N2) + 13 * (N2 + 1) + 2 * nnz + win
    samples = float(np.where(live > 0, (live - 1) * hop + win, 0).sum())
    nbytes = 4 * (samples + B * F * M + 3 * n_fft + 3 * M + nnz + 2 * B)
    return float(live.sum()) * per_frame, nbytes


def old_call(lib, entry, cfg, audio, audio_len):
    """K5 or K6 (eval) through the first design's wrapper (``FE_FFT 0``):
    the spectral stage, and for K6's utterance CMVN, CMVN and the valid
    mask in torch."""
    B, S = audio.shape
    F = fused._frames(cfg, audio)
    fmax = cfg.fmax if cfg.fmax is not None else cfg.sample_rate / 2.0
    basis, mel = fused._constants((cfg.win_length, cfg.n_fft, cfg.n_mels,
                                   cfg.sample_rate, float(cfg.fmin),
                                   float(fmax)), audio.device)
    feat_len = torch.empty(B, device=audio.device, dtype=torch.int32)
    out = torch.empty(B, F, cfg.n_mels, device=audio.device)
    alen = audio_len.to(torch.int32).contiguous()
    rc = getattr(lib, entry)(
        audio.data_ptr(), alen.data_ptr(), feat_len.data_ptr(),
        basis.data_ptr(), basis.shape[1], mel.data_ptr(), None, None,
        None, None, 0, None, None, 0, cfg.specaug_time_width,
        out.data_ptr(), B, S, F, cfg.win_length, cfg.hop_length, mel.shape[0],
        cfg.n_mels, cfg.log_floor, fused._CMVN[cfg.cmvn],
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first design's {entry} failed: {rc}")
    if entry == "frontend_k5" or cfg.cmvn != "utterance":
        return out, feat_len
    feats = apply_cmvn(out, feat_len, cfg.cmvn)
    valid = _frame_mask(F, feat_len)[..., None]
    return torch.where(valid, feats, torch.zeros_like(feats)), feat_len


def build_variants(out_dir: str, variants):
    """name -> the library of csrc/frontend.cu with that variant's (text,
    replacement), one nvcc each, all started together; the first
    design's entries with their argtypes."""
    libs = _build.build_variants("frontend", out_dir, variants)
    for name, lib in libs.items():
        if variants[name] == OLD_DESIGN:
            P, I = ctypes.c_void_p, ctypes.c_int
            for fn in (lib.frontend_k5, lib.frontend_k6):
                fn.argtypes = [P, P, P, P, I, P, P, P, P, P, I, P, P, I, I, P,
                               I, I, I, I, I, I, I, ctypes.c_float, I, P]
                fn.restype = I
    return libs


@contextlib.contextmanager
def variant(lib):
    """The port's wrappers on ``lib`` (a cut of the FFT design, whose
    entries take the same arguments) in place of the frontend library."""
    saved = _build._libs["frontend"]
    for fn in (lib.frontend_k5, lib.frontend_k6):
        fn.argtypes = saved.frontend_k5.argtypes
        fn.restype = ctypes.c_int
    lib.frontend_error_string.argtypes = [ctypes.c_int]
    lib.frontend_error_string.restype = ctypes.c_char_p
    _build._libs["frontend"] = lib
    try:
        yield
    finally:
        _build._libs["frontend"] = saved


def event_ms(fn) -> float:
    """Median time of a call by CUDA events, after a warm-up."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(N):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


def device_ms(fn, keys=KERNELS) -> float:
    """Device time per call of fn's kernels whose names hold one of
    ``keys`` (torch.profiler, N calls after a warm-up): each such kernel's
    mean over the launches the trace holds (a long-lived process's trace
    may miss a few), summed; each of them launches once a call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # a trace that holds none of them is taken again
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(N):
                fn()
            torch.cuda.synchronize()
        found = [u / c for k, u, c in _device_events(prof)
                 if any(x in k for x in keys)]
        if found:
            return sum(found) / 1e3
    raise RuntimeError(f"three traces held none of the kernels {keys}")


def host_ms(fn) -> float:
    """Host time a call takes to return (no synchronisation inside), the
    mean of N after a warm-up: the wrapper's own work."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(N):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / N


def phases(lib, fn):
    """fft_kernel's cycles by phase in one call of fn through ``lib`` (the
    ``FE_TIMING 1`` build): each phase's mean cycles a CTA and its share,
    and the CTAs counted."""
    read = lib.frontend_phase_cycles
    read.argtypes = [ctypes.c_void_p]
    read.restype = ctypes.c_int
    out = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    with variant(lib):
        fn()
        torch.cuda.synchronize()
        read(out)  # clear
        fn()
        torch.cuda.synchronize()
    if read(out) != 0:
        raise RuntimeError("reading the phase cycles failed")
    cycles, ctas = list(out)[:-1], out[len(PHASES)]
    total = sum(cycles)
    return {"ctas": ctas, **{name: {"cycles_a_cta": c / ctas,
                                    "share": c / total}
                             for name, c in zip(PHASES, cycles)}}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--phases", action="store_true")
    p.add_argument("--only", choices=("old",))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("fe_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    variants = {"old design": OLD_DESIGN}
    if args.only is None:
        _build.load_library("frontend")
        fused._lib()
        if args.ablate:
            variants.update(CUTS)
        if args.phases:
            variants["phases"] = TIMING
    libs = build_variants(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                       "fe_probe"), variants)
    old = libs["old design"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": card}), flush=True)
    cfg = FrontendConfig(cmvn="utterance")
    for name, B, sec in SHAPES:
        audio, lens = audio_batch(B, sec, dev)
        F = fused._frames(cfg, audio)
        ops, nbytes = fft_work(cfg, tuple(audio.shape), lens.cpu().numpy())
        rec = {"shape": name, "B": B, "samples": int(audio.shape[1]), "F": F,
               "cmvn": cfg.cmvn, "plan": fused.fft_plan(
                   F, cfg.win_length, cfg.hop_length, cfg.n_fft, cfg.n_mels),
               "fft_operations": ops, "fft_bytes": nbytes, "card": card}
        ref = fused.compute_features_pallas_plain(cfg, audio, lens)[0]
        rec["plain_ms"] = event_ms(
            lambda: fused.compute_features_pallas_plain(cfg, audio, lens))
        for key, entry, fn in (
                ("k5", "frontend_k5", fused.compute_features_pallas_kernel),
                ("k6", "frontend_k6",
                 fused.compute_features_pallas_regrid_kernel)):
            designs = {"old": lambda e=entry: old_call(old, e, cfg, audio, lens)}
            if args.only is None:
                designs["new"] = lambda f=fn: f(cfg, audio, lens)
            for design, call in designs.items():
                got = call()[0]
                torch.cuda.synchronize()
                rec[f"{key}_{design}"] = {
                    "max_abs_err": float((got - ref).abs().max()),
                    "event_ms": event_ms(call), "device_ms": device_ms(call),
                    "host_ms": host_ms(call), "one_call": one_call(call)}
            if args.only is None:
                # the turns: old, new, new, old
                rec[f"{key}_new_again_event_ms"] = event_ms(designs["new"])
                rec[f"{key}_new_again_device_ms"] = device_ms(designs["new"])
                rec[f"{key}_old_again_event_ms"] = event_ms(designs["old"])
                rec[f"{key}_old_again_device_ms"] = device_ms(designs["old"])
        k5 = lambda: fused.compute_features_pallas_kernel(cfg, audio, lens)  # noqa: E731
        for cut in (CUTS if args.ablate else ()):
            with variant(libs[cut]):
                rec.setdefault("k5_cut_device_ms", {})[cut] = device_ms(k5)
        if args.phases:
            rec["k5_phases"] = phases(libs["phases"], k5)
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
