"""K5 and K6 (the fused frontend, ``csrc/frontend.cu``) alone on one card.

Run from the root of a checkout on a machine with the card and nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.fe_probe

For each shape chip_smoke.py holds the frontend at (milestone 2's 2.0 s
and 4.0 s buckets at B=16, the flagship's 4.0 s bucket and bench.py's
12.8 s at B=96; bench.py's seeded audio, rows from half to all of the
bucket), utterance CMVN, eval, one JSON line: each wrapper's time as the
path calls it (CUDA events, median of 10 after a warm-up), the device
time of its CUDA kernels alone (torch.profiler, mean over 10 calls), the
plain version's time, and the largest difference from it.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import FrontendConfig
from gluon_e2e_asr_tpu_torch.frontend import fused

SHAPES = (("milestone2 2.0 s", 16, 2.0), ("milestone2 4.0 s", 16, 4.0),
          ("flagship 4.0 s", 96, 4.0), ("bench.py", 96, 12.8))
N = 10


def audio_batch(B: int, seconds: float, dev, seed: int = 0):
    """bench.py's batch: seeded noise, lengths from half to all."""
    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    audio = rng.randn(B, n).astype(np.float32) * 0.1
    lens = np.full((B,), n, np.int32)
    lens[1:] = rng.randint(n // 2, n + 1, size=B - 1)
    return torch.from_numpy(audio).to(dev), torch.from_numpy(lens).to(dev)


def event_ms(fn) -> float:
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


def device_ms(fn) -> float:
    """Device time of the frontend's own kernels per call."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(N):
            fn()
        torch.cuda.synchronize()
    us = 0.0
    for evt in prof.key_averages():
        if "spectral_kernel" in evt.key or "cmvn_kernel" in evt.key:
            us += getattr(evt, "self_device_time_total",
                          getattr(evt, "self_cuda_time_total", 0))
    return us / 1e3 / N


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("fe_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    cfg = FrontendConfig(cmvn="utterance")
    for name, B, sec in SHAPES:
        audio, lens = audio_batch(B, sec, dev)
        rec = {"shape": name, "B": B, "samples": int(audio.shape[1]),
               "card": card}
        ref = fused.compute_features_pallas_plain(cfg, audio, lens)[0]
        rec["plain_ms"] = event_ms(
            lambda: fused.compute_features_pallas_plain(cfg, audio, lens))
        for key, fn in (("k5", fused.compute_features_pallas_kernel),
                        ("k6", fused.compute_features_pallas_regrid_kernel)):
            got = fn(cfg, audio, lens)[0]
            torch.cuda.synchronize()
            rec[f"{key}_max_abs_err"] = float((got - ref).abs().max())
            rec[f"{key}_ms"] = event_ms(lambda: fn(cfg, audio, lens))
            rec[f"{key}_kernels_device_ms"] = device_ms(
                lambda: fn(cfg, audio, lens))
        print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
