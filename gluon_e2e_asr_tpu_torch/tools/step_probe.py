"""Train step time on the card, through the kernels.

One update of a config's model (fresh, from ``train.seed``, as the
trainer starts it; ``train.dp`` off) on bench.py's batch (``--shape
bench``: B = the config's batch size, 12.8 s, 96 labels) or on the first
batch of the config's longest bucket (``--shape bucket``), timed by CUDA
events around the step: the median of ``--iters`` after two warm-up
steps. It uses only the package's public training API, so that one chip
call can time two trees, each with its own copy of the package first on
the path::

    python -m gluon_e2e_asr_tpu_torch.tools.step_probe \\
        --config configs/milestone5_beam.yaml --shape bucket
    (cd <another tree> && PYTHONPATH=$PWD python3 \\
        <this tree>/gluon_e2e_asr_tpu_torch/tools/step_probe.py --config ...)

Prints one JSON line a config with the card's name and power limit;
``--profile`` adds torch.profiler's kernels by device time and host
operations by self CPU time over 3 steps.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.decode import make_eval_loader
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.training import train_step as TS
from gluon_e2e_asr_tpu_torch.training.trainer import (
    build_datasets, build_tokenizer)

BENCH_SEC, BENCH_LABELS = 12.8, 96  # bench.py's shape


def synth(B: int, seconds: float, max_labels: int, vocab: int, seed: int):
    """bench.py's seeded batch at (B, seconds, max_labels): noise audio,
    lengths from half to all of ``seconds``, labels 4..29 folded into
    the vocabulary."""
    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    audio = rng.randn(B, n).astype(np.float32) * 0.1
    audio_len = np.full((B,), n, np.int32)
    audio_len[1:] = rng.randint(n // 2, n + 1, size=B - 1)
    labels = rng.randint(4, 30, size=(B, max_labels)).astype(np.int32)
    label_len = rng.randint(max_labels // 2, max_labels + 1,
                            size=B).astype(np.int32)
    labels = labels * (np.arange(max_labels)[None] < label_len[:, None])
    labels = np.where(labels > 0, 4 + labels % (vocab - 4), 0)
    return audio, audio_len, labels.astype(np.int32), label_len


def batch_of(config, shape: str, seed: int = 0):
    """(the step's batch on the host, the tokenizer): bench.py's batch, or
    the first batch of the longest bucket (where the config's data fill
    none, as the location-aware flagship's do not, bench.py's batch at
    that bucket's shape: chip_smoke.py's ``bucket_batch``)."""
    train_utts, _ = build_datasets(config)
    tok = build_tokenizer(config, (u.text for u in train_utts))
    if shape == "bench":
        arrays = synth(config.data.batch_size, BENCH_SEC, BENCH_LABELS,
                       tok.vocab_size, seed)
    else:
        loader = make_eval_loader(config, train_utts, tok)
        last = len(loader.sampler.specs) - 1
        b = next((x for x in loader.epoch(0) if x.bucket == last), None)
        if b is None:
            spec = loader.sampler.specs[last]
            arrays = synth(spec.batch_size, config.data.bucket_bounds_sec[-1],
                           spec.max_labels, tok.vocab_size, seed)
        else:
            arrays = (b.audio, b.audio_len, b.labels, b.label_len)
    names = ("audio", "audio_len", "labels", "label_len")
    return {k: torch.from_numpy(np.asarray(a)) for k, a in zip(names, arrays)}, tok


def step_ms(config, shape: str, iters: int, dev, profile=False) -> dict:
    batch, tok = batch_of(config, shape)
    model = build_model(config, tok.vocab_size, train=True,
                        sos_id=tok.sos_id, eos_id=tok.eos_id)
    opt = TS.make_optimizer(config)
    state = TS.create_train_state(config, model, opt, dev)
    step = TS.make_train_step(model, config, opt)
    batch = {k: v.to(dev) for k, v in batch.items()}
    for _ in range(2):
        step(state, batch)
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        step(state, batch)
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    out = {"B": int(batch["audio"].shape[0]),
           "samples": int(batch["audio"].shape[1]),
           "step_ms": float(np.median(times)), "min_ms": float(min(times)),
           "max_ms": float(max(times)), "iters": iters}
    if profile:
        out["profile"] = step_profile(lambda: step(state, batch))
    return out


def step_profile(fn, steps: int = 3, top: int = 15) -> dict:
    """torch.profiler over ``steps`` steps: the host ms a step, the device
    ms a step, and the ``top`` kernels by device time and host operations
    by self CPU time (ms a step, calls a step)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / steps
    dev, host = [], []
    for e in prof.key_averages():
        d = getattr(e, "self_device_time_total", 0)
        if e.device_type == torch.autograd.DeviceType.CUDA and d > 0:
            dev.append((e.key[:90], d / 1e3 / steps, e.count // steps))
        elif e.self_cpu_time_total > 0:
            host.append((e.key[:90], e.self_cpu_time_total / 1e3 / steps,
                         e.count // steps))
    dev.sort(key=lambda r: -r[1])
    host.sort(key=lambda r: -r[1])
    return {"wall_ms": wall, "device_busy_ms": sum(r[1] for r in dev),
            "kernels": dev[:top], "host_ops": host[:top]}


def main(argv=None) -> list:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", action="append", required=True)
    p.add_argument("--shape", choices=("bench", "bucket"), default="bucket")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--set", action="append", default=[])
    p.add_argument("--profile", action="store_true",
                   help="also torch.profiler's device and host tables")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("step_probe needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    dev = torch.device("cuda", 0)
    out = []
    for path in args.config:
        config = load_config(path)
        apply_overrides(config, ["train.dp=false", *args.set])
        rec = {"config": path, "shape": args.shape,
               "compute_dtype": config.model.compute_dtype,
               **step_ms(config, args.shape, args.iters, dev, args.profile),
               "card": card}
        print(json.dumps(rec), flush=True)
        out.append(rec)
    return out


if __name__ == "__main__":
    main()
