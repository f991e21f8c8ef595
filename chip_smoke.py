#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``nvidia-smi``; it imports no JAX. Phases,
each printing JSON lines:

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA library of the port's paths (``bilstm_fwd``,
   ``bilstm_bwd``, ``ctc``) from ``csrc/``, one nvcc each, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card,
   within stated tolerances, at the shapes the flagship model
   (``configs/english_flagship.yaml``, the 4.0 s bucket, B=96) gives it:
   K1-fwd in f32 and bf16 in its serving and training forms, K1-bwd in
   f32 and bf16, K2 and K3 on a real training batch's lattice;
4. serving slice: a seeded random full-width checkpoint of that model,
   decoded greedily through ``gluon_e2e_asr_tpu_torch.decode.main`` over
   the config's dev set; every kernel must have been launched, and only
   the kernels; the encoder output on the card is held against the
   plain versions on the CPU for a few utterances;
5. serving timing: CUDA events, median of 10 runs after warm-up;
6. training slice: ``gluon_e2e_asr_tpu_torch.train.main`` on the
   flagship config with ``loss.mtl_alpha=1.0`` for 40 steps at full
   width: the launch counts of all four kernels, no plain call, a finite
   and falling loss, a checkpoint;
7. training reference: one step of the trained model through the
   kernels and through the plain versions on the card (same batch,
   parameters, optimizer state and SpecAugment draws): loss, every
   gradient and the parameters after Adam;
8. training timing: each training kernel against its plain version, the
   train step at the 4.0 s bucket and at bench.py's shape (B=96, 12.8 s,
   96 labels), and a torch.profiler breakdown of the latter by kernel.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before the last line. Artifacts go to
``build/chip_smoke/``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
CONFIG = os.path.join(REPO, "configs", "english_flagship.yaml")
SEED = 0
BUCKET_SEC = 4.0  # the flagship config's longest bucket
# Kernel against plain version, max abs difference of the [B,T,2H]
# outputs. In f32 only the order of the sums differs. In bf16 h is
# rounded to bf16 every step, so a sum-order difference can flip one
# rounding, and the flip propagates through up to 400 steps.
TOL = {"float32": 1e-4, "bfloat16": 2e-2}
# K1-bwd (and the c stream of K1-fwd's training form) against the plain
# version, max abs difference over the largest magnitude of each output.
# f32: sum order (the weight gradients add split-K partial sums
# atomically). bf16: as above, and the kernel reads the activations the
# forward saved while the plain version recomputes them, so a rounding
# of dg to bf16 can also flip.
TOL_BWD = {"float32": 1e-4, "bfloat16": 3e-2}
# K2 and K3: the same f32 formulas with exact expf/logf; only the order
# of the three-term sums' rounding can differ. alpha: rtol on the live
# lattice cells (log-probabilities down to about -1000); post in [0, 1].
TOL_ALPHA_REL, TOL_POST = 1e-5, 1e-5
# The slice on the card against the plain versions on the CPU, bf16:
# the encoder output as above; the logits are bf16 values (the CTC head
# rounds its sum), so each may also differ by one bf16 ulp of itself.
TOL_SLICE_ENC = 2e-2
BF16_ULP = 2.0 ** -7  # relative, an upper bound
# One train step through the kernels against the plain versions, bf16:
# the loss (relative), each gradient (max abs difference over its
# largest magnitude) and the parameters after Adam (in units of the
# step's learning rate: a gradient difference d moves an Adam update by
# about 0.1 * d / sqrt(nu) of it, with the moments 40 steps old).
TOL_STEP_LOSS, TOL_STEP_GRAD, TOL_STEP_PARAM_LR = 1e-2, 5e-2, 5e-2
TRAIN_STEPS = 40
N_TIMED = 10
N_TIMED_PLAIN_STEP = 3  # the plain train step takes seconds
BENCH_SEC, BENCH_LABELS = 12.8, 96  # bench.py's shape


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(ok: bool, msg: str) -> None:
    if not ok:
        fail(msg)


def nvidia_smi(query: str) -> str:
    proc = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(proc.returncode == 0, f"nvidia-smi failed: {proc.stderr.strip()}")
    return proc.stdout.strip().splitlines()[0]


def time_ms(torch, fn, n=N_TIMED, warm=2) -> float:
    """Median device time of ``fn`` over ``n`` runs, CUDA events."""
    for _ in range(warm):
        fn()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def layer_inputs(torch, B, T, D, H, layer, dev):
    """Seeded inputs of one BiLSTM layer: CMVN-like features for the
    first layer, LSTM-output-like values in (-1, 1) for the others."""
    rng = np.random.RandomState(SEED + layer)
    x = rng.randn(B, T, D).astype(np.float32)
    if layer > 0:
        x = np.tanh(x)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    w_x = (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32)
    b_x = (rng.randn(8 * H) * 0.1).astype(np.float32)
    w_hf = (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    w_hb = (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32)
    return tuple(torch.from_numpy(a).to(dev)
                 for a in (x, lens, w_x, b_x, w_hf, w_hb))


def layer_cotangent(torch, B, T, H, layer, dev):
    rng = np.random.RandomState(100 + SEED + layer)
    return torch.from_numpy(rng.randn(B, T, 2 * H).astype(np.float32)).to(dev)


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


def synth_batch(batch: int, seconds: float, max_labels: int, seed: int = 0):
    """bench.py's batch (``__graft_entry__.py::_synth_batch``): seeded
    noise audio, lengths from half to all of ``seconds``, labels 4..29."""
    rng = np.random.RandomState(seed)
    n = int(seconds * 16000)
    audio = rng.randn(batch, n).astype(np.float32) * 0.1
    audio_len = np.full((batch,), n, np.int32)
    audio_len[1:] = rng.randint(n // 2, n + 1, size=batch - 1)
    labels = rng.randint(4, 30, size=(batch, max_labels)).astype(np.int32)
    label_len = rng.randint(max_labels // 2, max_labels + 1,
                            size=batch).astype(np.int32)
    labels = labels * (np.arange(max_labels)[None] < label_len[:, None])
    return {"audio": audio, "audio_len": audio_len, "labels": labels,
            "label_len": label_len}


@contextlib.contextmanager
def plain_route():
    """Send CUDA tensors through the plain versions: the reference side of
    this script's comparisons only (the port never does)."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm, ctc

    saved = bilstm._route, ctc._route
    bilstm._route = ctc._route = lambda t: "plain"
    try:
        yield
    finally:
        bilstm._route, ctc._route = saved


def counters():
    """name -> the object whose launches/calls count that version."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    kernels = {"bilstm_fwd": K.bilstm_fused_kernel,
               "bilstm_bwd": K.bilstm_fused_bwd_kernel,
               "ctc_alpha": C.ctc_alpha_kernel,
               "ctc_beta_post": C.ctc_beta_post_kernel}
    plains = {"bilstm_fwd": K.bilstm_fused_plain,
              "bilstm_bwd": K.bilstm_fused_bwd_plain,
              "ctc_alpha": C._alpha_plain,
              "ctc_beta_post": C._beta_post_plain}
    return kernels, plains


def reset_counts() -> None:
    kernels, plains = counters()
    for f in kernels.values():
        f.launches = 0
    for f in plains.values():
        f.calls = 0


def read_counts():
    kernels, plains = counters()
    return ({k: f.launches for k, f in kernels.items()},
            {k: f.calls for k, f in plains.items()})


def layer_shapes(config, T):
    """(layer, T, D) of each BiLSTM layer for T input frames."""
    mc, fc = config.model, config.frontend
    shapes, D = [], fc.n_mels * (1 + fc.deltas)
    for layer in range(mc.enc_layers):
        f = int(mc.enc_subsample[layer]) if layer < len(mc.enc_subsample) else 1
        T, D = -(-T // f), D * f
        shapes.append((layer, T, D))
        D = 2 * mc.enc_hidden
    return shapes


def main() -> None:
    import torch

    # 1. device
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke needs a card")
    card = nvidia_smi("name,power.limit")
    print(card, flush=True)
    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind, "count": torch.cuda.device_count(),
          "nvidia_smi": card, "torch": torch.__version__,
          "cuda": torch.version.cuda})
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from gluon_e2e_asr_tpu_torch import _build, decode
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.decoding.greedy import make_greedy_decoder
    from gluon_e2e_asr_tpu_torch.frontend.features import (
        frontend_apply, num_frames)
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.ops.bilstm import (
        bilstm_fused_kernel, bilstm_fused_plain)
    from gluon_e2e_asr_tpu_torch.training.checkpoint import save_checkpoint
    from gluon_e2e_asr_tpu_torch.training.trainer import (
        build_datasets, build_tokenizer)

    # 2. build
    libs = ("bilstm_fwd", "bilstm_bwd", "ctc")
    t0 = time.perf_counter()
    _build.build_all(libs)
    for name in libs:
        _build.load_library(name)
    built = {n: _build.build_info.get(n) for n in libs}
    emit({"phase": "build", "kernels": list(libs),
          "seconds": round(time.perf_counter() - t0, 3),
          "built_now": {n: b is not None for n, b in built.items()},
          "ptxas": {n: b[1].splitlines() for n, b in built.items() if b}})

    # 3. each kernel against its plain version at the flagship shapes
    config = load_config(CONFIG)
    mc, fc = config.model, config.frontend
    H, B = mc.enc_hidden, config.data.batch_size
    T = num_frames(int(BUCKET_SEC * fc.sample_rate), fc.win_length,
                   fc.hop_length)
    shapes = layer_shapes(config, T)
    errs = {}
    for layer, T, D in shapes:
        args = layer_inputs(torch, B, T, D, H, layer, dev)
        for cd_name in ("float32", "bfloat16"):
            cd = getattr(torch, cd_name)
            for round_xg in ((False, True) if cd_name == "bfloat16" else (False,)):
                y = bilstm_fused_kernel(*args, compute_dtype=cd,
                                        round_xg=round_xg)
                ref = bilstm_fused_plain(*args, compute_dtype=cd,
                                         round_xg=round_xg)
                torch.cuda.synchronize()
                err = float((y - ref).abs().max())
                finite = bool(torch.isfinite(y).all())
                errs[(layer, cd_name, round_xg)] = err
                emit({"phase": "kernel_check", "kernel": "bilstm_fwd",
                      "layer": layer, "B": B, "T": T, "D": D, "H": H,
                      "compute_dtype": cd_name, "round_xg": round_xg,
                      "max_abs_err": err, "tol": TOL[cd_name],
                      "finite": finite})
                check(finite and err <= TOL[cd_name],
                      f"bilstm_fwd disagrees with its plain version at layer "
                      f"{layer} {cd_name} round_xg={round_xg}: {err}")
    bwd_errs = check_training_kernels(torch, config, shapes, dev)

    # 4. the slice: a seeded checkpoint through the decode CLI
    os.makedirs(OUT_DIR, exist_ok=True)
    train_utts, dev_utts = build_datasets(config)
    tokenizer = build_tokenizer(config, (u.text for u in train_utts))
    model = build_model(config, tokenizer.vocab_size)
    model.encoder.reset_parameters(torch.Generator().manual_seed(SEED))
    ckpt = os.path.join(OUT_DIR, "seeded.pt")
    save_checkpoint(ckpt, model.state_dict(), {
        "epoch": 0, "batches_done": -1, "step": 0,
        "config_hash": config.fingerprint(),
        "vocab": tokenizer.to_json(),
        "vocab_hash": tokenizer.fingerprint(),
        "init_seed": SEED,
    })
    out_jsonl = os.path.join(OUT_DIR, "decode.jsonl")
    reset_counts()
    result = decode.main(["--config", CONFIG, "--ckpt", ckpt,
                          "--method", "greedy", "--output", out_jsonl,
                          "--device", "cuda"])
    launches = bilstm_fused_kernel.launches
    plain_calls = bilstm_fused_plain.calls
    expect = mc.enc_layers * (result["num_batches"] + result["warm_passes"])
    with open(out_jsonl) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    emit({"phase": "slice", "decode_done": result,
          "note": "random weights: the WER means nothing",
          "bilstm_fwd_launches": launches, "expected_launches": expect,
          "plain_calls": plain_calls, "records": len(recs)})
    check(launches == expect,
          f"bilstm_fwd launched {launches} times, expected {expect}")
    check(plain_calls == 0, f"the plain BiLSTM ran {plain_calls} times")
    check(result["num_utts"] == len(dev_utts) == len(recs),
          f"decoded {result['num_utts']} of {len(dev_utts)} utterances")
    check(all(isinstance(r["hyp"], str) for r in recs), "bad hyp records")
    decode_launches = launches

    # The encoder on the card against the plain versions on the CPU, on
    # the first utterances of the longest bucket.
    loader = decode.make_eval_loader(config, dev_utts, tokenizer)
    batches = list(loader.epoch(0))
    big = max(batches, key=lambda b: b.audio.shape[1])
    model_gpu = model.to(dev).eval()
    model_cpu = build_model(config, tokenizer.vocab_size)
    model_cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()})
    model_cpu.eval()
    rows = 8
    outs = {}
    with torch.inference_mode():
        for name, m, d in (("cuda", model_gpu, dev),
                           ("cpu", model_cpu, torch.device("cpu"))):
            audio = torch.from_numpy(big.audio[:rows]).to(d)
            alen = torch.from_numpy(big.audio_len[:rows]).to(d)
            feats, flen = frontend_apply(fc, audio, alen)
            enc, enc_len, logits = m.encode(feats, flen)
            outs[name] = [t.cpu() for t in (enc, enc_len, logits)]
    enc_err = float((outs["cuda"][0] - outs["cpu"][0]).abs().max())
    logit_diff = (outs["cuda"][2] - outs["cpu"][2]).abs()
    logit_err = float(logit_diff.max())
    logit_ok = bool((logit_diff <= TOL_SLICE_ENC
                     + BF16_ULP * outs["cpu"][2].abs()).all())
    agree = float((outs["cuda"][2].argmax(-1) == outs["cpu"][2].argmax(-1))
                  .float().mean())
    emit({"phase": "slice_reference", "rows": rows,
          "T_enc": int(outs["cuda"][0].shape[1]),
          "enc_max_abs_err": enc_err, "ctc_logits_max_abs_err": logit_err,
          "tol_enc": TOL_SLICE_ENC,
          "tol_ctc_logits": "tol_enc + 2^-7 * |logit|",
          "frame_argmax_agreement": agree,
          "finite": bool(torch.isfinite(outs["cuda"][2]).all())})
    check(torch.equal(outs["cuda"][1], outs["cpu"][1]), "encoder lengths differ")
    check(bool(torch.isfinite(outs["cuda"][2]).all()), "non-finite logits")
    check(enc_err <= TOL_SLICE_ENC and logit_ok,
          f"the slice on the card disagrees with the CPU: enc {enc_err}, "
          f"logits {logit_err}")

    # 5. timing
    kernel_ms, plain_ms = {}, {}
    for layer, T, D in shapes:
        args = layer_inputs(torch, B, T, D, H, layer, dev)
        for cd_name in ("float32", "bfloat16"):
            cd = getattr(torch, cd_name)
            k_ms = time_ms(torch, lambda: bilstm_fused_kernel(
                *args, compute_dtype=cd))
            p_ms = time_ms(torch, lambda: bilstm_fused_plain(
                *args, compute_dtype=cd))
            kernel_ms[(layer, cd_name)] = k_ms
            plain_ms[(layer, cd_name)] = p_ms
            emit({"phase": "timing", "what": "bilstm_fwd", "layer": layer,
                  "B": B, "T": T, "D": D, "H": H, "compute_dtype": cd_name,
                  "kernel_ms": k_ms, "plain_ms": p_ms, "card": card})
    decoder = make_greedy_decoder(model_gpu, config, None, dev)
    with torch.inference_mode():
        audio = torch.from_numpy(big.audio).to(dev)
        alen = torch.from_numpy(big.audio_len).to(dev)
        feats, flen = frontend_apply(fc, audio, alen)
        fe_ms = time_ms(torch, lambda: frontend_apply(fc, audio, alen))
        enc_ms = time_ms(torch, lambda: model_gpu.encode(feats, flen))
    dec_ms = time_ms(torch, lambda: [t.cpu() for t in decoder(
        big.audio, big.audio_len)])
    clocks = nvidia_smi("clocks.sm,power.draw,power.limit,temperature.gpu")
    emit({"phase": "timing", "what": "per_batch", "B": B,
          "samples": int(big.audio.shape[1]), "frontend_ms": fe_ms,
          "encoder_ms": enc_ms, "decode_ms": dec_ms,
          "decode_basis": "host audio in, ids on host, CUDA events",
          "card": card, "after_timing_sm_clock_power_limit_temp": clocks})
    del model_gpu, model, decoder

    # 6-8. training
    trainer, train_counts = train_slice(torch, config)
    step_errs = train_reference(torch, trainer, dev)
    train_ms = train_timing(torch, trainer, shapes, dev, card)

    bf16 = [(layer, "bfloat16") for layer, _, _ in shapes]
    emit({"kernels": [
        {"name": "bilstm_fwd", "route": "cuda",
         "source": "gluon_e2e_asr_tpu_torch/csrc/bilstm_fwd.cu",
         "replaces": "gluon_e2e_asr_tpu/ops/pallas_lstm.py:411",
         "launches": train_counts["bilstm_fwd"],
         "decode_launches": decode_launches,
         "max_abs_err": max(v for k, v in errs.items() if k[1] == "bfloat16"),
         "ms": sum(kernel_ms[k] for k in bf16),
         "plain_ms": sum(plain_ms[k] for k in bf16),
         "at": "serving form, sum over the flagship's 3 layer shapes, bf16, "
               "B=96, 4.0 s; launches from the training slice"},
        {"name": "bilstm_bwd", "route": "cuda",
         "source": "gluon_e2e_asr_tpu_torch/csrc/bilstm_bwd.cu",
         "replaces": "gluon_e2e_asr_tpu/ops/pallas_lstm.py:484",
         "launches": train_counts["bilstm_bwd"],
         "max_abs_err": max(bwd_errs["bilstm_bwd"]),
         "ms": train_ms["bilstm_bwd"][0], "plain_ms": train_ms["bilstm_bwd"][1],
         "at": "sum over the flagship's 3 layer shapes, bf16, B=96, 4.0 s; "
               "error: max abs over dx, dW_x, db, dW_h"},
        {"name": "ctc_alpha", "route": "cuda",
         "source": "gluon_e2e_asr_tpu_torch/csrc/ctc.cu",
         "replaces": "gluon_e2e_asr_tpu/ops/pallas_ctc.py:55",
         "launches": train_counts["ctc_alpha"],
         "max_abs_err": bwd_errs["ctc_alpha"],
         "ms": train_ms["ctc_alpha"][0], "plain_ms": train_ms["ctc_alpha"][1],
         "at": "T=100, B=96, S of a 4.0 s training batch; error over live cells"},
        {"name": "ctc_beta_post", "route": "cuda",
         "source": "gluon_e2e_asr_tpu_torch/csrc/ctc.cu",
         "replaces": "gluon_e2e_asr_tpu/ops/pallas_ctc.py:81",
         "launches": train_counts["ctc_beta_post"],
         "max_abs_err": bwd_errs["ctc_beta_post"],
         "ms": train_ms["ctc_beta_post"][0],
         "plain_ms": train_ms["ctc_beta_post"][1],
         "at": "T=100, B=96, S of a 4.0 s training batch"},
    ], "train_step": {k: v for k, v in step_errs.items()}})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def real_ctc_batch(torch, config, dev):
    """The lattice inputs of K2/K3 for the first 4.0 s training batch of
    the flagship config: its labels and encoder lengths, seeded logits."""
    from gluon_e2e_asr_tpu_torch.decode import make_eval_loader
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
    from gluon_e2e_asr_tpu_torch.ops import ctc as C
    from gluon_e2e_asr_tpu_torch.training.trainer import (
        build_datasets, build_tokenizer)

    train_utts, _ = build_datasets(config)
    tok = build_tokenizer(config, (u.text for u in train_utts))
    fc = config.frontend
    loader = make_eval_loader(config, train_utts, tok)  # unshuffled buckets
    last = len(loader.sampler.specs) - 1
    b = next(x for x in loader.epoch(0) if x.bucket == last)
    lens = num_frames(torch.from_numpy(b.audio_len), fc.win_length,
                      fc.hop_length)
    T = num_frames(b.audio.shape[1], fc.win_length, fc.hop_length)
    for f in config.model.enc_subsample:
        lens, T = (lens + int(f) - 1) // int(f), -(-T // int(f))
    rng = np.random.RandomState(SEED)
    logits = torch.from_numpy(
        rng.randn(b.audio.shape[0], T, tok.vocab_size).astype(np.float32) * 3)
    labels = torch.from_numpy(b.labels).to(dev)
    label_lens = torch.from_numpy(b.label_len).to(dev)
    logp = torch.log_softmax(logits.to(dev), -1)
    ext, skip, svalid, tmask = C._lattice(T, lens.to(dev).int(), labels,
                                          label_lens, 0)
    return C._gather_states(logp, ext), tmask, skip, svalid, label_lens


def check_training_kernels(torch, config, shapes, dev):
    """Phase 3, the training kernels: K1-fwd's training form and K1-bwd at
    the flagship's layer shapes, K2 and K3 on a real batch's lattice."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    H, B = config.model.enc_hidden, config.data.batch_size
    errs = {"bilstm_bwd": []}
    for layer, T, D in shapes:
        args = layer_inputs(torch, B, T, D, H, layer, dev)
        dy = layer_cotangent(torch, B, T, H, layer, dev)
        x, lens, w_x, b_x, w_hf, w_hb = args
        for cd_name in ("float32", "bfloat16"):
            cd = getattr(torch, cd_name)
            y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                               with_cell=True)
            yp, cp = K.bilstm_fused_plain(*args, compute_dtype=cd,
                                          with_cell=True)
            torch.cuda.synchronize()
            y_err, c_err = float((y - yp).abs().max()), rel_err(c, cp)
            emit({"phase": "kernel_check", "kernel": "bilstm_fwd",
                  "form": "training", "layer": layer, "T": T, "D": D,
                  "compute_dtype": cd_name, "h_max_abs_err": y_err,
                  "c_max_rel_err": c_err, "tol_h": TOL[cd_name],
                  "tol_c_rel": TOL_BWD[cd_name]})
            check(y_err <= TOL[cd_name] and c_err <= TOL_BWD[cd_name],
                  f"bilstm_fwd training form disagrees at layer {layer} "
                  f"{cd_name}: h {y_err}, c {c_err}")
            got = K.bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, c,
                                            acts, dy, compute_dtype=cd)
            ref = K.bilstm_fused_bwd_plain(x, lens, w_x, b_x, w_hf, w_hb, y,
                                           c, dy, compute_dtype=cd)
            torch.cuda.synchronize()
            rec = {"phase": "kernel_check", "kernel": "bilstm_bwd",
                   "layer": layer, "B": B, "T": T, "D": D, "H": H,
                   "compute_dtype": cd_name, "tol_rel": TOL_BWD[cd_name]}
            for name, g, r in zip(("dx", "dw_x", "db", "dw_hf", "dw_hb"),
                                  got, ref):
                rec[name] = {"max_abs_err": float((g - r).abs().max()),
                             "rel_err": rel_err(g, r),
                             "max_abs": float(r.abs().max())}
                check(bool(torch.isfinite(g).all())
                      and rel_err(g, r) <= TOL_BWD[cd_name],
                      f"bilstm_bwd {name} disagrees with its plain version "
                      f"at layer {layer} {cd_name}: {rel_err(g, r)}")
                if cd_name == "bfloat16":
                    errs["bilstm_bwd"].append(rec[name]["max_abs_err"])
            emit(rec)

    emit_, tmask, skip, svalid, label_lens = real_ctc_batch(torch, config, dev)
    alpha = C.ctc_alpha_kernel(emit_, tmask, skip, svalid)
    alpha_p = C._alpha_plain(emit_, tmask, skip, svalid)
    ll = C._log_likelihood(alpha_p, label_lens)
    post = C.ctc_beta_post_kernel(emit_, tmask, skip, svalid, 2 * label_lens,
                                  alpha_p, ll)
    post_p = C._beta_post_plain(emit_, tmask, skip, svalid, 2 * label_lens,
                                alpha_p, ll)
    torch.cuda.synchronize()
    live = alpha_p > -1e29
    a_err = float((alpha - alpha_p)[live].abs().max())
    a_rel = float(((alpha - alpha_p).abs() / alpha_p.abs().clamp(min=1.0))[live].max())
    dead_ok = bool((alpha[~live] <= -1e29).all())
    p_err = float((post - post_p).abs().max())
    T, Bc, S = emit_.shape
    emit({"phase": "kernel_check", "kernel": "ctc_alpha+ctc_beta_post",
          "T": T, "B": Bc, "S": S, "alpha_max_abs_err_live": a_err,
          "alpha_max_rel_err_live": a_rel, "alpha_dead_cells_agree": dead_ok,
          "post_max_abs_err": p_err, "tol_alpha_rel": TOL_ALPHA_REL,
          "tol_post": TOL_POST})
    check(a_rel <= TOL_ALPHA_REL and dead_ok,
          f"ctc_alpha disagrees with its plain version: {a_rel}")
    check(p_err <= TOL_POST,
          f"ctc_beta_post disagrees with its plain version: {p_err}")
    errs["ctc_alpha"], errs["ctc_beta_post"] = a_err, p_err
    return errs


def train_slice(torch, config):
    """Phase 6: the training CLI for TRAIN_STEPS steps at full width."""
    from gluon_e2e_asr_tpu_torch import train

    workdir = os.path.join(OUT_DIR, "train")
    shutil.rmtree(workdir, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    trainer = train.main([
        "--config", CONFIG, "--set", "loss.mtl_alpha=1.0",
        "--set", "train.dp=false", "--set", "train.log_every_steps=1",
        "--max-steps", str(TRAIN_STEPS), "--workdir", workdir,
        "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    losses = [r["loss"] for r in lines if r["event"] == "train"]
    epochs = [r for r in lines if r["event"] == "epoch"]
    dev_batches = len(list(trainer.dev_loader.sampler.epoch_batches(0)))
    layers = config.model.enc_layers
    expect = {"bilstm_fwd": layers * (TRAIN_STEPS + dev_batches * len(epochs)),
              "bilstm_bwd": layers * TRAIN_STEPS,
              "ctc_alpha": TRAIN_STEPS, "ctc_beta_post": TRAIN_STEPS}
    ckpt = os.path.join(workdir, config.train.ckpt_dir,
                        f"ckpt_{TRAIN_STEPS}.pt")
    first, last = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    emit({"phase": "train_slice", "steps": trainer.state.step,
          "wall_s": round(wall, 2), "launches": launches,
          "expected_launches": expect, "plain_calls": plain,
          "epochs": [{k: r[k] for k in ("epoch", "step", "dev_wer", "dev_cer",
                                        "utt_per_sec_per_chip")}
                     for r in epochs],
          "dev_batches_per_eval": dev_batches, "losses": losses,
          "loss_first5": first, "loss_last5": last,
          "checkpoint": os.path.relpath(ckpt, REPO),
          "note": "random init, 40 steps: the WER means nothing"})
    check(trainer.state.step == TRAIN_STEPS == len(losses),
          f"trained {trainer.state.step} steps, logged {len(losses)}")
    check(launches == expect, f"training launches {launches}, expected {expect}")
    check(not any(plain.values()), f"plain versions ran in training: {plain}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(last < first, f"the loss did not fall: first 5 {first}, last 5 {last}")
    check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
    return trainer, launches


def train_reference(torch, trainer, dev):
    """Phase 7: one step of the trained model through the kernels and
    through the plain versions on the card, from the same state."""
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training.train_step import (
        TrainState, batch_to_device, make_train_step)

    config = trainer.config
    b = next(x for x in trainer.loader.epoch(0)
             if x.bucket == len(trainer.sampler.specs) - 1)
    batch = batch_to_device(b, dev)
    params0 = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    runs = {}
    for route in ("kernel", "plain"):
        model = build_model(config, trainer.tokenizer.vocab_size, train=True)
        model.load_state_dict(params0)
        model.to(dev)
        state = TrainState(step=trainer.state.step,
                           opt_state=copy.deepcopy(trainer.state.opt_state),
                           generator=torch.Generator().manual_seed(SEED))
        step = make_train_step(model, config, trainer.optimizer)
        with plain_route() if route == "plain" else contextlib.nullcontext():
            m = step(state, batch)
        torch.cuda.synchronize()
        runs[route] = (float(m["loss"]), float(m["grad_norm"]),
                       {k: p.grad.detach().clone()
                        for k, p in model.named_parameters()},
                       {k: v.detach().clone()
                        for k, v in model.state_dict().items()})
    (lk, nk, gk, pk), (lp, np_, gp, pp) = runs["kernel"], runs["plain"]
    lr = trainer.optimizer.lr(trainer.state.opt_state["count"])
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = {k: rel_err(gk[k], gp[k]) for k in gk}
    param_lr = max(float((pk[k] - pp[k]).abs().max()) for k in pk) / lr
    moved = max(float((pp[k] - params0[k]).abs().max()) for k in pp) / lr
    out = {"loss_kernel": lk, "loss_plain": lp, "loss_rel_err": loss_rel,
           "grad_norm_kernel": nk, "grad_norm_plain": np_,
           "grad_max_rel_err": max(grad_rel.values()),
           "param_max_abs_err_over_lr": param_lr, "lr": lr,
           "plain_update_max_over_lr": moved}
    emit({"phase": "train_reference", "T_frames": int(b.audio.shape[1]),
          "grad_rel_err": grad_rel, **out,
          "tol": {"loss_rel": TOL_STEP_LOSS, "grad_rel": TOL_STEP_GRAD,
                  "param_over_lr": TOL_STEP_PARAM_LR}})
    check(loss_rel <= TOL_STEP_LOSS, f"train step loss: {lk} vs {lp}")
    check(max(grad_rel.values()) <= TOL_STEP_GRAD,
          f"train step gradients disagree: {grad_rel}")
    check(param_lr <= TOL_STEP_PARAM_LR,
          f"parameters after Adam disagree by {param_lr} x LR")
    return out


def train_timing(torch, trainer, shapes, dev, card):
    """Phase 8: CUDA-event timings of the training kernels and steps, and
    a torch.profiler breakdown of the step at bench.py's shape."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.ops import ctc as C
    from gluon_e2e_asr_tpu_torch.training.train_step import (
        TrainState, batch_to_device, make_train_step)

    config = trainer.config
    H, B = config.model.enc_hidden, config.data.batch_size
    out = {}
    sums = {"kernel": 0.0, "plain": 0.0}
    for layer, T, D in shapes:
        args = layer_inputs(torch, B, T, D, H, layer, dev)
        x, lens, w_x, b_x, w_hf, w_hb = args
        dy = layer_cotangent(torch, B, T, H, layer, dev)
        for cd_name in ("float32", "bfloat16"):
            cd = getattr(torch, cd_name)
            y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                               with_cell=True)
            k_ms = time_ms(torch, lambda: K.bilstm_fused_bwd_kernel(
                x, lens, w_x, w_hf, w_hb, y, c, acts, dy, compute_dtype=cd))
            p_ms = time_ms(torch, lambda: K.bilstm_fused_bwd_plain(
                x, lens, w_x, b_x, w_hf, w_hb, y, c, dy, compute_dtype=cd),
                n=5, warm=1)
            f_ms = time_ms(torch, lambda: K.bilstm_fused_kernel(
                *args, compute_dtype=cd, with_cell=True))
            emit({"phase": "timing", "what": "bilstm_bwd", "layer": layer,
                  "B": B, "T": T, "D": D, "H": H, "compute_dtype": cd_name,
                  "kernel_ms": k_ms, "plain_ms": p_ms, "plain_runs": 5,
                  "fwd_training_form_kernel_ms": f_ms, "card": card})
            if cd_name == "bfloat16":
                sums["kernel"] += k_ms
                sums["plain"] += p_ms
    out["bilstm_bwd"] = (sums["kernel"], sums["plain"])

    emit_, tmask, skip, svalid, label_lens = real_ctc_batch(torch, trainer.config, dev)
    alpha = C.ctc_alpha_kernel(emit_, tmask, skip, svalid)
    ll = C._log_likelihood(alpha, label_lens)
    last = 2 * label_lens
    out["ctc_alpha"] = (
        time_ms(torch, lambda: C.ctc_alpha_kernel(emit_, tmask, skip, svalid)),
        time_ms(torch, lambda: C._alpha_plain(emit_, tmask, skip, svalid)))
    out["ctc_beta_post"] = (
        time_ms(torch, lambda: C.ctc_beta_post_kernel(
            emit_, tmask, skip, svalid, last, alpha, ll)),
        time_ms(torch, lambda: C._beta_post_plain(
            emit_, tmask, skip, svalid, last, alpha, ll)))
    T, Bc, S = emit_.shape
    for name in ("ctc_alpha", "ctc_beta_post"):
        emit({"phase": "timing", "what": name, "T": T, "B": Bc, "S": S,
              "kernel_ms": out[name][0], "plain_ms": out[name][1],
              "card": card})

    def stepper(route="kernel"):
        """A step function and state on a copy of the trained model."""
        from gluon_e2e_asr_tpu_torch.models.asr import build_model

        model = build_model(config, trainer.tokenizer.vocab_size, train=True)
        model.load_state_dict(trainer.model.state_dict())
        model.to(dev)
        state = TrainState(step=trainer.state.step,
                           opt_state=copy.deepcopy(trainer.state.opt_state),
                           generator=torch.Generator().manual_seed(SEED))
        fn = make_train_step(model, config, trainer.optimizer)
        if route == "plain":
            def run(batch):
                with plain_route():
                    return fn(state, batch)
            return run
        return lambda batch: fn(state, batch)

    b4 = next(x for x in trainer.loader.epoch(0)
              if x.bucket == len(trainer.sampler.specs) - 1)
    batch4 = batch_to_device(b4, dev)
    step_k = stepper()
    step_p = stepper("plain")
    k4 = time_ms(torch, lambda: step_k(batch4))
    p4 = time_ms(torch, lambda: step_p(batch4), n=N_TIMED_PLAIN_STEP, warm=1)
    emit({"phase": "timing", "what": "train_step", "shape": "4.0 s bucket",
          "B": int(b4.audio.shape[0]), "samples": int(b4.audio.shape[1]),
          "max_labels": int(b4.labels.shape[1]), "kernel_ms": k4,
          "plain_ms": p4, "plain_runs": N_TIMED_PLAIN_STEP,
          "utt_per_s": b4.num_real / (k4 / 1e3), "card": card})

    bench = synth_batch(B, BENCH_SEC, BENCH_LABELS, SEED)
    batch12 = {k: torch.from_numpy(v).to(dev) for k, v in bench.items()}
    step12 = stepper()
    torch.cuda.reset_peak_memory_stats()
    k12 = time_ms(torch, lambda: step12(batch12))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "timing", "what": "train_step", "shape": "bench.py",
          "B": B, "seconds": BENCH_SEC, "max_labels": BENCH_LABELS,
          "dtype": config.model.compute_dtype, "kernel_ms": k12,
          "utt_per_s": B / (k12 / 1e3), "peak_mem_gib": round(peak, 2),
          "card": card,
          "sm_clock_power_limit_temp": nvidia_smi(
              "clocks.sm,power.draw,power.limit,temperature.gpu")})
    out["step_4s"], out["step_12s"] = (k4, p4), k12
    profile_step(torch, lambda: step12(batch12), card)
    return out


def profile_step(torch, fn, card, steps=3):
    """torch.profiler over ``steps`` train steps: device time by kernel
    and the device's idle share of the window's wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((evt.key, us / 1e3 / steps, evt.count // steps))
    rows.sort(key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    wall = wall_ms / steps
    os.makedirs(OUT_DIR, exist_ok=True)
    prof.export_chrome_trace(os.path.join(OUT_DIR, "train_step_trace.json"))
    emit({"phase": "profile", "what": "train_step at bench.py's shape",
          "steps": steps, "wall_ms_per_step": wall,
          "device_busy_ms_per_step": busy,
          "idle_share": 1.0 - busy / wall if wall > 0 else None,
          "by_kernel": [{"kernel": k[:120], "ms_per_step": ms,
                         "launches_per_step": n, "share": ms / busy}
                        for k, ms, n in rows[:15]],
          "card": card})
    check(busy > 0, "the profiler saw no device time")


if __name__ == "__main__":
    main()
