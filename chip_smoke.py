#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``nvidia-smi``; it imports no JAX. Phases,
each printing JSON lines:

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA library of the port's paths (``bilstm_fwd``,
   ``bilstm_bwd``, ``ctc``, ``las_decoder``, ``frontend``,
   ``pipeline_probe``) from ``csrc/``, one nvcc each, in parallel;
3. kernels: each kernel against its plain PyTorch version on the card,
   within stated tolerances, at the shapes the flagship model
   (``configs/english_flagship.yaml``, the 4.0 s bucket, B=96) gives it:
   K1-fwd in f32 and bf16 in its serving and training forms, K1-bwd in
   f32 and bf16 (both also at milestone 2's layer shapes, B=16, H=256,
   and with B=50 and K1-fwd with B=1; every call of either through its
   cluster recurrence, and K1-bwd's dg alone against the plain sweep);
   K1-bwd's products (dx, dW_x, dW_h, db: bf16 on wgmma) through their own
   entry against their plain twin on the recurrence's dg at the
   flagship's three layers, milestone 2's and ragged shapes (B=1 and T=1,
   every length 1, odd widths); K2 and K3 on a real training batch's
   lattice, K4-fwd
   and K4-bwd in dot mode in f32 and bf16 with the scheduled-sampling
   coins off and on, on that batch's labels and encoder lengths; then
   K4-fwd and K4-bwd in add and loc mode the same way at the shapes of
   the location-aware flagship (``configs/flagship_bf16.yaml``: C=10
   channels of a width-100 filter), every cotangent checked, the
   filter's through the band; and loc once at bench.py's T'=320; K5 and
   K6 (the fused frontend) at milestone 2's two buckets, the flagship's
   4.0 s bucket and bench.py's shape, in every CMVN mode, eval and train;
   K7-fwd and K7-bwd (the v1 layer) at the flagship's layer-0 shape in
   f32 and bf16; P1's two variants (``l2``, ``cluster``) and cuDNN's
   LSTM against P1's plain version at (M, N) = (96, 2) and (256, 4),
   T=640;
4. serving slice: a seeded random full-width checkpoint of that model,
   decoded greedily through ``gluon_e2e_asr_tpu_torch.decode.main`` over
   the config's dev set; every kernel must have been launched (every
   K1-fwd launch through the cluster recurrence), and only the
   kernels; the encoder output on the card is held against the
   plain versions on the CPU for a few utterances;
5. serving timing: CUDA events, median of 10 runs after warm-up, K1-fwd
   whole and its recurrence alone in both forms (held against the plain
   recurrence on the same projection), the projection the difference;
6. training slices: ``gluon_e2e_asr_tpu_torch.train.main`` at full
   width on the flagship config as shipped (hybrid CTC/attention, dot
   attention, ``train.dp=false``) for two epochs: the launch counts of
   all six kernels (every K1-bwd launch of every slice through the
   cluster recurrence), no plain call, a finite and falling loss, the
   attention loss and accuracy logged, a checkpoint (every K1-fwd and
   K7-fwd launch of every slice and decode through the cluster
   recurrence too); a CTC-only run
   (``loss.mtl_alpha=1.0``) of a few steps; the location-aware flagship
   (``flagship_bf16.yaml``) for two epochs, K4 in loc mode on every step
   and each epoch's dev evaluation through the beam as shipped (K=10,
   ctc_weight 0.3); a few steps of it with add attention; milestone 2
   (``configs/milestone2_fused_frontend.yaml``, K5 on every step and dev
   batch) for two epochs and a greedy decode of its checkpoint, and a few
   steps with ``frontend.impl=pallas_regrid`` (K6); the tiny golden
   decoded greedily through K5 (``golden_greedy.jsonl``, 16/16); and K7's
   own path, ``bilstm_pallas`` forward and backward;
7. training reference: one hybrid step of the trained dot and loc models
   (scheduled sampling off) through the kernels and through the plain
   versions on the card (same batch, parameters, optimizer state and
   SpecAugment draws): loss, every gradient and the parameters after
   Adam;
8. training timing: each training kernel against its plain version and
   beside the one PyTorch call that computes the same function where
   there is one (cuDNN's LSTM for K1, ``F.ctc_loss`` for K2/K3,
   ``torch.addmm`` for K1-fwd's projection), K1-bwd's recurrence alone
   beside the whole call, K1-bwd's products through their own entry
   beside cuBLAS on the same bf16 operands, K4 in
   its three modes, K5 and K6 beside the jnp path and ``torch.stft``, K7,
   the milestone 2 step and its frontend's share, the dot and loc hybrid
   train steps at the 4.0 s
   bucket and at bench.py's shape (B=96, 12.8 s, 96 labels), and a
   torch.profiler breakdown of both at the latter by kernel;
9. beam search: the blessed tiny golden (read from its JAX checkpoint
   without JAX) decoded with ``--method beam`` through the decode CLI on
   the card must reproduce ``tests/goldens/golden_beam.jsonl``; and one
   beam decode of a 96-utterance 4.0 s batch of the trained loc model,
   timed as frontend, encoder and search;
10. P1, the pipelining probe: its entry point
   (``python -m gluon_e2e_asr_tpu_torch.tools.pipeline_probe``) over
   M = 96 and 128, N = 1..4, both variants, the counts reset just before
   and read just after; the plain version and cuDNN's LSTM timed at the
   same shapes.

Then the kernels line (each kernel's launches on the main path, error,
time, plain time, bound and library time) and, last, ``{"ok": true,
"device": {...}}``. Any failed check exits non-zero before the last
line. Artifacts go to ``build/chip_smoke/``.
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
import types

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(REPO, "build", "chip_smoke")
CONFIG = os.path.join(REPO, "configs", "english_flagship.yaml")
LOC_CONFIG = os.path.join(REPO, "configs", "flagship_bf16.yaml")
M2_CONFIG = os.path.join(REPO, "configs", "milestone2_fused_frontend.yaml")
GOLD = os.path.join(REPO, "tests", "goldens")
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
# K1-bwd's products (dx, dW_x, dW_h, db) through their own entry against
# their plain twin on the same dg: both round the operands to bf16 and sum
# in f32 (db over the unrounded dg), so only the order of the sums
# differs (the weight gradients' split-K atomics among it): max abs
# difference over each output's largest magnitude, TOL_BWD's f32 entry.
TOL_PRODUCTS = TOL_BWD["float32"]
# the products' ragged shapes: (name, B, T, D, H, every length 1)
PRODUCTS_RAGGED = (("B=1, T=1", 1, 1, 80, 256, False),
                   ("lens of 1", 8, 150, 1280, 256, True),
                   ("odd widths", 5, 37, 33, 130, False))
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
# K4-fwd and K4-bwd against their plain versions, max abs difference over
# the largest magnitude of each output (logits, h, c, att, ctx; every
# cotangent). f32: the order of the sums. bf16: a sum on the other side of
# a bf16 rounding boundary changes an operand of the next product by one
# bf16 ulp (2^-8 relative) and the L-step recurrence carries it along; the
# backward kernel also reads the activations the forward saved where the
# plain version recomputes them.
TOL_DEC = {"float32": 1e-4, "bfloat16": 2e-2}
# With the scheduled-sampling coins on, such a flip can change an argmax
# and with it a row's later inputs: the rows whose fed-back tokens agree
# are compared, and at least this share of rows must agree (all of them in
# f32). Sound runs read 1.0 at T'=100 and T'=320, so a bf16-only fault in
# the argmax or the feedback that parts more than a tenth of the rows fails.
MIN_ROWS_AGREE_BF16 = 0.9
# The beam on the card against the golden the JAX package blessed on the
# CPU: every hypothesis identical, the scores (sums of f32 log-
# probabilities over tens of steps, the encoder's sums taken in another
# order on the card) within this.
TOL_GOLDEN_SCORE = 1e-3
# K5 and K6 against their plain versions: the JAX suite's frontend
# tolerance (tests/test_pallas_frontend.py; two implementations of true-f32
# products, log-domain features), |kernel - plain| <= atol + rtol * |plain|;
# masked cells exactly 0 in both.
TOL_FE_RTOL, TOL_FE_ATOL = 1e-3, 2e-3
# K7-fwd and K7-bwd against their plain versions, max abs difference over
# each output's largest magnitude, as TOL_BWD: the plain backward
# recomputes the gates from the rounded streams, the kernel reuses the
# forward's activations (the same values up to the order of the sums).
TOL_V1 = {"float32": 1e-4, "bfloat16": 2e-2}
# P1's kernels and cuDNN's LSTM against P1's plain version, max abs
# difference of the final h: f32 sums in another order carried over
# PROBE_T steps, as K1 in f32.
TOL_PROBE = TOL["float32"]
PROBE_T = 640  # the TPU probe's default
PROBE_CHECKS = ((96, 2), (256, 4))  # (M, N) held against the plain version
PROBE_MS = (96, 128)  # the rows of the probe's verdicts, swept and timed
PROBE_ITERS = 10
PROBE_LIVE = 0.1  # mean |h| of the checked output (live_inputs: about 0.35)
TRAIN_EPOCHS = 2  # the hybrid and milestone 2 slices train this many epochs
M2_REGRID_STEPS = 5
CTC_ONLY_STEPS = 5
ADD_STEPS = 3
N_BEAM_TIMED = 3
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
    from gluon_e2e_asr_tpu_torch.frontend import fused
    from gluon_e2e_asr_tpu_torch.ops import bilstm, ctc, las_decoder

    mods = (bilstm, ctc, las_decoder, fused)
    saved = [m._route for m in mods]
    for m in mods:
        m._route = lambda t: "plain"
    try:
        yield
    finally:
        for m, r in zip(mods, saved):
            m._route = r


ATT_MODES = ("dot", "add", "loc")


def counters():
    """name -> the object whose launches/calls count that version."""
    from gluon_e2e_asr_tpu_torch.frontend import fused as FE
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.ops import ctc as C
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD

    kernels = {"bilstm_fwd": K.bilstm_fused_kernel,
               "bilstm_bwd": K.bilstm_fused_bwd_kernel,
               "bilstm_bwd_products": K.bilstm_fused_bwd_products_kernel,
               "ctc_alpha": C.ctc_alpha_kernel,
               "ctc_beta_post": C.ctc_beta_post_kernel,
               "las_decoder_fwd": LD.las_decoder_fwd_kernel,
               "las_decoder_bwd": LD.las_decoder_bwd_kernel,
               "frontend_k5": FE.compute_features_pallas_kernel,
               "frontend_k6": FE.compute_features_pallas_regrid_kernel,
               "bilstm_v1_fwd": K.bilstm_pallas_kernel,
               "bilstm_v1_bwd": K.bilstm_pallas_bwd_kernel}
    plains = {"bilstm_fwd": K.bilstm_fused_plain,
              "bilstm_bwd": K.bilstm_fused_bwd_plain,
              "bilstm_bwd_products": K.bilstm_fused_bwd_products_plain,
              "ctc_alpha": C._alpha_plain,
              "ctc_beta_post": C._beta_post_plain,
              "las_decoder_fwd": LD.las_decoder_fwd_plain,
              "las_decoder_bwd": LD.las_decoder_bwd_plain,
              "frontend_k5": FE.compute_features_pallas_plain,
              "frontend_k6": FE.compute_features_pallas_regrid_plain,
              "bilstm_v1_fwd": K.bilstm_pallas_plain,
              "bilstm_v1_bwd": K.bilstm_pallas_bwd_plain}
    return kernels, plains


# K1's and K7's launches through the cluster recurrences, counted
# beside their launches (ops/bilstm.py): name -> the kernel of kernels().
CLUSTER_COUNTS = {"bilstm_fwd_cluster": "bilstm_fwd",
                  "bilstm_bwd_cluster": "bilstm_bwd",
                  "bilstm_v1_fwd_cluster": "bilstm_v1_fwd",
                  "bilstm_v1_bwd_cluster": "bilstm_v1_bwd"}


def reset_counts() -> None:
    kernels, plains = counters()
    for f in kernels.values():
        f.launches = 0
        if hasattr(f, "by_mode"):
            f.by_mode.update(dict.fromkeys(f.by_mode, 0))
        if hasattr(f, "cluster_launches"):
            f.cluster_launches = 0
    for f in plains.values():
        f.calls = 0


def read_counts():
    """(launches by kernel, with K4's by mode as ``<name>_<mode>`` and
    K1's and K7's through the cluster recurrences as CLUSTER_COUNTS names
    them; calls of the plain versions)."""
    kernels, plains = counters()
    launches = {k: f.launches for k, f in kernels.items()}
    for k, of in CLUSTER_COUNTS.items():
        launches[k] = kernels[of].cluster_launches
    for k in ("las_decoder_fwd", "las_decoder_bwd"):
        for m in ATT_MODES:
            launches[f"{k}_{m}"] = kernels[k].by_mode[m]
    return launches, {k: f.calls for k, f in plains.items()}


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


T_START = time.perf_counter()


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
    from gluon_e2e_asr_tpu_torch.models.lstm import bilstm_scan
    from gluon_e2e_asr_tpu_torch.ops import bilstm
    from gluon_e2e_asr_tpu_torch.ops.bilstm import (
        bilstm_fused_kernel, bilstm_fused_plain)
    from gluon_e2e_asr_tpu_torch.training.checkpoint import save_checkpoint
    from gluon_e2e_asr_tpu_torch.training.trainer import (
        build_datasets, build_tokenizer)

    # 2. build
    libs = ("bilstm_fwd", "bilstm_bwd", "ctc", "las_decoder", "frontend",
            "pipeline_probe")
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
                n_cluster = bilstm_fused_kernel.cluster_launches
                y = bilstm_fused_kernel(*args, compute_dtype=cd,
                                        round_xg=round_xg)
                ref = bilstm_fused_plain(*args, compute_dtype=cd,
                                         round_xg=round_xg)
                torch.cuda.synchronize()
                cluster = bilstm_fused_kernel.cluster_launches - n_cluster
                err = float((y - ref).abs().max())
                finite = bool(torch.isfinite(y).all())
                errs[(layer, cd_name, round_xg)] = err
                emit({"phase": "kernel_check", "kernel": "bilstm_fwd",
                      "layer": layer, "B": B, "T": T, "D": D, "H": H,
                      "compute_dtype": cd_name, "round_xg": round_xg,
                      "max_abs_err": err, "tol": TOL[cd_name],
                      "cluster_launches": cluster, "finite": finite})
                check(finite and err <= TOL[cd_name],
                      f"bilstm_fwd disagrees with its plain version at layer "
                      f"{layer} {cd_name} round_xg={round_xg}: {err}")
                check(cluster == 1, f"bilstm_fwd at layer {layer} did not go "
                                    "through the cluster recurrence")
    m2_config = load_config(M2_CONFIG)
    bwd_errs = check_training_kernels(torch, config, shapes, dev, m2_config)
    products_errs = check_products_kernels(torch, config, shapes, dev,
                                           m2_config)
    dec_errs = check_decoder_kernels(torch, config, dev)
    loc_config = load_config(LOC_CONFIG)
    mode_errs = {m: check_decoder_kernels(torch, loc_config, dev, m)
                 for m in ("add", "loc")}
    check_decoder_kernels(torch, loc_config, dev, "loc",
                          cases=[("bfloat16", 0.0, True)])
    fe_errs = check_frontend_kernels(torch, m2_config, config, dev)
    v1_errs = check_v1_kernels(torch, config, shapes[0], dev)
    probe_errs = check_probe_kernels(torch, dev)

    # 4. the slice: a seeded checkpoint through the decode CLI
    os.makedirs(OUT_DIR, exist_ok=True)
    train_utts, dev_utts = build_datasets(config)
    tokenizer = build_tokenizer(config, (u.text for u in train_utts))
    model = build_model(config, tokenizer.vocab_size,
                        sos_id=tokenizer.sos_id, eos_id=tokenizer.eos_id)
    gen = torch.Generator().manual_seed(SEED)
    model.encoder.reset_parameters(gen)
    model.decoder.reset_parameters(gen)
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
    cluster_launches = bilstm_fused_kernel.cluster_launches
    plain_calls = bilstm_fused_plain.calls
    expect = mc.enc_layers * (result["num_batches"] + result["warm_passes"])
    with open(out_jsonl) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    emit({"phase": "slice", "decode_done": result,
          "note": "random weights: the WER means nothing",
          "bilstm_fwd_launches": launches, "expected_launches": expect,
          "bilstm_fwd_cluster_launches": cluster_launches,
          "plain_calls": plain_calls, "records": len(recs)})
    check(launches == expect,
          f"bilstm_fwd launched {launches} times, expected {expect}")
    check(cluster_launches == launches,
          f"{launches - cluster_launches} bilstm_fwd launches of the decode "
          "missed the cluster recurrence")
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

    # 5. timing; K1-fwd's recurrence alone (both forms) over the same
    # projection, held against the plain recurrence (bilstm_scan) on it
    kernel_ms, plain_ms, recur_ms, recur_errs = {}, {}, {}, {}
    for layer, T, D in shapes:
        args = layer_inputs(torch, B, T, D, H, layer, dev)
        x, lens, w_x, b_x, w_hf, w_hb = args
        for cd_name in ("float32", "bfloat16"):
            cd = getattr(torch, cd_name)
            k_ms = time_ms(torch, lambda: bilstm_fused_kernel(
                *args, compute_dtype=cd))
            p_ms = time_ms(torch, lambda: bilstm_fused_plain(
                *args, compute_dtype=cd))
            kernel_ms[(layer, cd_name)] = k_ms
            plain_ms[(layer, cd_name)] = p_ms
            xg = torch.cat(bilstm._project(x, lens, w_x, b_x, cd, False),
                           -1).contiguous()
            xg_train = xg.clone()  # overwritten with the activations
            xg_f, xg_b = xg[..., :4 * H], xg[..., 4 * H:]
            y_r = bilstm.bilstm_fused_fwd_recur_kernel(xg, lens, w_hf, w_hb, cd)
            y_rp = bilstm_scan(xg_f, xg_b, lens, w_hf, w_hb, cd)
            torch.cuda.synchronize()
            err = float((y_r - y_rp).abs().max())
            recur_errs[(layer, cd_name)] = err
            check(bool(torch.isfinite(y_r).all()) and err <= TOL[cd_name],
                  f"K1-fwd's recurrence alone disagrees with the plain "
                  f"recurrence at layer {layer} {cd_name}: {err}")
            r_ms = time_ms(torch, lambda: bilstm.bilstm_fused_fwd_recur_kernel(
                xg, lens, w_hf, w_hb, cd))
            rt_ms = time_ms(torch, lambda: bilstm.bilstm_fused_fwd_recur_kernel(
                xg_train, lens, w_hf, w_hb, cd, True))
            rp_ms = time_ms(torch, lambda: bilstm_scan(
                xg_f, xg_b, lens, w_hf, w_hb, cd), n=3, warm=1)
            recur_ms[(layer, cd_name)] = (r_ms, rp_ms)
            emit({"phase": "timing", "what": "bilstm_fwd", "layer": layer,
                  "B": B, "T": T, "D": D, "H": H, "compute_dtype": cd_name,
                  "kernel_ms": k_ms, "plain_ms": p_ms,
                  "recurrence_kernel_ms": r_ms,
                  "recurrence_us_per_step": r_ms * 1e3 / T,
                  "recurrence_training_form_ms": rt_ms,
                  "recurrence_training_form_us_per_step": rt_ms * 1e3 / T,
                  "projection_ms": k_ms - r_ms,
                  "projection_basis": "whole call - recurrence alone",
                  "recurrence_plain_ms": rp_ms, "recurrence_plain_runs": 3,
                  "recurrence_max_abs_err": err, "card": card})
            del xg, xg_train, y_r, y_rp
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

    # 6-8. training: the dot hybrid path, the CTC-only path, the
    # location-aware flagship and its add-attention variant
    trainer, train_counts = train_slice(torch, CONFIG, "train")
    _, ctc_counts = train_slice(torch, CONFIG, "train_ctc_only",
                                CTC_ONLY_STEPS, ctc_only=True)
    loc_trainer, loc_counts = train_slice(torch, LOC_CONFIG, "train_loc")
    _, add_counts = train_slice(torch, LOC_CONFIG, "train_add", ADD_STEPS,
                                ["--set", "model.att_type=add"])
    # the milestone 2 config (K5 on every step and dev batch), a greedy
    # decode of its checkpoint, a few steps through K6, the tiny golden
    # through K5, and K7's own path
    m2_trainer, m2_counts = train_slice(torch, M2_CONFIG, "train_m2",
                                        ctc_only=True)
    m2_decode_counts = decode_slice(torch, m2_trainer, M2_CONFIG, "train_m2")
    _, regrid_counts = train_slice(
        torch, M2_CONFIG, "train_m2_regrid", M2_REGRID_STEPS,
        ["--set", "frontend.impl=pallas_regrid"], ctc_only=True, falls=False)
    golden_greedy(torch)
    v1_counts = v1_path(torch, shapes[0], config, dev)
    step_errs = train_reference(torch, trainer, dev)
    loc_step_errs = train_reference(torch, loc_trainer, dev)
    train_ms = train_timing(torch, trainer, shapes, dev, card)
    train_ms.update(loc_timing(torch, loc_trainer, dev, card))
    lib_ms = library_timing(torch, config, shapes, dev, card)
    fe_ms, fe_notes = frontend_timing(torch, m2_trainer, config, dev, card)
    train_ms.update(fe_ms)
    train_ms.update(v1_timing(torch, config, shapes[0], dev, card))
    train_ms["bilstm_bwd_products"], lib_ms["bilstm_bwd_products"] = \
        products_timing(torch, config, shapes, dev, card, m2_config)
    # 9. beam search
    golden_beam(torch)
    beam_timing(torch, loc_trainer, dev, card)
    # 10. P1
    probe_ms, probe_counts, probe_lib = probe_path(torch, dev, card)
    bounds = kernel_bounds(config, shapes, dev, loc_config, m2_config)

    bf16 = [(layer, "bfloat16") for layer, _, _ in shapes]
    timed = {
        "bilstm_fwd": (sum(kernel_ms[k] for k in bf16),
                       sum(plain_ms[k] for k in bf16)),
        "bilstm_fwd_cluster": (sum(recur_ms[k][0] for k in bf16),
                               sum(recur_ms[k][1] for k in bf16)),
        **{k: train_ms[k] for k in ("bilstm_bwd", "bilstm_bwd_cluster",
                                     "bilstm_bwd_products", "ctc_alpha",
                                     "ctc_beta_post",
                                     "las_decoder_fwd", "las_decoder_bwd",
                                     "frontend_k5", "frontend_k6",
                                     "bilstm_v1_fwd", "bilstm_v1_bwd")}}
    errors = {"bilstm_fwd": max(v for k, v in errs.items() if k[1] == "bfloat16"),
              "bilstm_fwd_cluster": max(recur_errs[k] for k in bf16),
              "bilstm_bwd": max(bwd_errs["bilstm_bwd"]),
              "bilstm_bwd_cluster": max(bwd_errs["bilstm_bwd_cluster"]),
              "bilstm_bwd_products": max(products_errs),
              "ctc_alpha": bwd_errs["ctc_alpha"],
              "ctc_beta_post": bwd_errs["ctc_beta_post"],
              "las_decoder_fwd": dec_errs["las_decoder_fwd"],
              "las_decoder_bwd": dec_errs["las_decoder_bwd"],
              **fe_errs, **v1_errs}
    where = {
        "bilstm_fwd": ("bilstm_fwd.cu",
                       "gluon_e2e_asr_tpu/ops/pallas_lstm.py:411",
                       "serving form, sum over the flagship's 3 layer shapes, "
                       "bf16, B=96, 4.0 s; projection_ms: the whole call "
                       "less the recurrence alone"),
        "bilstm_fwd_cluster": (
            "bilstm_fwd.cu",
            "gluon_e2e_asr_tpu/ops/pallas_lstm.py:411",
            "K1-fwd's recurrence alone (fwd_cluster_kernel through "
            "bilstm_fused_fwd_recur_kernel), serving form, sum over the "
            "flagship's 3 layer shapes, bf16, B=96, 4.0 s; launches: "
            "K1-fwd's through the cluster kernel in the slice; plain: "
            "models/lstm.py::bilstm_scan on the same projection; error: max "
            "abs of y against it"),
        "bilstm_bwd": ("bilstm_bwd.cu",
                       "gluon_e2e_asr_tpu/ops/pallas_lstm.py:484",
                       "sum over the flagship's 3 layer shapes, bf16, B=96, "
                       "4.0 s; error: max abs over dx, dW_x, db, dW_h"),
        "bilstm_bwd_cluster": (
            "bilstm_bwd.cu",
            "gluon_e2e_asr_tpu/ops/pallas_lstm.py:484",
            "K1-bwd's reverse recurrence alone (bwd_cluster_kernel through "
            "bilstm_fused_bwd_recur_kernel), sum over the flagship's 3 layer "
            "shapes, bf16, B=96, 4.0 s; launches: K1-bwd's through the "
            "cluster kernel in the slice; plain: ops/bilstm.py::_bwd_sweep "
            "(it also recomputes the gates); error: max abs of dg"),
        "bilstm_bwd_products": (
            "gemm_sm90.cuh",
            "gluon_e2e_asr_tpu/ops/pallas_lstm.py:617",
            "K1-bwd's products alone (dx_kernel, and wgrad_kernel with db, "
            "on wgmma, through bilstm_fused_bwd_products_kernel), "
            "on the reverse recurrence's dg, sum over the flagship's 3 layer "
            "shapes, bf16, B=96, 4.0 s; plain: ops/bilstm.py::"
            "bilstm_fused_bwd_products_plain; library: torch.matmul of dx, "
            "dW_x and the two dW_h on the same bf16-rounded operands (bf16 "
            "out) and torch.sum for db, the casts and h_prev's shift outside "
            "the timing; error: max abs over dx, dW_x, db, dW_h"),
        "ctc_alpha": ("ctc.cu",
                      "gluon_e2e_asr_tpu/ops/pallas_ctc.py:55",
                      "T=100, B=96, S of a 4.0 s training batch; error over "
                      "live cells"),
        "ctc_beta_post": ("ctc.cu",
                          "gluon_e2e_asr_tpu/ops/pallas_ctc.py:81",
                          "T=100, B=96, S of a 4.0 s training batch"),
        "las_decoder_fwd": ("las_decoder.cu",
                            "gluon_e2e_asr_tpu/ops/pallas_decoder.py:161",
                            "dot attention, bf16, B=96, T'=100, L=81 (the 4.0 s "
                            "bucket's label budget + 1); error: logits, coins "
                            "off"),
        "las_decoder_bwd": ("las_decoder.cu",
                            "gluon_e2e_asr_tpu/ops/pallas_decoder.py:462",
                            "as K4-fwd; error: max abs over every cotangent"),
        "frontend_k5": ("frontend.cu",
                        "gluon_e2e_asr_tpu/frontend/pallas_frontend.py:56",
                        "impl pallas, cmvn utterance (milestone 2), eval, B=16, "
                        "4.0 s bucket; error: max abs over every shape, CMVN "
                        "mode, eval and train"),
        "frontend_k6": ("frontend.cu",
                        "gluon_e2e_asr_tpu/frontend/pallas_frontend.py:181",
                        "impl pallas_regrid, as K5"),
        "bilstm_v1_fwd": ("bilstm_fwd.cu",
                          "gluon_e2e_asr_tpu/ops/pallas_lstm.py:77",
                          "the flagship's layer-0 shape, bf16 streams and "
                          "products, B=96, T=398, H=320; error: max abs of h"),
        "bilstm_v1_bwd": ("bilstm_bwd.cu",
                          "gluon_e2e_asr_tpu/ops/pallas_lstm.py:102",
                          "as K7-fwd; error: max abs over d(xg), dW_h"),
    }
    # K4's add and loc modes: one row each, at flagship_bf16's 4.0 s bucket;
    # launches from the loc and add training slices.
    launches = dict(train_counts)
    for m, counts in (("add", add_counts), ("loc", loc_counts)):
        for d, tpu in (("fwd", "gluon_e2e_asr_tpu/ops/pallas_decoder.py:161"),
                       ("bwd", "gluon_e2e_asr_tpu/ops/pallas_decoder.py:462")):
            name = f"las_decoder_{d}_{m}"
            where[name] = ("las_decoder.cu", tpu,
                           f"{m} attention, flagship_bf16, bf16, B=96, T'=100; "
                           "error: " + ("logits" if d == "fwd" else
                                        "max abs over every cotangent") +
                           ", coins off")
            timed[name] = train_ms[name]
            errors[name] = mode_errs[m][f"las_decoder_{d}"]
            launches[name] = counts[name]
    # K5 from the milestone 2 slice, K6 from its pallas_regrid steps, K7
    # from its own path
    launches["frontend_k5"] = m2_counts["frontend_k5"]
    launches["frontend_k6"] = regrid_counts["frontend_k6"]
    for name in ("bilstm_v1_fwd", "bilstm_v1_bwd"):
        launches[name] = v1_counts[name]
    # P1 from its own path, one row per variant
    for v, what in (("l2", "W from L2"), ("cluster", "W resident in a cluster")):
        name = f"pipeline_probe_{v}"
        where[name] = ("pipeline_probe.cu", "tools/pipeline_probe.py:53",
                       f"variant {v} ({what}), M=96, N=1, T=640, f32; "
                       "launches: the probe's sweep at M=96 and 128, N=1..4; "
                       "error: max abs at (M, N) = (96, 2) and (256, 4)")
        timed[name] = probe_ms[v]
        errors[name] = probe_errs[v]
        launches[name] = probe_counts[v]
        lib_ms[name] = probe_lib
    rows = []
    for name, (src, tpu, at) in where.items():
        bound_ms, bound_by = bounds[name]
        rows.append({
            "name": name, "route": "cuda",
            "source": f"gluon_e2e_asr_tpu_torch/csrc/{src}",
            "replaces": tpu,
            "launches": launches[name], "max_abs_err": errors[name],
            "ms": timed[name][0], "plain_ms": timed[name][1],
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms.get(name), "at": at,
            "ctc_only_launches": ctc_counts.get(name, 0)})
        if name in fe_notes:
            rows[-1]["library_note"] = fe_notes[name]
    rows[0]["decode_launches"] = decode_launches
    fwd = rows[0]
    fwd["projection_ms"] = timed["bilstm_fwd"][0] - timed["bilstm_fwd_cluster"][0]
    fwd["projection_bound_ms"], fwd["projection_bound_by"] = \
        bounds["bilstm_fwd_projection"]
    next(r for r in rows if r["name"] == "bilstm_fwd_cluster")[
        "decode_launches"] = cluster_launches
    fwd["projection_library_ms"] = lib_ms["bilstm_fwd_projection"]
    next(r for r in rows if r["name"] == "frontend_k5")["decode_launches"] = \
        m2_decode_counts["frontend_k5"]
    emit({"kernels": rows, "train_step": step_errs,
          "train_step_loc": loc_step_errs,
          "seconds": round(time.perf_counter() - T_START, 1)})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


_BATCH = {}


def bucket_batch(torch, config):
    """The first training batch of the config's longest bucket, 4.0 s
    (unshuffled buckets), or, where its data fill no such batch (the
    location-aware flagship's utterances are all under 2 s), bench.py's
    synthetic batch at that bucket's shape (its seconds and label budget,
    the labels folded into the vocabulary): (batch, tokenizer, encoder
    lengths [B], encoder frames)."""
    key = config.fingerprint()
    if key not in _BATCH:
        from gluon_e2e_asr_tpu_torch.decode import make_eval_loader
        from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
        from gluon_e2e_asr_tpu_torch.training.trainer import (
            build_datasets, build_tokenizer)

        train_utts, _ = build_datasets(config)
        tok = build_tokenizer(config, (u.text for u in train_utts))
        fc = config.frontend
        loader = make_eval_loader(config, train_utts, tok)
        last = len(loader.sampler.specs) - 1
        b = next((x for x in loader.epoch(0) if x.bucket == last), None)
        if b is None:
            spec = loader.sampler.specs[last]
            sb = synth_batch(spec.batch_size, config.data.bucket_bounds_sec[-1],
                             spec.max_labels, SEED)
            sb["labels"] = np.where(sb["labels"] > 0,
                                    4 + sb["labels"] % (tok.vocab_size - 4), 0)
            b = types.SimpleNamespace(**sb, num_real=spec.batch_size,
                                      bucket=last)
        lens = num_frames(torch.from_numpy(b.audio_len), fc.win_length,
                          fc.hop_length)
        T = num_frames(b.audio.shape[1], fc.win_length, fc.hop_length)
        for f in config.model.enc_subsample:
            lens, T = (lens + int(f) - 1) // int(f), -(-T // int(f))
        _BATCH[key] = (b, tok, lens.int(), T)
    return _BATCH[key]


def real_ctc_batch(torch, config, dev):
    """The lattice inputs of K2/K3 for the first 4.0 s training batch of
    the flagship config: its labels and encoder lengths, seeded logits."""
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    b, tok, lens, T = bucket_batch(torch, config)
    rng = np.random.RandomState(SEED)
    logits = torch.from_numpy(
        rng.randn(b.audio.shape[0], T, tok.vocab_size).astype(np.float32) * 3)
    labels = torch.from_numpy(b.labels).to(dev)
    label_lens = torch.from_numpy(b.label_len).to(dev)
    logp = torch.log_softmax(logits.to(dev), -1)
    ext, skip, svalid, tmask = C._lattice(T, lens.to(dev), labels,
                                          label_lens, 0)
    return C._gather_states(logp, ext), tmask, skip, svalid, label_lens


def decoder_case(torch, config, dev, coin_p: float, seed: int = SEED,
                 att_type=None, bench: bool = False):
    """K4's inputs as the hybrid train step gives them at the 4.0 s
    bucket: the batch's teacher-forcing tokens (labels padded to the
    bucket's label budget, L = that + 1) and encoder lengths, a seeded
    encoder output and seeded decoder weights at the config's width
    (``att_type`` overrides its attention), coins [B,L] drawn with
    probability ``coin_p`` (step 0 off). With ``bench``: bench.py's batch
    (B=96, 12.8 s, 96 labels). Returns ((tokens, coins, enc, enc_proj,
    enc_len, weights), the loc filter [w,1,C] or None, the longest label)."""
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
    from gluon_e2e_asr_tpu_torch.models.decoder import AttentionDecoder
    from gluon_e2e_asr_tpu_torch.ops.losses import make_decoder_io

    b, tok, lens, T = bucket_batch(torch, config)
    labels, label_len = b.labels, b.label_len
    mc = copy.deepcopy(config.model)
    mc.att_type = att_type or mc.att_type
    if bench:
        sb = synth_batch(config.data.batch_size, BENCH_SEC, BENCH_LABELS, SEED)
        labels, label_len = sb["labels"], sb["label_len"]
        fc = config.frontend
        lens = num_frames(torch.from_numpy(sb["audio_len"]), fc.win_length,
                          fc.hop_length)
        T = num_frames(sb["audio"].shape[1], fc.win_length, fc.hop_length)
        for f in mc.enc_subsample:
            lens, T = (lens + int(f) - 1) // int(f), -(-T // int(f))
        lens = lens.int()
    rng = np.random.RandomState(seed)
    B = labels.shape[0]
    tokens_in, _, _ = make_decoder_io(torch.from_numpy(labels),
                                      torch.from_numpy(label_len),
                                      tok.sos_id, tok.eos_id)
    L = tokens_in.shape[1]
    coins = rng.rand(B, L) < coin_p
    coins[:, 0] = False
    enc = torch.from_numpy(np.tanh(rng.randn(B, T, 2 * mc.enc_hidden))
                           .astype(np.float32)).to(dev)
    dec = AttentionDecoder(mc, tok.vocab_size, tok.sos_id, tok.eos_id)
    dec.reset_parameters(torch.Generator().manual_seed(seed))
    dec.to(dev)
    with torch.no_grad():
        enc_proj = dec.precompute(enc)
        w = type(dec.weights())(*(t.detach() for t in dec.weights()))
    filt = dec.loc_filter.detach() if mc.att_type == "loc" else None
    return ((tokens_in.to(dev), torch.from_numpy(coins).to(dev), enc, enc_proj,
             lens.to(dev), w), filt, int(label_len.max()))


def decoder_grads(torch, LD, streams, resid, dl, w, filt, T):
    """Every cotangent of one K4-bwd (kernel or plain) call: the streams'
    products, d_enc_proj, d_att_v, d_loc_proj and the filter's gradient
    through the band (autograd through build_loc_band_cmajor)."""
    g = dict(LD.weight_grads(streams, resid, dl, w), enc_proj=streams["d_encp"])
    if streams["d_att_v"] is not None:
        g["att_v"] = streams["d_att_v"]
    if filt is not None:
        g["loc_proj"] = streams["d_loc_proj"]
        f = filt.detach().clone().requires_grad_(True)
        with torch.enable_grad():
            (g["loc_filter"],) = torch.autograd.grad(
                LD.build_loc_band_cmajor(f, T), f, g.pop("band"))
    return g


def check_decoder_kernels(torch, config, dev, kind="dot", cases=None):
    """Phase 3, K4 in mode ``kind``: K4-fwd (logits and residuals) and
    K4-bwd (every cotangent) against the plain versions. ``cases``: (dtype,
    coin probability, bench shape) triples; by default f32 and bf16 with
    the coins off and at the config's scheduled-sampling rate, at the 4.0 s
    bucket. Returns the max abs errors of the bf16, coins-off case at the
    4.0 s bucket."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD

    errs = {"las_decoder_fwd": 0.0, "las_decoder_bwd": 0.0}
    if cases is None:
        cases = [(cd, p, False) for cd in ("float32", "bfloat16")
                 for p in (0.0, config.loss.scheduled_sampling)]
    for cd_name, coin_p, bench in cases:
        cd = getattr(torch, cd_name)
        tol = TOL_DEC[cd_name]
        args, filt, longest = decoder_case(torch, config, dev, coin_p,
                                           att_type=kind, bench=bench)
        tokens, coins, enc, enc_proj, enc_len, w = args
        T = enc.shape[1]
        band = None if filt is None else LD.build_loc_band_cmajor(filt, T)
        logits, resid, extras = LD.las_decoder_fwd_kernel(*args, cd, kind, filt)
        ref, ref_resid = LD.las_decoder_fwd_plain(*args, cd, kind, band)
        torch.cuda.synchronize()
        same = (resid[4].long() == ref_resid[4].long()).all(1)
        share = float(same.float().mean())
        need = 1.0 if cd_name == "float32" or coin_p == 0.0 \
            else MIN_ROWS_AGREE_BF16
        check(share >= need,
              f"las_decoder_fwd ({kind}) fed back other tokens: {share} of "
              f"rows agree ({cd_name}, coins {coin_p})")
        fwd = {name: rel_err(a[same], r[same]) for name, a, r in zip(
            ("logits", "h", "c", "att", "ctx"), (logits, *resid[:4]),
            (ref, *ref_resid[:4]))}
        B, L = tokens.shape
        V = w.embed.shape[0]
        dl = torch.from_numpy(np.random.RandomState(SEED + 7).randn(B, L, V)
                              .astype(np.float32) * 0.05).to(dev)
        got = LD.las_decoder_bwd_kernel(dl, resid, extras, enc, enc_proj,
                                        enc_len, w, cd, kind, filt)
        want = LD.las_decoder_bwd_plain(dl, resid, enc, enc_proj, enc_len,
                                        w, cd, kind, band)
        gk = decoder_grads(torch, LD, got, resid, dl, w, filt, T)
        gp = decoder_grads(torch, LD, want, resid, dl, w, filt, T)
        torch.cuda.synchronize()
        bwd = {k: rel_err(gk[k], gp[k]) for k in gp}
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(v).all()) for v in gk.values())
        emit({"phase": "kernel_check", "kernel": "las_decoder_fwd+bwd",
              "att_type": kind, "B": B, "L": L, "T": T,
              "longest_label": longest, "shape": "bench.py" if bench
              else "4.0 s bucket", "compute_dtype": cd_name, "coin_p": coin_p,
              "rows_tokens_agree": share, "fwd_rel_err": fwd,
              "bwd_rel_err": bwd, "tol_rel": tol, "finite": finite})
        check(finite, f"las_decoder ({kind}) non-finite output ({cd_name})")
        check(max(fwd.values()) <= tol,
              f"las_decoder_fwd ({kind}) disagrees with its plain version "
              f"({cd_name}, coins {coin_p}): {fwd}")
        check(max(bwd.values()) <= tol,
              f"las_decoder_bwd ({kind}) disagrees with its plain version "
              f"({cd_name}, coins {coin_p}): {bwd}")
        if cd_name == "bfloat16" and coin_p == 0.0 and not bench:
            errs["las_decoder_fwd"] = float((logits - ref).abs().max())
            errs["las_decoder_bwd"] = max(
                float((gk[k] - gp[k]).abs().max()) for k in bwd)
    return errs


def frontend_cases(m2_config, config):
    """(name, frontend config, batch, seconds): the shapes K5 and K6 are
    held and timed at: milestone 2's two buckets (B=16), the flagship's
    4.0 s bucket (B=96) and bench.py's shape (B=96, 12.8 s)."""
    return [("milestone2 2.0 s", m2_config.frontend, 16, 2.0),
            ("milestone2 4.0 s", m2_config.frontend, 16, 4.0),
            ("flagship 4.0 s", config.frontend, 96, BUCKET_SEC),
            ("bench.py", config.frontend, 96, BENCH_SEC)]


def frontend_audio(torch, batch, seconds, dev):
    """bench.py's seeded batch (rows from half to all of ``seconds``)."""
    sb = synth_batch(batch, seconds, 1, SEED)
    return (torch.from_numpy(sb["audio"]).to(dev),
            torch.from_numpy(sb["audio_len"]).to(dev))


def batch_cmvn_stats(torch, fc, audio, audio_len):
    """Global CMVN stats from the batch itself: (mean, std) of the raw
    log-mel over every valid frame (the JAX compute_global_cmvn)."""
    from gluon_e2e_asr_tpu_torch.frontend.features import (
        log_mel_spectrogram, num_frames)

    raw = log_mel_spectrogram(audio, fc)
    flen = num_frames(audio_len, fc.win_length, fc.hop_length)
    mask = (torch.arange(raw.shape[1], device=raw.device)[None, :]
            < flen[:, None]).float()[..., None]
    n = mask.sum().clamp(min=1.0)
    mean = (raw * mask).sum((0, 1)) / n
    var = ((raw - mean) ** 2 * mask).sum((0, 1)) / n
    return mean, torch.sqrt(var + 1e-10)


def masked_cells(torch, fc, feat_len, F, draws):
    """[B,F,M] bool: the cells the frontend must zero, frames at or past
    feat_len and, with ``draws``, SpecAugment's masks. (Elsewhere a value
    may be 0 in one version only: a global-CMVN cell whose log-mel equals
    the mean to the last bit in one and not the other.)"""
    from gluon_e2e_asr_tpu_torch.frontend.features import spec_augment

    B = feat_len.shape[0]
    keep = (torch.arange(F, device=feat_len.device)[None, :]
            < feat_len[:, None])[..., None].expand(B, F, fc.n_mels).float()
    if draws is not None:
        keep = spec_augment(keep, feat_len, draws, fc.specaug_time_width)
    return keep == 0


def check_frontend_kernels(torch, m2_config, config, dev):
    """Phase 3, K5 and K6 against their plain versions at every shape of
    frontend_cases, each CMVN mode (utterance, global with the batch's
    own stats, none), eval and train (the same SpecAugment draws on both
    sides), rows of different lengths: |kernel - plain| within TOL_FE
    and the masked cells exactly 0 in both. Returns each kernel's max abs
    error over all of them."""
    from gluon_e2e_asr_tpu_torch.frontend import fused as FE
    from gluon_e2e_asr_tpu_torch.frontend.features import (
        draw_spec_augment, num_frames)

    errs = {"frontend_k5": 0.0, "frontend_k6": 0.0}
    pairs = {"frontend_k5": (FE.compute_features_pallas_kernel,
                             FE.compute_features_pallas_plain),
             "frontend_k6": (FE.compute_features_pallas_regrid_kernel,
                             FE.compute_features_pallas_regrid_plain)}
    for case, fc0, B, sec in frontend_cases(m2_config, config):
        audio, alen = frontend_audio(torch, B, sec, dev)
        F = num_frames(audio.shape[1], fc0.win_length, fc0.hop_length)
        rec = {"phase": "kernel_check", "kernel": "frontend_k5+frontend_k6",
               "shape": case, "B": B, "samples": int(audio.shape[1]), "F": F,
               "tol": {"rtol": TOL_FE_RTOL, "atol": TOL_FE_ATOL}, "cases": []}
        for cmvn in ("utterance", "global", "none"):
            fc = copy.deepcopy(fc0)
            fc.cmvn = cmvn
            stats = batch_cmvn_stats(torch, fc, audio, alen) \
                if cmvn == "global" else None
            for train in (False, True):
                draws = draw_spec_augment(
                    fc, B, F, torch.Generator().manual_seed(SEED), dev) \
                    if train else None
                for name, (kernel, plain) in pairs.items():
                    kw = dict(train=train, spec_draws=draws, cmvn_stats=stats)
                    got, got_len = kernel(fc, audio, alen, **kw)
                    ref, ref_len = plain(fc, audio, alen, **kw)
                    torch.cuda.synchronize()
                    diff = (got - ref).abs()
                    over = float((diff - TOL_FE_RTOL * ref.abs()).max())
                    mask = masked_cells(torch, fc, ref_len, F, draws)
                    zeros = not bool(got[mask].any() or ref[mask].any())
                    err = float(diff.max())
                    errs[name] = max(errs[name], err)
                    rec["cases"].append({
                        "kernel": name, "cmvn": cmvn, "train": train,
                        "max_abs_err": err, "masked_cells_zero": zeros,
                        "masked_share": float(mask.float().mean())})
                    check(bool(torch.isfinite(got).all()) and zeros
                          and over <= TOL_FE_ATOL
                          and torch.equal(got_len, ref_len),
                          f"{name} disagrees with its plain version at {case}, "
                          f"cmvn {cmvn}, train {train}: max abs {err}, masked "
                          f"cells zero {zeros}")
        emit(rec)
    return errs


def v1_case(torch, config, shape, dev, cd_name):
    """K7's inputs at one layer shape of ``config``: the projections of
    layer_inputs (x . w_x + b_x, split by direction) in the stream dtype
    ``cd_name``, lens, W_h, and a seeded cotangent."""
    layer, T, D = shape
    H, B = config.model.enc_hidden, config.data.batch_size
    x, lens, w_x, b_x, w_hf, w_hb = layer_inputs(torch, B, T, D, H, layer, dev)
    cd = getattr(torch, cd_name)
    xg = torch.matmul(x, w_x) + b_x
    xg_f = xg[..., :4 * H].contiguous().to(cd)
    xg_b = xg[..., 4 * H:].contiguous().to(cd)
    dy = layer_cotangent(torch, B, T, H, layer, dev).to(cd)
    return (xg_f, xg_b, lens, w_hf, w_hb), dy, cd


def check_v1_kernels(torch, config, shape, dev):
    """Phase 3, K7-fwd (h and c streams) and K7-bwd (d(xg) of both
    directions, dW_h of both) against their plain versions at the
    flagship's layer-0 shape, f32 and bf16. Returns the bf16 max abs
    errors."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    errs = {}
    for cd_name in ("float32", "bfloat16"):
        args, dy, cd = v1_case(torch, config, shape, dev, cd_name)
        y, c, acts = K.bilstm_pallas_kernel(*args, cd, with_cell=True)
        yp, cp = K.bilstm_pallas_plain(*args, cd, with_cell=True)
        got = K.bilstm_pallas_bwd_kernel(args[2], args[3], args[4], y, c, acts,
                                         dy, cd, cd)
        ref = K.bilstm_pallas_bwd_plain(*args, yp, cp, dy, cd)
        torch.cuda.synchronize()
        outs = {"h": (y, yp), "c": (c, cp)}
        outs.update(zip(("dxg_f", "dxg_b", "dw_hf", "dw_hb"), zip(got, ref)))
        rel = {k: rel_err(a.float(), b.float()) for k, (a, b) in outs.items()}
        absd = {k: float((a.float() - b.float()).abs().max())
                for k, (a, b) in outs.items()}
        finite = all(bool(torch.isfinite(a).all()) for a, _ in outs.values())
        emit({"phase": "kernel_check", "kernel": "bilstm_v1_fwd+bwd",
              "B": int(y.shape[0]), "T": int(y.shape[1]),
              "H": int(y.shape[2] // 2), "dtype": cd_name, "rel_err": rel,
              "max_abs_err": absd, "tol_rel": TOL_V1[cd_name],
              "finite": finite})
        check(finite and max(rel.values()) <= TOL_V1[cd_name],
              f"bilstm_v1 disagrees with its plain version ({cd_name}): {rel}")
        if cd_name == "bfloat16":
            errs["bilstm_v1_fwd"] = absd["h"]
            errs["bilstm_v1_bwd"] = max(absd[k] for k in
                                        ("dxg_f", "dxg_b", "dw_hf", "dw_hb"))
    return errs


def v1_path(torch, shape, config, dev):
    """K7's own path (as in JAX, no model calls the v1 layer): the public
    ``bilstm_pallas`` forward and, through autograd, backward at the
    flagship's layer-0 shape in bf16, the counts reset just before and read
    just after: one launch of each kernel, no plain call, finite
    gradients."""
    from gluon_e2e_asr_tpu_torch.ops.bilstm import bilstm_pallas

    args, dy, cd = v1_case(torch, config, shape, dev, "bfloat16")
    xg_f, xg_b, lens, w_hf, w_hb = args
    leaves = [t.detach().requires_grad_(True) for t in (xg_f, xg_b, w_hf, w_hb)]
    reset_counts()
    out = bilstm_pallas(leaves[0], leaves[1], lens, leaves[2], leaves[3], cd)
    out.backward(dy)
    torch.cuda.synchronize()
    launches, plain = read_counts()
    finite = bool(torch.isfinite(out).all()) and all(
        bool(torch.isfinite(t.grad).all()) for t in leaves)
    emit({"phase": "v1_path", "B": int(out.shape[0]), "T": int(out.shape[1]),
          "out_dtype": str(out.dtype), "launches": launches,
          "plain_calls": plain, "finite": finite})
    check(launches["bilstm_v1_fwd"] == 1 and launches["bilstm_v1_bwd"] == 1
          and launches["bilstm_v1_fwd_cluster"] == 1
          and launches["bilstm_v1_bwd_cluster"] == 1,
          f"the v1 path launched {launches}")
    check(not any(plain.values()), f"plain versions ran on the v1 path: {plain}")
    check(finite and out.dtype == cd, "the v1 path's output or gradients")
    return launches


def decode_slice(torch, trainer, path, name):
    """A greedy decode of the last checkpoint of ``trainer``'s run (of the
    config at ``path``, in OUT_DIR/``name``) through the decode CLI on the
    card: the frontend kernel of its config on every batch (and warm
    pass), no plain version, a hypothesis per dev utterance."""
    from gluon_e2e_asr_tpu_torch import decode

    config, steps = trainer.config, trainer.state.step
    workdir = os.path.join(OUT_DIR, name)
    ckpt = os.path.join(workdir, config.train.ckpt_dir, f"ckpt_{steps}.pt")
    out = os.path.join(workdir, "decode.jsonl")
    impl = config.frontend.impl
    reset_counts()
    result = decode.main(["--config", path, "--ckpt", ckpt,
                          "--method", "greedy", "--output", out,
                          "--device", "cuda"])
    launches, plain = read_counts()
    with open(out) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    batches = result["num_batches"] + result["warm_passes"]
    emit({"phase": "decode_slice", "config": os.path.relpath(path, REPO),
          "checkpoint": os.path.relpath(ckpt, REPO), "frontend_impl": impl,
          "decode_done": result, "launches": launches, "plain_calls": plain,
          "records": len(recs)})
    key = {"pallas": "frontend_k5", "pallas_regrid": "frontend_k6"}[impl]
    check(launches[key] == batches,
          f"{key} launched {launches[key]} times in the decode, expected {batches}")
    check(launches["bilstm_fwd"] == config.model.enc_layers * batches,
          f"bilstm_fwd launched {launches['bilstm_fwd']} times in the decode")
    check(launches["bilstm_fwd_cluster"] == launches["bilstm_fwd"],
          "a bilstm_fwd launch of the decode missed the cluster recurrence")
    check(not any(plain.values()), f"plain versions ran in the decode: {plain}")
    check(result["num_utts"] == len(recs) > 0
          and all(isinstance(r["hyp"], str) for r in recs),
          "the decode wrote no hypothesis per utterance")
    return launches


def golden_greedy(torch, impl="pallas"):
    """The blessed tiny golden decoded greedily on the card with
    ``frontend.impl`` ``impl`` (K5): every hypothesis of
    golden_greedy.jsonl."""
    from gluon_e2e_asr_tpu_torch import decode
    from gluon_e2e_asr_tpu_torch.bridge import params_from_jax, read_jax_checkpoint
    from gluon_e2e_asr_tpu_torch.training.checkpoint import save_checkpoint

    params, cmvn, meta = read_jax_checkpoint(
        os.path.join(GOLD, "tiny_golden.msgpack"))
    ckpt = save_checkpoint(os.path.join(OUT_DIR, "golden_greedy.pt"),
                           params_from_jax(params), meta, cmvn)
    out = os.path.join(OUT_DIR, f"golden_greedy_{impl}.jsonl")
    reset_counts()
    result = decode.main(["--config", os.path.join(GOLD, "tiny_golden.yaml"),
                          "--ckpt", ckpt, "--method", "greedy", "--output", out,
                          "--set", f"frontend.impl={impl}", "--device", "cuda"])
    launches, plain = read_counts()

    def hyps(path):
        with open(path) as f:
            return {r["utt_id"]: r["hyp"] for r in map(json.loads, f)}

    gold, got = hyps(os.path.join(GOLD, "golden_greedy.jsonl")), hyps(out)
    same = [u for u in gold if got.get(u) == gold[u]]
    emit({"phase": "golden_greedy", "frontend_impl": impl,
          "decode_done": result, "hypotheses": len(gold),
          "identical": len(same), "launches": launches, "plain_calls": plain})
    check(len(got) == len(gold) == len(same) == 16,
          f"golden greedy ({impl}): {len(same)} of {len(gold)} identical")
    check(launches["frontend_k5"] > 0 and not any(plain.values()),
          f"golden greedy ({impl}): launches {launches}, plain {plain}")


def check_training_kernels(torch, config, shapes, dev, m2_config):
    """Phase 3, the training kernels: K1-fwd's training form and K1-bwd at
    the flagship's layer shapes (B=96, H=320), at milestone 2's (B=16,
    H=256) and at the flagship's last layer with B=50 (a partial group of
    rows in the cluster recurrences) and B=1 (serving's batch), K1-fwd's
    serving form too where phase 3's first loop does not take it, every
    K1-fwd and K1-bwd launch through its cluster kernel, and at the flagship's shapes the recurrence alone
    against the plain sweep's dg; K2 and K3 on a real batch's lattice."""
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    H, B = config.model.enc_hidden, config.data.batch_size
    fc = m2_config.frontend
    m2_T = num_frames(int(BUCKET_SEC * fc.sample_rate), fc.win_length,
                      fc.hop_length)
    cases = [("flagship", B, H, shape) for shape in shapes]
    cases += [("milestone2", m2_config.data.batch_size,
               m2_config.model.enc_hidden, shape)
              for shape in layer_shapes(m2_config, m2_T)]
    cases.append(("flagship, B=50", 50, H, shapes[-1]))
    cases.append(("flagship, B=1", 1, H, shapes[-1]))
    errs = {"bilstm_bwd": [], "bilstm_bwd_cluster": []}
    for name, Bc, Hc, (layer, T, D) in cases:
        args = layer_inputs(torch, Bc, T, D, Hc, layer, dev)
        dy = layer_cotangent(torch, Bc, T, Hc, layer, dev)
        x, lens, w_x, b_x, w_hf, w_hb = args
        for cd_name in ("float32", "bfloat16"):
            cd = getattr(torch, cd_name)
            n_fwd = K.bilstm_fused_kernel.cluster_launches
            y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                               with_cell=True)
            # the serving form where phase 3's first loop does not take it
            ys = (None if name == "flagship" else
                  K.bilstm_fused_kernel(*args, compute_dtype=cd))
            yp, cp = K.bilstm_fused_plain(*args, compute_dtype=cd,
                                          with_cell=True)
            torch.cuda.synchronize()
            fwd_cluster = K.bilstm_fused_kernel.cluster_launches - n_fwd
            y_err, c_err = float((y - yp).abs().max()), rel_err(c, cp)
            ys_err = None if ys is None else float((ys - yp).abs().max())
            emit({"phase": "kernel_check", "kernel": "bilstm_fwd",
                  "form": "training", "shapes": name, "layer": layer,
                  "B": Bc, "T": T, "D": D, "H": Hc,
                  "compute_dtype": cd_name, "h_max_abs_err": y_err,
                  "c_max_rel_err": c_err, "serving_h_max_abs_err": ys_err,
                  "cluster_launches": fwd_cluster, "tol_h": TOL[cd_name],
                  "tol_c_rel": TOL_BWD[cd_name]})
            check(y_err <= TOL[cd_name] and c_err <= TOL_BWD[cd_name]
                  and bool(torch.isfinite(y).all()),
                  f"bilstm_fwd training form disagrees at {name} layer "
                  f"{layer} {cd_name}: h {y_err}, c {c_err}")
            check(ys is None or (ys_err <= TOL[cd_name]
                                 and bool(torch.isfinite(ys).all())),
                  f"bilstm_fwd serving form disagrees at {name} layer "
                  f"{layer} {cd_name}: h {ys_err}")
            check(fwd_cluster == (1 if ys is None else 2),
                  f"bilstm_fwd at {name} layer {layer} did not go through "
                  "the cluster recurrence")
            n_cluster = K.bilstm_fused_bwd_kernel.cluster_launches
            got = K.bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, c,
                                            acts, dy, compute_dtype=cd)
            ref = K.bilstm_fused_bwd_plain(x, lens, w_x, b_x, w_hf, w_hb, y,
                                           c, dy, compute_dtype=cd)
            torch.cuda.synchronize()
            cluster = K.bilstm_fused_bwd_kernel.cluster_launches - n_cluster
            rec = {"phase": "kernel_check", "kernel": "bilstm_bwd",
                   "shapes": name, "layer": layer, "B": Bc, "T": T, "D": D,
                   "H": Hc, "compute_dtype": cd_name,
                   "cluster_launches": cluster, "tol_rel": TOL_BWD[cd_name]}
            check(cluster == 1, f"bilstm_bwd at {name} layer {layer} did not "
                                "go through the cluster recurrence")
            for out, g, r in zip(("dx", "dw_x", "db", "dw_hf", "dw_hb"),
                                 got, ref):
                rec[out] = {"max_abs_err": float((g - r).abs().max()),
                            "rel_err": rel_err(g, r),
                            "max_abs": float(r.abs().max())}
                check(bool(torch.isfinite(g).all())
                      and rel_err(g, r) <= TOL_BWD[cd_name],
                      f"bilstm_bwd {out} disagrees with its plain version "
                      f"at {name} layer {layer} {cd_name}: {rel_err(g, r)}")
                if cd_name == "bfloat16" and name == "flagship":
                    errs["bilstm_bwd"].append(rec[out]["max_abs_err"])
            if name == "flagship":
                dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts,
                                                     dy, cd)
                xg = torch.cat(K._project(x, lens, w_x, b_x, cd, False), -1)
                dg_ref = K._bwd_sweep(xg, lens, w_hf, w_hb, y, c, dy, cd)
                torch.cuda.synchronize()
                rec["dg"] = {"max_abs_err": float((dg - dg_ref).abs().max()),
                             "rel_err": rel_err(dg, dg_ref)}
                check(bool(torch.isfinite(dg).all())
                      and rel_err(dg, dg_ref) <= TOL_BWD[cd_name],
                      f"the K1-bwd recurrence's dg disagrees with the plain "
                      f"sweep at layer {layer} {cd_name}: {rel_err(dg, dg_ref)}")
                if cd_name == "bfloat16":
                    errs["bilstm_bwd_cluster"].append(rec["dg"]["max_abs_err"])
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


def products_cases(config, shapes, m2_config):
    """The products' shapes: (name, B, H, layer, T, D, every length 1) at
    the flagship's 3 layers (the 4.0 s bucket), milestone 2's, and
    PRODUCTS_RAGGED."""
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames

    fc = m2_config.frontend
    m2_T = num_frames(int(BUCKET_SEC * fc.sample_rate), fc.win_length,
                      fc.hop_length)
    H, B = config.model.enc_hidden, config.data.batch_size
    cases = [("flagship", B, H, layer, T, D, False) for layer, T, D in shapes]
    cases += [("milestone2", m2_config.data.batch_size,
               m2_config.model.enc_hidden, layer, T, D, False)
              for layer, T, D in layer_shapes(m2_config, m2_T)]
    cases += [(name, Bc, Hc, 0, T, D, ones)
              for name, Bc, T, D, Hc, ones in PRODUCTS_RAGGED]
    return cases


def products_inputs(torch, Bc, Hc, layer, T, D, ones, dev):
    """A layer's x, lens, w_x and K1-fwd's h stream y (bf16 products, the
    training form), and the reverse recurrence's dg on them: the products'
    inputs as the training path hands them over."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args = layer_inputs(torch, Bc, T, D, Hc, layer, dev)
    x, lens, w_x, b_x, w_hf, w_hb = args
    if ones:
        lens = torch.ones_like(lens)
        args = (x, lens, w_x, b_x, w_hf, w_hb)
    dy = layer_cotangent(torch, Bc, T, Hc, layer, dev)
    bf = torch.bfloat16
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=bf, with_cell=True)
    dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy, bf)
    return x, lens, w_x, y, dg


def check_products_kernels(torch, config, shapes, dev, m2_config):
    """Phase 3, K1-bwd's products through their own entry
    (``bilstm_fused_bwd_products_kernel``: bf16 on wgmma) against their
    plain twin on the same dg, at the flagship's 3 layer shapes,
    milestone 2's and PRODUCTS_RAGGED, within TOL_PRODUCTS; dx exactly 0
    past each row's length. Returns the max abs errors at the flagship's
    shapes."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    bf = torch.bfloat16
    errs = []
    for name, Bc, Hc, layer, T, D, ones in products_cases(config, shapes,
                                                          m2_config):
        x, lens, w_x, y, dg = products_inputs(torch, Bc, Hc, layer, T, D,
                                              ones, dev)
        n = K.bilstm_fused_bwd_products_kernel.launches
        got = K.bilstm_fused_bwd_products_kernel(x, lens, w_x, y, dg, bf)
        ref = K.bilstm_fused_bwd_products_plain(x, lens, w_x, y, dg, bf)
        torch.cuda.synchronize()
        past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
        rec = {"phase": "kernel_check", "kernel": "bilstm_bwd_products",
               "shapes": name, "layer": layer, "B": Bc, "T": T, "D": D,
               "H": Hc, "compute_dtype": "bfloat16",
               "launches": K.bilstm_fused_bwd_products_kernel.launches - n,
               "dx_zero_past_lens": not bool(got[0][past].any()),
               "tol_rel": TOL_PRODUCTS}
        for out, g, r in zip(("dx", "dw_x", "db", "dw_hf", "dw_hb"), got, ref):
            rec[out] = {"max_abs_err": float((g - r).abs().max()),
                        "rel_err": rel_err(g, r),
                        "max_abs": float(r.abs().max())}
            check(bool(torch.isfinite(g).all())
                  and rel_err(g, r) <= TOL_PRODUCTS,
                  f"bilstm_bwd_products {out} disagrees with its plain twin "
                  f"at {name} layer {layer}: {rel_err(g, r)}")
            if name == "flagship":
                errs.append(rec[out]["max_abs_err"])
        emit(rec)
        check(rec["launches"] == 1 and rec["dx_zero_past_lens"],
              f"bilstm_bwd_products at {name} layer {layer}: {rec}")
        del x, lens, w_x, y, dg, got, ref
    return errs


def products_timing(torch, config, shapes, dev, card, m2_config):
    """Phase 8 for K1-bwd's products through their own entry, bf16, at the
    flagship's 3 layer shapes and milestone 2's: the kernel, its plain
    twin and cuBLAS (``tools/k1b_probe.py::products_library``) on the
    same inputs, and the kernel's TFLOP/s over the live frames. Returns
    ((kernel ms, plain ms), cuBLAS ms), each summed over the flagship's
    layers."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.tools.k1b_probe import (
        products_library, products_work)

    bf = torch.bfloat16
    sums = [0.0, 0.0, 0.0]
    for name, Bc, Hc, layer, T, D, ones in products_cases(config, shapes,
                                                          m2_config):
        if name not in ("flagship", "milestone2") or (
                name == "milestone2" and layer > 0):
            continue
        x, lens, w_x, y, dg = products_inputs(torch, Bc, Hc, layer, T, D,
                                              ones, dev)
        k_ms = time_ms(torch, lambda: K.bilstm_fused_bwd_products_kernel(
            x, lens, w_x, y, dg, bf))
        p_ms = time_ms(torch, lambda: K.bilstm_fused_bwd_products_plain(
            x, lens, w_x, y, dg, bf), n=5, warm=1)
        l_ms = time_ms(torch, products_library(x, w_x, y, dg))
        lens_h = lens.cpu().tolist()
        live_ops, _ = products_work(lens_h, T, D, Hc)
        all_ops, _ = products_work([T] * Bc, T, D, Hc)
        frames = float(sum(lens_h))
        emit({"phase": "timing", "what": "bilstm_bwd_products",
              "shapes": name, "layer": layer, "B": Bc, "T": T, "D": D,
              "H": Hc, "compute_dtype": "bfloat16", "kernel_ms": k_ms,
              "plain_ms": p_ms, "plain_runs": 5, "library_ms": l_ms,
              "kernel_tflops_live": live_ops / k_ms / 1e9,
              "library_tflops_all_rows": all_ops / l_ms / 1e9,
              "live_frames": frames, "card": card})
        if name == "flagship":
            sums[0] += k_ms
            sums[1] += p_ms
            sums[2] += l_ms
        del x, lens, w_x, y, dg
    return (sums[0], sums[1]), sums[2]


def epoch_steps(config, epochs: int) -> int:
    """The train steps of the first ``epochs`` epochs of ``config``, as the
    trainer's sampler deals them."""
    from gluon_e2e_asr_tpu_torch.data.sampler import BucketSampler, make_bucket_specs
    from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets

    dc, tc = config.data, config.train
    specs = make_bucket_specs(dc.bucket_bounds_sec, dc.sample_rate,
                              dc.batch_size, dc.max_label_len,
                              config.frontend.hop_length, dc.dynamic_batch)
    sampler = BucketSampler(
        build_datasets(config)[0], specs, dc.sample_rate, seed=tc.seed,
        shuffle=dc.shuffle, drop_last=dc.drop_last,
        sortagrad_epochs=dc.sortagrad_epochs,
        speed_perturb=tuple(dc.speed_perturb or ()), perturb_seed=tc.seed,
        static_placement=dc.static_placement)
    return sum(len(list(sampler.epoch_batches(e))) for e in range(epochs))


def train_slice(torch, path, name, steps=None, extra=(), ctc_only=False,
                falls=True):
    """Phase 6: the training CLI at full width on the config at ``path``
    as shipped (only ``train.dp=false`` and a train line every step, and
    ``extra`` overrides), for ``steps`` steps or TRAIN_EPOCHS epochs:
    every kernel of the path launched (K4 in the config's attention mode
    on every step) and no plain version; with ``ctc_only``,
    ``loss.mtl_alpha=1.0`` and a greedy dev evaluation (a model without a
    decoder has no beam), and K4 not launched. Each epoch's dev evaluation
    decodes as the config's ``decode.method`` says. The frontend kernel
    of the config's ``frontend.impl`` (K5 for pallas, K6 for
    pallas_regrid, none for jnp) runs on every step and dev batch. With
    ``falls``, the loss must fall."""
    from gluon_e2e_asr_tpu_torch import train
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
    from gluon_e2e_asr_tpu_torch.ops import bilstm

    extra = list(extra)
    if ctc_only:
        extra += ["--set", "loss.mtl_alpha=1.0", "--set", "decode.method=greedy"]
    config = load_config(path)
    apply_overrides(config, extra[1::2])
    if steps is None:
        steps = epoch_steps(config, TRAIN_EPOCHS)
    workdir = os.path.join(OUT_DIR, name)
    shutil.rmtree(workdir, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    trainer = train.main([
        "--config", path, "--set", "train.dp=false",
        "--set", "train.log_every_steps=1", *extra,
        "--max-steps", str(steps), "--workdir", workdir, "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    train_lines = [r for r in lines if r["event"] == "train"]
    losses = [r["loss"] for r in train_lines]
    epochs = [r for r in lines if r["event"] == "epoch"]
    dev_batches = len(list(trainer.dev_loader.sampler.epoch_batches(0)))
    layers = config.model.enc_layers
    kind = None if ctc_only else config.model.att_type
    dec = 0 if ctc_only else steps
    # every K1-fwd and K1-bwd launch through its cluster recurrence
    # (H <= 320 in every config of the repo)
    cluster = config.model.enc_hidden <= bilstm.CLUSTER_MAX_HIDDEN
    fwd = layers * (steps + dev_batches * len(epochs))
    expect = {"bilstm_fwd": fwd, "bilstm_fwd_cluster": fwd * cluster,
              "bilstm_bwd": layers * steps,
              "bilstm_bwd_cluster": layers * steps * cluster,
              "bilstm_bwd_products": layers * steps,
              "bilstm_v1_fwd_cluster": 0, "bilstm_v1_bwd_cluster": 0,
              "ctc_alpha": steps, "ctc_beta_post": steps,
              "las_decoder_fwd": dec, "las_decoder_bwd": dec}
    for k in ("las_decoder_fwd", "las_decoder_bwd"):
        for m in ATT_MODES:
            expect[f"{k}_{m}"] = dec if m == kind else 0
    fe = steps + dev_batches * len(epochs)
    impl = config.frontend.impl
    expect.update(frontend_k5=fe if impl == "pallas" else 0,
                  frontend_k6=fe if impl == "pallas_regrid" else 0,
                  bilstm_v1_fwd=0, bilstm_v1_bwd=0)
    ckpt = os.path.join(workdir, config.train.ckpt_dir, f"ckpt_{steps}.pt")
    k = min(5, max(1, steps // 2))
    first, last = float(np.mean(losses[:k])), float(np.mean(losses[-k:]))
    dc = trainer.config.decode
    evaluation = ({"method": dc.method, "beam_size": dc.beam_size,
                   "ctc_weight": dc.ctc_weight} if trainer._beam is not None
                  else {"method": "greedy"})
    emit({"phase": "train_slice", "config": os.path.relpath(path, REPO),
          "name": name, "objective": "ctc" if ctc_only else "hybrid",
          "frontend_impl": impl,
          "att_type": kind, "mtl_alpha": trainer.config.loss.mtl_alpha,
          "scheduled_sampling": trainer.config.loss.scheduled_sampling,
          "steps": trainer.state.step,
          "wall_s": round(wall, 2), "launches": launches,
          "expected_launches": expect, "plain_calls": plain,
          "dev_evaluation": evaluation,
          "epochs": [{k_: r[k_] for k_ in ("epoch", "step", "dev_wer",
                                           "dev_cer", "epoch_time_s",
                                           "utt_per_sec_per_chip")}
                     for r in epochs],
          "dev_batches_per_eval": dev_batches, "losses": losses,
          "loss_att": [r["loss_att"] for r in train_lines],
          "att_acc": [r["att_acc"] for r in train_lines],
          f"loss_first{k}": first, f"loss_last{k}": last,
          "checkpoint": os.path.relpath(ckpt, REPO),
          "note": "random init: the WER means nothing"})
    check(trainer.state.step == steps == len(losses),
          f"trained {trainer.state.step} steps, logged {len(losses)}")
    check(launches == expect, f"training launches {launches}, expected {expect}")
    check(not any(plain.values()), f"plain versions ran in training: {plain}")
    check(all(np.isfinite(losses)), f"non-finite loss: {losses}")
    check(last < first or not falls,
          f"the loss did not fall: first {first}, last {last}")
    if not ctc_only:
        check(all(r["loss_att"] > 0 and 0.0 <= r["att_acc"] <= 1.0
                  for r in train_lines), "loss_att / att_acc not logged")
    check(all("dev_wer" in r and "dev_cer" in r for r in epochs),
          "an epoch line without dev_wer / dev_cer")
    check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
    return trainer, launches


def train_reference(torch, trainer, dev):
    """Phase 7: one hybrid step of the trained model through the kernels
    and through the plain versions on the card, from the same state."""
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training.train_step import (
        TrainState, batch_to_device, make_train_step)

    # Scheduled sampling off: with it on, a bf16 rounding flip can change
    # an argmax and with it the decoder's later inputs (phase 3 covers it).
    config = copy.deepcopy(trainer.config)
    config.loss.scheduled_sampling = 0.0
    b = bucket_batch(torch, trainer.config)[0]
    batch = batch_to_device(b, dev)
    params0 = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    runs = {}
    tok = trainer.tokenizer
    for route in ("kernel", "plain"):
        model = build_model(config, tok.vocab_size, train=True,
                            sos_id=tok.sos_id, eos_id=tok.eos_id)
        model.load_state_dict(params0)
        model.to(dev)
        state = TrainState(step=trainer.state.step,
                           opt_state=copy.deepcopy(trainer.state.opt_state),
                           generator=torch.Generator().manual_seed(SEED))
        step = make_train_step(model, config, trainer.optimizer)
        with plain_route() if route == "plain" else contextlib.nullcontext():
            m = step(state, batch)
        torch.cuda.synchronize()
        runs[route + "_att"] = (float(m["loss_att"]), float(m["att_acc"]))
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
           "loss_att_acc_kernel": runs["kernel_att"],
           "loss_att_acc_plain": runs["plain_att"],
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
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD
    from gluon_e2e_asr_tpu_torch.training.train_step import (
        TrainState, batch_to_device, make_train_step)

    config = trainer.config
    H, B = config.model.enc_hidden, config.data.batch_size
    out = {}
    sums = dict.fromkeys(("kernel", "plain", "recur", "recur_plain"), 0.0)
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
            # the recurrence alone; the products are the difference
            r_ms = time_ms(torch, lambda: K.bilstm_fused_bwd_recur_kernel(
                lens, w_hf, w_hb, c, acts, dy, cd))
            p_ms = time_ms(torch, lambda: K.bilstm_fused_bwd_plain(
                x, lens, w_x, b_x, w_hf, w_hb, y, c, dy, compute_dtype=cd),
                n=5, warm=1)
            xg = torch.cat(K._project(x, lens, w_x, b_x, cd, False), -1)
            rp_ms = time_ms(torch, lambda: K._bwd_sweep(
                xg, lens, w_hf, w_hb, y, c, dy, cd), n=3, warm=1)
            f_ms = time_ms(torch, lambda: K.bilstm_fused_kernel(
                *args, compute_dtype=cd, with_cell=True))
            emit({"phase": "timing", "what": "bilstm_bwd", "layer": layer,
                  "B": B, "T": T, "D": D, "H": H, "compute_dtype": cd_name,
                  "kernel_ms": k_ms, "recurrence_kernel_ms": r_ms,
                  "recurrence_us_per_step": r_ms * 1e3 / T,
                  "products_ms": k_ms - r_ms,
                  "products_basis": "whole call - recurrence alone",
                  "plain_ms": p_ms, "plain_runs": 5,
                  "recurrence_plain_ms": rp_ms, "recurrence_plain_runs": 3,
                  "fwd_training_form_kernel_ms": f_ms, "card": card})
            if cd_name == "bfloat16":
                sums["kernel"] += k_ms
                sums["plain"] += p_ms
                sums["recur"] += r_ms
                sums["recur_plain"] += rp_ms
            del xg
    out["bilstm_bwd"] = (sums["kernel"], sums["plain"])
    out["bilstm_bwd_cluster"] = (sums["recur"], sums["recur_plain"])

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

    args, _, _ = decoder_case(torch, config, dev, 0.0)
    bf = torch.bfloat16
    _, resid, extras = LD.las_decoder_fwd_kernel(*args, bf, "dot")
    tokens, _, enc, enc_proj, enc_len, w = args
    dl = torch.from_numpy(np.random.RandomState(SEED + 7).randn(
        *tokens.shape, w.embed.shape[0]).astype(np.float32) * 0.05).to(dev)
    bwd_args = (enc, enc_proj, enc_len, w, bf, "dot")
    out["las_decoder_fwd"] = (
        time_ms(torch, lambda: LD.las_decoder_fwd_kernel(*args, bf, "dot")),
        time_ms(torch, lambda: LD.las_decoder_fwd_plain(*args, bf, "dot"),
                n=5, warm=1))
    out["las_decoder_bwd"] = (
        time_ms(torch, lambda: LD.las_decoder_bwd_kernel(
            dl, resid, extras, *bwd_args)),
        time_ms(torch, lambda: LD.las_decoder_bwd_plain(dl, resid, *bwd_args),
                n=5, warm=1))
    for name in ("las_decoder_fwd", "las_decoder_bwd"):
        emit({"phase": "timing", "what": name, "B": int(tokens.shape[0]),
              "L": int(tokens.shape[1]), "T": int(enc.shape[1]),
              "compute_dtype": "bfloat16", "kernel_ms": out[name][0],
              "plain_ms": out[name][1], "plain_runs": 5, "card": card})

    out["step_4s"], out["step_12s"] = step_timing(torch, trainer, dev, card)
    return out


def stepper(torch, trainer, dev, route="kernel"):
    """A train step function on a copy of the trained model and its
    optimizer state: the kernels, or (``route`` "plain") the plain
    versions."""
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training.train_step import (
        TrainState, make_train_step)

    config, tok = trainer.config, trainer.tokenizer
    model = build_model(config, tok.vocab_size, train=True,
                        sos_id=tok.sos_id, eos_id=tok.eos_id)
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


def step_timing(torch, trainer, dev, card):
    """The hybrid train step of ``trainer``'s config at the 4.0 s bucket
    (kernels and plain versions) and at bench.py's shape (kernels), and a
    torch.profiler breakdown of the latter. Returns ((4 s kernel ms, 4 s
    plain ms), bench-shape kernel ms)."""
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device

    config = trainer.config
    B = config.data.batch_size
    att = config.model.att_type
    b4 = bucket_batch(torch, trainer.config)[0]
    batch4 = batch_to_device(b4, dev)
    step_k = stepper(torch, trainer, dev)
    step_p = stepper(torch, trainer, dev, "plain")
    k4 = time_ms(torch, lambda: step_k(batch4))
    p4 = time_ms(torch, lambda: step_p(batch4), n=N_TIMED_PLAIN_STEP, warm=1)
    emit({"phase": "timing", "what": "train_step", "shape": "4.0 s bucket",
          "objective": "hybrid", "att_type": att,
          "mtl_alpha": config.loss.mtl_alpha,
          "B": int(b4.audio.shape[0]), "samples": int(b4.audio.shape[1]),
          "max_labels": int(b4.labels.shape[1]), "kernel_ms": k4,
          "plain_ms": p4, "plain_runs": N_TIMED_PLAIN_STEP,
          "utt_per_s": b4.num_real / (k4 / 1e3), "card": card})
    del step_k, step_p

    bench = synth_batch(B, BENCH_SEC, BENCH_LABELS, SEED)
    batch12 = {k: torch.from_numpy(v).to(dev) for k, v in bench.items()}
    step12 = stepper(torch, trainer, dev)
    torch.cuda.reset_peak_memory_stats()
    k12 = time_ms(torch, lambda: step12(batch12))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    emit({"phase": "timing", "what": "train_step", "shape": "bench.py",
          "objective": "hybrid", "att_type": att,
          "mtl_alpha": config.loss.mtl_alpha,
          "B": B, "seconds": BENCH_SEC, "max_labels": BENCH_LABELS,
          "dtype": config.model.compute_dtype, "kernel_ms": k12,
          "utt_per_s": B / (k12 / 1e3), "peak_mem_gib": round(peak, 2),
          "card": card,
          "sm_clock_power_limit_temp": nvidia_smi(
              "clocks.sm,power.draw,power.limit,temperature.gpu")})
    profile_step(torch, lambda: step12(batch12), card, att)
    return (k4, p4), k12


def loc_timing(torch, trainer, dev, card):
    """Phase 8 for the location-aware flagship (``trainer``'s config): K4 in
    add and loc mode (bf16, the 4.0 s bucket; loc also at bench.py's
    T'=320) against the plain versions, then the loc train step. Returns
    name -> (kernel ms, plain ms) of the add and loc rows."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD

    config = trainer.config
    bf = torch.bfloat16
    out = {}
    for m, bench in (("add", False), ("loc", False), ("loc", True)):
        args, filt, _ = decoder_case(torch, config, dev, 0.0, att_type=m,
                                     bench=bench)
        tokens, _, enc, enc_proj, enc_len, w = args
        band = None if filt is None else LD.build_loc_band_cmajor(
            filt, enc.shape[1])
        _, resid, extras = LD.las_decoder_fwd_kernel(*args, bf, m, filt)
        dl = torch.from_numpy(np.random.RandomState(SEED + 7).randn(
            *tokens.shape, w.embed.shape[0]).astype(np.float32) * 0.05).to(dev)
        bwd = (enc, enc_proj, enc_len, w, bf, m)
        n_plain = 2 if bench else 5
        f = (time_ms(torch, lambda: LD.las_decoder_fwd_kernel(*args, bf, m, filt)),
             time_ms(torch, lambda: LD.las_decoder_fwd_plain(*args, bf, m, band),
                     n=n_plain, warm=1))
        b = (time_ms(torch, lambda: LD.las_decoder_bwd_kernel(
                dl, resid, extras, *bwd, filt)),
             time_ms(torch, lambda: LD.las_decoder_bwd_plain(
                dl, resid, *bwd, band), n=n_plain, warm=1))
        for d, (k_ms, p_ms) in (("fwd", f), ("bwd", b)):
            emit({"phase": "timing", "what": f"las_decoder_{d}",
                  "att_type": m, "B": int(tokens.shape[0]),
                  "L": int(tokens.shape[1]), "T": int(enc.shape[1]),
                  "shape": "bench.py" if bench else "4.0 s bucket",
                  "compute_dtype": "bfloat16", "kernel_ms": k_ms,
                  "plain_ms": p_ms, "plain_runs": n_plain, "card": card})
            if not bench:
                out[f"las_decoder_{d}_{m}"] = (k_ms, p_ms)
        del resid, extras
    step_timing(torch, trainer, dev, card)
    return out


def golden_beam(torch, device="cuda"):
    """Phase 9: the blessed tiny golden (its JAX checkpoint read by the
    port's own msgpack reader, bridged, saved as a port checkpoint)
    decoded with the beam on the card through the decode CLI: every
    hypothesis of golden_beam.jsonl, the scores within TOL_GOLDEN_SCORE."""
    from gluon_e2e_asr_tpu_torch import decode
    from gluon_e2e_asr_tpu_torch.bridge import params_from_jax, read_jax_checkpoint
    from gluon_e2e_asr_tpu_torch.training.checkpoint import save_checkpoint

    params, cmvn, meta = read_jax_checkpoint(
        os.path.join(GOLD, "tiny_golden.msgpack"))
    ckpt = save_checkpoint(os.path.join(OUT_DIR, "golden.pt"),
                           params_from_jax(params), meta, cmvn)
    out = os.path.join(OUT_DIR, "golden_beam.jsonl")
    reset_counts()
    result = decode.main(["--config", os.path.join(GOLD, "tiny_golden.yaml"),
                          "--ckpt", ckpt, "--method", "beam", "--output", out,
                          "--device", device])
    launches, plain = read_counts()

    def records(path):
        with open(path) as f:
            return {r["utt_id"]: r for r in map(json.loads, f)}

    gold, got = records(os.path.join(GOLD, "golden_beam.jsonl")), records(out)
    same = [u for u in gold if u in got and got[u]["hyp"] == gold[u]["hyp"]]
    dscore = max((abs(got[u]["score"] - gold[u]["score"]) for u in same),
                 default=float("inf"))
    emit({"phase": "golden_beam", "decode_done": result,
          "hypotheses": len(gold), "identical": len(same),
          "max_abs_score_diff": dscore, "tol_score": TOL_GOLDEN_SCORE,
          "launches": launches, "plain_calls": plain})
    check(len(got) == len(gold) == len(same) == 16,
          f"golden beam: {len(same)} of {len(gold)} hypotheses identical")
    check(dscore <= TOL_GOLDEN_SCORE, f"golden beam scores differ by {dscore}")
    check(not plain["bilstm_fwd"], "the plain BiLSTM ran in the beam decode")


def beam_timing(torch, trainer, dev, card):
    """Phase 9: one beam decode (the config's: K=10, ctc_weight 0.3) of a
    96-utterance 4.0 s batch of the trained loc model: the frontend and
    the encoder timed with CUDA events, the whole decode (host audio in,
    hypotheses on the host) with the host clock; the search is the rest."""
    from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
    from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply

    config = trainer.config
    b, _, _, _ = bucket_batch(torch, config)
    model = trainer.model.eval()
    decoder = make_beam_decoder(model, config, trainer.tokenizer,
                                trainer.cmvn_stats, device=dev)
    with torch.inference_mode():
        audio = torch.from_numpy(b.audio).to(dev)
        alen = torch.from_numpy(b.audio_len).to(dev)
        fe_ms = time_ms(torch, lambda: frontend_apply(config.frontend, audio, alen))
        feats, flen = frontend_apply(config.frontend, audio, alen)
        enc_ms = time_ms(torch, lambda: model.encode(feats, flen))
    decoder(b.audio, b.audio_len)
    times = []
    for _ in range(N_BEAM_TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        texts, scores = decoder(b.audio, b.audio_len)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    total = float(np.median(times))
    emit({"phase": "timing", "what": "beam_decode", "B": int(b.audio.shape[0]),
          "samples": int(b.audio.shape[1]), "beam_size": config.decode.beam_size,
          "ctc_weight": config.decode.ctc_weight, "frontend_ms": fe_ms,
          "encoder_ms": enc_ms, "decode_total_ms": total,
          "search_ms": total - fe_ms - enc_ms, "runs": N_BEAM_TIMED,
          "output_steps": decoder.last_steps,
          "basis": "frontend and encoder CUDA events; total host clock, "
                   "host audio in, hypotheses on the host", "card": card})
    check(len(texts) == b.audio.shape[0] and bool(np.isfinite(scores).all()),
          "the beam decode returned no hypothesis or a non-finite score")


def frontend_timing(torch, m2_trainer, config, dev, card):
    """Phase 8 for the frontend: at each shape of frontend_cases (cmvn
    utterance, eval), K5 and K6 against their plain versions, which are
    the ``impl: jnp`` path (cuBLAS f32 products), and torch.stft (cuFFT)
    for the STFT alone; no one PyTorch call computes log-mel. Then the
    milestone 2 train step at its 4.0 s bucket, through K5, and the
    frontend's share of it. Returns (name -> (kernel ms, plain ms) at
    milestone 2's 4.0 s bucket, name -> library note)."""
    from gluon_e2e_asr_tpu_torch.frontend import fused as FE
    from gluon_e2e_asr_tpu_torch.frontend.features import (
        draw_spec_augment, frontend_apply, num_frames)
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device

    m2_config = m2_trainer.config
    out, notes = {}, {}
    for case, fc, B, sec in frontend_cases(m2_config, config):
        audio, alen = frontend_audio(torch, B, sec, dev)
        k5 = time_ms(torch, lambda: FE.compute_features_pallas_kernel(fc, audio, alen))
        k6 = time_ms(torch, lambda: FE.compute_features_pallas_regrid_kernel(
            fc, audio, alen))
        p5 = time_ms(torch, lambda: FE.compute_features_pallas_plain(fc, audio, alen))
        p6 = time_ms(torch, lambda: FE.compute_features_pallas_regrid_plain(
            fc, audio, alen))
        window = torch.hann_window(fc.win_length, periodic=True, device=dev)
        stft = time_ms(torch, lambda: torch.stft(
            audio, fc.n_fft, fc.hop_length, fc.win_length, window,
            center=False, return_complex=True))
        F = num_frames(audio.shape[1], fc.win_length, fc.hop_length)
        emit({"phase": "timing", "what": "frontend", "shape": case, "B": B,
              "samples": int(audio.shape[1]), "F": F, "cmvn": fc.cmvn,
              "k5_kernel_ms": k5, "k6_kernel_ms": k6, "k5_plain_ms": p5,
              "k6_plain_ms": p6, "plain_is": "the impl: jnp path",
              "torch_stft_ms": stft, "card": card})
        if case == "milestone2 4.0 s":
            out["frontend_k5"], out["frontend_k6"] = (k5, p5), (k6, p6)
            for name in ("frontend_k5", "frontend_k6"):
                notes[name] = (f"no single PyTorch call computes log-mel; the "
                               f"jnp path (cuBLAS f32) {p5 if name == 'frontend_k5' else p6} ms, "
                               f"torch.stft (cuFFT, the STFT alone) {stft} ms")

    b4 = bucket_batch(torch, m2_config)[0]
    batch4 = batch_to_device(b4, dev)
    step = stepper(torch, m2_trainer, dev)
    step_ms = time_ms(torch, lambda: step(batch4))
    fc = m2_config.frontend
    F = num_frames(b4.audio.shape[1], fc.win_length, fc.hop_length)
    draws = draw_spec_augment(fc, b4.audio.shape[0], F,
                              torch.Generator().manual_seed(SEED), dev)
    fe_ms = time_ms(torch, lambda: frontend_apply(
        fc, batch4["audio"], batch4["audio_len"], train=True, spec_draws=draws))
    emit({"phase": "timing", "what": "train_step", "config": "milestone2",
          "shape": "4.0 s bucket", "B": int(b4.audio.shape[0]),
          "samples": int(b4.audio.shape[1]), "frontend_impl": fc.impl,
          "kernel_ms": step_ms, "frontend_train_ms": fe_ms,
          "frontend_share": fe_ms / step_ms,
          "utt_per_s": b4.num_real / (step_ms / 1e3), "card": card})
    return out, notes


def v1_timing(torch, config, shape, dev, card):
    """Phase 8 for K7 at the flagship's layer-0 shape, bf16 and f32: the
    forward's training form and the backward against their plain
    versions. Returns the bf16 (kernel ms, plain ms) of each."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    out = {}
    for cd_name in ("float32", "bfloat16"):
        args, dy, cd = v1_case(torch, config, shape, dev, cd_name)
        y, c, acts = K.bilstm_pallas_kernel(*args, cd, with_cell=True)
        yp, cp = K.bilstm_pallas_plain(*args, cd, with_cell=True)
        f = (time_ms(torch, lambda: K.bilstm_pallas_kernel(*args, cd,
                                                           with_cell=True)),
             time_ms(torch, lambda: K.bilstm_pallas_plain(*args, cd,
                                                          with_cell=True),
                     n=5, warm=1))
        b = (time_ms(torch, lambda: K.bilstm_pallas_bwd_kernel(
                args[2], args[3], args[4], y, c, acts, dy, cd, cd)),
             time_ms(torch, lambda: K.bilstm_pallas_bwd_plain(
                *args, yp, cp, dy, cd), n=5, warm=1))
        for d, (k_ms, p_ms) in (("fwd", f), ("bwd", b)):
            emit({"phase": "timing", "what": f"bilstm_v1_{d}",
                  "B": int(y.shape[0]), "T": int(y.shape[1]),
                  "H": int(y.shape[2] // 2), "dtype": cd_name,
                  "kernel_ms": k_ms, "plain_ms": p_ms, "plain_runs": 5,
                  "card": card})
            if cd_name == "bfloat16":
                out[f"bilstm_v1_{d}"] = (k_ms, p_ms)
        del y, c, acts, yp, cp
    return out


def check_probe_kernels(torch, dev):
    """Phase 3 for P1: both variants of csrc/pipeline_probe.cu and cuDNN's
    LSTM (the column mapping of ``cudnn_chains``) against the plain
    version at each (M, N) of PROBE_CHECKS, T=PROBE_T, on inputs whose
    state stays alive for all the steps (``live_inputs``; the mean |h| of
    the plain version's output must be above PROBE_LIVE). Returns each
    variant's largest max abs error."""
    from gluon_e2e_asr_tpu_torch.tools import pipeline_probe as P

    errs = dict.fromkeys(P.VARIANTS, 0.0)
    for M, N in PROBE_CHECKS:
        h0, c0, w = P.live_inputs(N, M, dev, SEED + N)
        ref = P.pipeline_probe_plain(h0, c0, w, PROBE_T)
        outs = {v: P.KERNELS[v](h0, c0, w, PROBE_T) for v in P.VARIANTS}
        outs["cudnn"] = P.cudnn_chains(h0, c0, w, PROBE_T)()
        torch.cuda.synchronize()
        err = {k: float((o - ref).abs().max()) for k, o in outs.items()}
        live = float(ref.abs().mean())
        finite = all(bool(torch.isfinite(o).all()) for o in outs.values())
        emit({"phase": "kernel_check", "kernel": "pipeline_probe", "M": M,
              "N": N, "T": PROBE_T, "max_abs_err": err, "tol": TOL_PROBE,
              "ref_mean_abs": live, "finite": finite,
              "max_active_clusters": P.max_active_clusters(dev)})
        check(live > PROBE_LIVE, f"P1's state died out at M={M} N={N}: {live}")
        check(finite and max(err.values()) <= TOL_PROBE,
              f"P1 disagrees with its plain version at M={M} N={N}: {err}")
        for v in P.VARIANTS:
            errs[v] = max(errs[v], err[v])
    return errs


def probe_path(torch, dev, card):
    """Phase 10: P1's entry point, ``pipeline_probe.main``, at M in
    PROBE_MS and N = 1..4 for both variants, the counts reset just before
    and read just after: every call of the sweep a launch of its
    variant's kernel, none of the plain version. Then the plain version
    and cuDNN's LSTM timed at the same shapes. Returns ({variant: (ms,
    plain ms)} at M=PROBE_MS[0], N=1, {variant: launches}, cuDNN's ms
    there)."""
    from gluon_e2e_asr_tpu_torch.tools import pipeline_probe as P

    for kernel in P.KERNELS.values():
        kernel.launches = 0
    P.pipeline_probe_plain.calls = 0
    t0 = time.perf_counter()
    ms = P.main(["--T", str(PROBE_T), "--iters", str(PROBE_ITERS),
                 "--M", *map(str, PROBE_MS)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {v: k.launches for v, k in P.KERNELS.items()}
    plain = P.pipeline_probe_plain.calls
    expect = len(PROBE_MS) * len(P.NS) * (PROBE_ITERS + 1)
    emit({"phase": "probe_path", "seconds": round(wall, 2),
          "launches": launches, "expected_launches": expect,
          "plain_calls": plain})
    check(all(n == expect for n in launches.values()),
          f"the probe launched {launches}, expected {expect} each")
    check(plain == 0, f"the plain P1 ran {plain} times on the probe's path")
    check(all(np.isfinite(t) and t > 0 for v in ms.values() for t in v.values()),
          f"probe times {ms}")
    plain_ms, cudnn_ms = {}, {}
    for M in PROBE_MS:
        for N in P.NS:
            h0, c0, w = P.probe_inputs(N, M, dev)
            plain_ms[(M, N)] = time_ms(torch, lambda: P.pipeline_probe_plain(
                h0, c0, w, PROBE_T), n=3, warm=1)
            cudnn_ms[(M, N)] = time_ms(torch, P.cudnn_chains(h0, c0, w, PROBE_T),
                                       n=5, warm=1)
            emit({"phase": "timing", "what": "pipeline_probe", "M": M, "N": N,
                  "T": PROBE_T, **{f"{v}_ms": ms[v][(M, N)] for v in ms},
                  "plain_ms": plain_ms[(M, N)], "cudnn_ms": cudnn_ms[(M, N)],
                  "plain_runs": 3, "card": card})
    at = (PROBE_MS[0], 1)
    return {v: (ms[v][at], plain_ms[at]) for v in ms}, launches, cudnn_ms[at]


def library_timing(torch, config, shapes, dev, card):
    """The one PyTorch call that computes each kernel's function, timed on
    the same inputs beside it and never called by the port: cuDNN's
    bidirectional LSTM (packed by lengths; the forget bias +1 in b_ih) for
    K1-fwd (forward, summed over the 3 layer shapes) and K1-bwd (its
    backward alone); torch.addmm on bf16 operands for K1-fwd's projection
    (``bilstm_fwd_projection``); F.ctc_loss for K2 (forward) and K3
    (backward alone), on K2/K3's lattice. K4 has none; K1-bwd's products
    are timed beside cuBLAS in products_timing."""
    import torch.nn.functional as F
    from torch.nn.utils.rnn import pack_padded_sequence

    H, B = config.model.enc_hidden, config.data.batch_size
    bf = torch.bfloat16
    out = {"bilstm_fwd": 0.0, "bilstm_bwd": 0.0, "bilstm_fwd_projection": 0.0}
    for layer, T, D in shapes:
        x, lens, w_x, b_x, w_hf, w_hb = layer_inputs(torch, B, T, D, H, layer, dev)
        # K1-fwd's projection: x . W_x + b on bf16 operands, one addmm
        xb, wb, bb = x.to(bf).reshape(-1, D), w_x.to(bf), b_x.to(bf)
        p_ms = time_ms(torch, lambda: torch.addmm(bb, xb, wb))
        emit({"phase": "library_timing", "what": "addmm (K1-fwd projection)",
              "layer": layer, "B": B, "T": T, "D": D, "H": H,
              "dtype": "bfloat16", "ms": p_ms, "card": card})
        out["bilstm_fwd_projection"] += p_ms
        del xb, wb, bb
        lstm = torch.nn.LSTM(D, H, batch_first=True, bidirectional=True)
        with torch.no_grad():
            for sfx, cols, w_h in (("", slice(0, 4 * H), w_hf),
                                   ("_reverse", slice(4 * H, 8 * H), w_hb)):
                bias = b_x[cols].clone()
                bias[H:2 * H] += 1.0
                getattr(lstm, "weight_ih_l0" + sfx).copy_(w_x[:, cols].T)
                getattr(lstm, "weight_hh_l0" + sfx).copy_(w_h.T)
                getattr(lstm, "bias_ih_l0" + sfx).copy_(bias)
                getattr(lstm, "bias_hh_l0" + sfx).zero_()
        lstm = lstm.to(dev, bf)
        lstm.flatten_parameters()  # cuDNN's one weight buffer
        xb = x.to(bf).requires_grad_(True)
        packed = pack_padded_sequence(xb, lens.cpu().long(), batch_first=True,
                                      enforce_sorted=False)
        with torch.no_grad():
            f_ms = time_ms(torch, lambda: lstm(packed))
        y = lstm(packed)[0].data
        dy = torch.randn_like(y)
        b_ms = time_ms(torch, lambda: torch.autograd.backward(
            y, dy, retain_graph=True))
        emit({"phase": "library_timing", "what": "cudnn_lstm", "layer": layer,
              "B": B, "T": T, "D": D, "H": H, "dtype": "bfloat16",
              "fwd_ms": f_ms, "bwd_ms": b_ms, "card": card})
        out["bilstm_fwd"] += f_ms
        out["bilstm_bwd"] += b_ms
        del lstm, y, dy, xb, packed

    b, tok, lens, T = bucket_batch(torch, config)
    rng = np.random.RandomState(SEED)
    logits = torch.from_numpy(
        rng.randn(b.audio.shape[0], T, tok.vocab_size).astype(np.float32) * 3)
    lp = torch.log_softmax(logits.to(dev), -1).transpose(0, 1).detach() \
        .requires_grad_(True)
    ctc = dict(targets=torch.from_numpy(b.labels).to(dev).long(),
               input_lengths=lens.to(dev).long(),
               target_lengths=torch.from_numpy(b.label_len).to(dev).long(),
               blank=0, reduction="none", zero_infinity=True)
    with torch.no_grad():
        out["ctc_alpha"] = time_ms(torch, lambda: F.ctc_loss(lp, **ctc))
    loss = F.ctc_loss(lp, **ctc).sum()
    out["ctc_beta_post"] = time_ms(torch, lambda: loss.backward(retain_graph=True))
    emit({"phase": "library_timing", "what": "F.ctc_loss", "T": T,
          "B": int(b.audio.shape[0]), "V": tok.vocab_size,
          "fwd_ms": out["ctc_alpha"], "bwd_ms": out["ctc_beta_post"],
          "card": card})
    return out


# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit).
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def _bound(flops: float, rate: float, nbytes: float, f32_ops: float = 0.0):
    """(ms, "operations" or "bytes"): ``flops`` at ``rate`` plus ``f32_ops``
    on the CUDA cores, or ``nbytes`` at the memory rate, the larger."""
    t_ops = flops / rate + f32_ops / PEAK_F32
    t_bytes = nbytes / PEAK_BYTES
    return (t_ops * 1e3, "operations") if t_ops >= t_bytes \
        else (t_bytes * 1e3, "bytes")


def loc_taps(enc_len, T: int, W: int) -> float:
    """Multiply-adds of one channel of the location convolution over one
    step of a batch: for each row's live frames t, the filter taps that
    land on a live frame (the feature and, in the backward, its carry)."""
    pad = (W - 1) // 2
    t = np.arange(T)[None, :]
    n = np.asarray(enc_len, np.int64)[:, None]
    taps = np.minimum(W, n - t + pad) - np.maximum(0, pad - t)
    return float(np.where(t < n, np.maximum(taps, 0), 0).sum())


def k4_bounds(torch, config, att):
    """(K4-fwd bound, K4-bwd bound) in mode ``att`` at ``config``'s 4.0 s
    bucket (see kernel_bounds)."""
    (tokens, _, enc, _, enc_len, w), filt, _ = decoder_case(
        torch, config, "cpu", 0.0, att_type=att)
    H = w.w_h.shape[0]
    Bd, L = tokens.shape
    T, D = enc.shape[1], enc.shape[2]
    A, E, V = w.att_q.shape[1], w.embed.shape[1], w.embed.shape[0]
    f4, cd = 4, 2
    live = float(enc_len.sum())  # frames of the batch
    frames = live * L  # attended frames over all steps
    gate_k = E + D + H
    step_ops = 2.0 * (gate_k * 4 * H + H * A + (H + D) * V)
    w_bytes = cd * (gate_k * 4 * H + H * A + (H + D) * V + V * E) \
        + f4 * (4 * H + V)
    encs = cd * live * (D + A) + 4 * Bd
    # in: tokens (int32), coins (bool); out: logits and the residuals
    # h, c, att, ctx (f32) and tok (int32)
    fwd_io = 5 * Bd * L + f4 * Bd * L * (V + 2 * H + T + D + 1)
    bwd_ops = 2.0 * (V * (H + D) + A * H + 4 * H * gate_k)
    # in: dlogits and those residuals (att over the live frames); out:
    # dgates, dctx, dqb, demb per step and d_enc_proj
    bwd_in = f4 * (Bd * L * (V + 2 * H + D + 1) + frames)
    bwd_out = f4 * (Bd * L * (4 * H + D + A + E) + Bd * T * A)
    if att == "dot":
        return (_bound(Bd * L * step_ops + 2.0 * frames * (A + D), PEAK_BF16,
                       encs + w_bytes + fwd_io),
                _bound(Bd * L * bwd_ops + 2.0 * frames * (D + A + A),
                       PEAK_BF16, encs + w_bytes + bwd_in + bwd_out))
    # The energies on the CUDA cores, per attended (frame, column): add
    # forward 4 (the query's add, tanh, v's multiply-add), backward 10
    # (the recomputed energy, tanh, d_att_v, de, dqb, d_enc_proj); loc
    # adds the feature's product (2C + 1), and in the backward d_loc_proj
    # and dfct (4C), and the convolution's taps (forward 2C per tap; the
    # backward's recomputed feature and its carry, 4C per tap).
    e_fwd, e_bwd = 4.0, 10.0
    conv = 0.0
    extra_out = 0.0
    if att == "loc":
        C = filt.shape[2]
        e_fwd += 2 * C + 1
        e_bwd += 6 * C + 1
        conv = 2.0 * C * L * loc_taps(enc_len.numpy(), T, filt.shape[0])
        extra_out = f4 * Bd * L * C * T  # the dfct stream
    return (_bound(Bd * L * step_ops + 2.0 * frames * D, PEAK_BF16,
                   encs + w_bytes + fwd_io, e_fwd * frames * A + conv),
            _bound(Bd * L * bwd_ops + 2.0 * frames * D, PEAK_BF16,
                   encs + w_bytes + bwd_in + bwd_out + extra_out,
                   e_bwd * frames * A + 2 * conv))


def kernel_bounds(config, shapes, dev, loc_config, m2_config):
    """name -> (bound_ms, bound_by): the least time the card could take
    for each timed call, from this run's inputs: the operations over the
    peak rate of their type (bf16 products for K1 and K4; f32 for the CTC
    recursions, about 10 operations a live lattice cell: 3 exp, 1 log, the
    max and the adds), or each input read once and each output written
    once over the memory rate, whichever is larger.

    Only what the TPU function reads and writes is counted, not the
    buffers the port saves for its own backward (K1's and K4's gate
    activations, K4's query, K4-bwd's score-gradient scratch). Inputs and
    products count the frames each row really has (padding is never
    needed); outputs count their whole size. Products take bf16 operands
    (2 bytes), as the timed calls do; states, residuals and gradients are
    f32. K1 sums its 3 layer shapes (K1-fwd in its serving form, as
    timed: y only). K1-fwd's recurrence alone (its own row, as timed):
    the bf16 products h . W_h of both directions over the live frames,
    against xg of the live frames (f32) and W_h in and y out. K1-fwd's
    projection (a note on its row, timed as the whole call less the
    recurrence): the whole call's bytes and its operations less the
    recurrence's. K1-bwd's recurrence alone (its own row, as timed): the
    bf16 products dg . W_h^T of both directions over the live frames,
    against the gate activations, c and dy of the live frames and W_h in,
    dg out (the activations count here: the recurrence cannot run
    without its gates). K1-bwd's products (their own row, timed through
    their own entry): ``tools/k1b_probe.py::products_work``, dx, dW_x and
    dW_h of both directions over the live frames, against dg, x and y of
    the live frames in f32 (as the entry takes them), W_x and lens in, dx,
    dW_x, db and dW_h out. K4's add and loc modes (at ``loc_config``'s shapes) add
    their energies and location convolution as f32 work on the CUDA cores
    (67 TFLOP/s, counting a tanh as one operation; see k4_bounds) to the
    bf16 products' time, and the loc backward writes its dfct stream.

    K5 and K6 (at milestone 2's 4.0 s bucket, B=16, as timed): the f32
    products on the CUDA cores for every valid frame (the DFT, 2 * win *
    2 * n_freq, and the mel, 2 * n_freq * n_mels; a tile past a row's
    length computes nothing), against the audio in, the features out and
    the two constant matrices. K7 (the flagship's layer 0, bf16 as timed):
    the recurrent products of the valid frames, forward h . W_h per
    direction, backward dg . W_h^T and h^T . dg; the projections in and
    the streams out (the backward: projections, h, c and dy in, d(xg) and
    dW_h out). P1 (at M=96, N=1, T=640, as its row is timed): the f32
    products on the CUDA cores (the gates' few operations a cell left
    out), against W, h0 and c0 in and h out."""
    import torch

    from gluon_e2e_asr_tpu_torch.tools.k1b_probe import products_bound

    H, B = config.model.enc_hidden, config.data.batch_size
    f4, cd = 4, 2
    out = {}
    k1f = k1b = k1r = k1p = k1fr = k1fp = (0.0, "")
    for layer, T, D in shapes:
        lens = layer_inputs(torch, B, T, D, H, layer, "cpu")[1]
        frames = float(lens.sum())
        w_mats = D * 8 * H + 2 * H * 4 * H
        f_ops = 2.0 * frames * D * 8 * H + 2 * 2.0 * frames * H * 4 * H
        f_bytes = (cd * (frames * D + w_mats) + f4 * 8 * H + 4 * B
                   + f4 * B * T * 2 * H)
        # dx and dW_x, dW_h of both directions, the dh recurrence
        b_ops = (2 * 2.0 * frames * 8 * H * D + 2 * 2.0 * frames * H * 4 * H
                 + 2 * 2.0 * frames * 4 * H * H)
        # in: x, y, c, dy, weights; out: dx, dW_x, db, dW_h
        b_bytes = (cd * (frames * D + w_mats) + f4 * frames * 2 * H * 3
                   + 4 * B + f4 * (B * T * D + w_mats + 8 * H))
        # the recurrence alone: dg . W_h^T of both directions; in: the gate
        # activations, c, dy (live frames), W_h, lens; out: dg
        r_ops = 2 * 2.0 * frames * 4 * H * H
        r_bytes = (f4 * frames * (8 * H + 2 * H + 2 * H) + cd * 2 * H * 4 * H
                   + 4 * B + f4 * B * T * 8 * H)
        # K1-fwd's recurrence alone: h . W_h of both directions; in: xg
        # (live frames, f32), W_h, lens; out: y
        fr_ops = 2 * 2.0 * frames * H * 4 * H
        fr_bytes = (f4 * frames * 8 * H + cd * 2 * H * 4 * H + 4 * B
                    + f4 * B * T * 2 * H)
        fb, bb = _bound(f_ops, PEAK_BF16, f_bytes), _bound(b_ops, PEAK_BF16, b_bytes)
        frb = _bound(fr_ops, PEAK_BF16, fr_bytes)
        fpb = _bound(f_ops - fr_ops, PEAK_BF16, f_bytes)
        k1fr = (k1fr[0] + frb[0], frb[1])
        k1fp = (k1fp[0] + fpb[0], fpb[1])
        rb = _bound(r_ops, PEAK_BF16, r_bytes)
        pb = products_bound(lens.tolist(), T, D, H)
        k1f = (k1f[0] + fb[0], fb[1])
        k1b = (k1b[0] + bb[0], bb[1])
        k1r = (k1r[0] + rb[0], rb[1])
        k1p = (k1p[0] + pb[0], pb[1])
    out["bilstm_fwd"], out["bilstm_bwd"] = k1f, k1b
    out["bilstm_fwd_cluster"], out["bilstm_fwd_projection"] = k1fr, k1fp
    out["bilstm_bwd_cluster"], out["bilstm_bwd_products"] = k1r, k1p

    emit_, tmask, skip, svalid, label_lens = real_ctc_batch(torch, config, "cpu")
    T, Bc, S = emit_.shape
    live = float((tmask.T[:, :, None] & svalid[:, None, :]).sum())
    table = f4 * T * Bc * S
    masks = T * Bc * 2 + Bc * S * 3
    out["ctc_alpha"] = _bound(10 * live, PEAK_F32, 2 * table + masks)
    out["ctc_beta_post"] = _bound(12 * live, PEAK_F32, 3 * table + masks + f4 * Bc)

    out["las_decoder_fwd"], out["las_decoder_bwd"] = k4_bounds(torch, config, "dot")

    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
    _, fc, Bf, sec = frontend_cases(m2_config, config)[1]
    sb = synth_batch(Bf, sec, 1, SEED)
    S = sb["audio"].shape[1]
    F = num_frames(S, fc.win_length, fc.hop_length)
    n_freq = fc.n_fft // 2 + 1
    valid = float(num_frames(torch.from_numpy(sb["audio_len"]), fc.win_length,
                             fc.hop_length).sum())
    fe_ops = valid * (2.0 * fc.win_length * 2 * n_freq + 2.0 * n_freq * fc.n_mels)
    fe_bytes = f4 * (Bf * S + Bf * F * fc.n_mels + fc.win_length * 2 * n_freq
                     + n_freq * fc.n_mels) + 4 * Bf
    out["frontend_k5"] = out["frontend_k6"] = _bound(0.0, PEAK_BF16, fe_bytes,
                                                     fe_ops)

    layer, T, D = shapes[0]
    lens = layer_inputs(torch, B, T, D, H, layer, "cpu")[1]
    frames = float(lens.sum())
    v1_ops = 2 * 2.0 * frames * H * 4 * H  # both directions
    w_bytes = cd * 2 * H * 4 * H
    xg_in = cd * frames * 8 * H
    streams = cd * B * T * 2 * H  # one [B,T,2H] stream in xg's dtype
    out["bilstm_v1_fwd"] = _bound(v1_ops, PEAK_BF16,
                                  xg_in + w_bytes + 4 * B + 2 * streams)
    out["bilstm_v1_bwd"] = _bound(2 * v1_ops, PEAK_BF16,
                                  xg_in + w_bytes + 4 * B + 3 * cd * frames * 2 * H
                                  + cd * B * T * 8 * H + f4 * 2 * H * 4 * H)
    for att in ("add", "loc"):
        out[f"las_decoder_fwd_{att}"], out[f"las_decoder_bwd_{att}"] = \
            k4_bounds(torch, loc_config, att)

    from gluon_e2e_asr_tpu_torch.tools.pipeline_probe import flops
    M, N, Hp = PROBE_MS[0], 1, 320
    out["pipeline_probe_l2"] = out["pipeline_probe_cluster"] = _bound(
        flops(N, M, PROBE_T), PEAK_F32, f4 * N * (Hp * 4 * Hp + 3 * M * Hp))
    return out


def profile_step(torch, fn, card, att="dot", steps=3):
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
    prof.export_chrome_trace(os.path.join(OUT_DIR, f"train_step_{att}_trace.json"))
    emit({"phase": "profile", "what": "train_step at bench.py's shape",
          "att_type": att,
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
