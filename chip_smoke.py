#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``nvidia-smi``; it imports no JAX. Phases,
each printing one JSON line:

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA kernel of the greedy serving path, from ``csrc/``;
3. kernels: each kernel against its plain PyTorch version at the shapes
   the flagship model gives it (``configs/english_flagship.yaml``, the
   4.0 s bucket), in f32 and bf16, within stated tolerances;
4. slice: a seeded random full-width checkpoint of that model, decoded
   greedily through ``gluon_e2e_asr_tpu_torch.decode.main`` over the
   config's dev set; every kernel must have been launched, and only
   the kernels; the encoder output on the card is held against the
   plain versions on the CPU for a few utterances;
5. timing: CUDA events, median of 10 runs after warm-up.

Then the kernels line and, last, ``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before the last line. Artifacts go to
``build/chip_smoke/``.
"""

from __future__ import annotations

import json
import os
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
# The slice on the card against the plain versions on the CPU, bf16:
# the encoder output as above; the logits are bf16 values (the CTC head
# rounds its sum), so each may also differ by one bf16 ulp of itself.
TOL_SLICE_ENC = 2e-2
BF16_ULP = 2.0 ** -7  # relative, an upper bound
N_TIMED = 10


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
    t0 = time.perf_counter()
    _build.load_library("bilstm_fwd")
    built = _build.build_info.get("bilstm_fwd")
    emit({"phase": "build", "kernel": "bilstm_fwd",
          "seconds": round(time.perf_counter() - t0, 3),
          "built_now": built is not None,
          "ptxas": built[1].splitlines() if built else None})

    # 3. each kernel against its plain version at the flagship shapes
    config = load_config(CONFIG)
    mc, fc = config.model, config.frontend
    H, B = mc.enc_hidden, config.data.batch_size
    T = num_frames(int(BUCKET_SEC * fc.sample_rate), fc.win_length,
                   fc.hop_length)
    shapes = []
    D = fc.n_mels * (1 + fc.deltas)
    for layer in range(mc.enc_layers):
        f = int(mc.enc_subsample[layer]) if layer < len(mc.enc_subsample) else 1
        T, D = -(-T // f), D * f
        shapes.append((layer, T, D))
        D = 2 * H
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
    bilstm_fused_kernel.launches = 0
    bilstm_fused_plain.calls = 0
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

    bf16 = [(layer, "bfloat16") for layer, _, _ in shapes]
    emit({"kernels": [{
        "name": "bilstm_fwd",
        "route": "cuda",
        "source": "gluon_e2e_asr_tpu_torch/csrc/bilstm_fwd.cu",
        "replaces": "gluon_e2e_asr_tpu/ops/pallas_lstm.py:411",
        "launches": launches,
        "max_abs_err": max(v for k, v in errs.items() if k[1] == "bfloat16"),
        "ms": sum(kernel_ms[k] for k in bf16),
        "plain_ms": sum(plain_ms[k] for k in bf16),
        "at": "sum over the flagship's 3 layer shapes, bf16, B=96, 4.0 s",
    }]})
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
