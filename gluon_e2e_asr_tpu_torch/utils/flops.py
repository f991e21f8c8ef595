"""Analytic model-FLOP accounting for the train step.

Counterpart of ``gluon_e2e_asr_tpu/utils/flops.py``: the same count over
the port's ``Config`` and ``frontend/features.py::num_frames``, so the
port's bench reports achieved TFLOP/s and MFU by the JAX package's own
convention. The count mirrors the matmul shapes the model builds (the
jnp frontend's DFT and mel products, the pyramidal BiLSTM, the LAS
step) from the config: matmul multiply-adds x 2; elementwise work,
softmax and the CTC alpha-beta recursion are excluded.

The frontend term is the DFT product's (``dft``, a framed matmul against
the combined cos|sin basis), the MFU convention, also where the step runs
K5/K6, whose FFT does far fewer operations: it is the model's work by
the convention both packages report, not the work K5 does.

Training FLOPs use the standard fwd + backward ~= 3x forward-matmul
estimate (each matmul's backward is two matmuls of the same size).
"""

from __future__ import annotations

from typing import Dict

from gluon_e2e_asr_tpu_torch.config import Config
from gluon_e2e_asr_tpu_torch.frontend.features import num_frames

# The MFU denominator, in TFLOP/s: the H100 SXM's dense tensor-core peaks
# (NVIDIA's data sheet, at the 700 W limit). f32 products run on the FMA
# units, since the port keeps TF32 off, at 67 TFLOP/s.
PEAK_TFLOPS = {"bfloat16": 989.0, "float32": 67.0}


def peak_tflops(compute_dtype: str) -> float:
    return PEAK_TFLOPS[str(compute_dtype)]


def train_step_flops(
    config: Config,
    vocab_size: int,
    batch_size: int,
    audio_samples: int,
    max_labels: int,
) -> Dict[str, float]:
    """Exact matmul-FLOP count of one train step at the given shapes.

    Returns {"fwd": F, "train": 3F, "breakdown": {...}} in FLOPs
    (multiply-add = 2). Shapes mirror the padded bucket the step runs
    on (padding FLOPs are real FLOPs — the step computes them).
    """
    fc, mc = config.frontend, config.model
    B, L = batch_size, max_labels
    V = vocab_size

    # --- frontend (jnp impl's DFT product; see the module docstring) -----
    F = int(num_frames(audio_samples, fc.win_length, fc.hop_length))
    bins = fc.n_fft // 2 + 1
    dft = 2.0 * B * F * fc.win_length * (2 * bins)  # combined cos|sin basis
    mel = 2.0 * B * F * bins * fc.n_mels
    frontend = dft + mel
    D = fc.n_mels * (1 + int(getattr(fc, "deltas", 0)))

    # --- encoder: pyramidal BiLSTM stack (models/encoder.py) -------------
    T = F
    H = mc.enc_hidden
    subs = tuple(mc.enc_subsample) + (1,) * max(
        0, mc.enc_layers - len(mc.enc_subsample)
    )
    if mc.enc_type == "vggblstm":
        # Two (conv x2 + pool) stages: 3x3 convs at compute_dtype.
        C_in = int(mc.vgg_in_channels)
        Freq = D // C_in
        conv = 0.0
        t, f = T, Freq
        for ch in mc.vgg_channels:
            conv += 2.0 * B * t * f * 9 * C_in * ch      # conv 1
            conv += 2.0 * B * t * f * 9 * ch * ch        # conv 2
            t, f, C_in = (t + 1) // 2, (f + 1) // 2, int(ch)
        frontend += conv
        T, D = t, f * C_in
    encoder = 0.0
    for layer in range(mc.enc_layers):
        f = int(subs[layer])
        T = (T + f - 1) // f
        D = D * f
        encoder += 2.0 * B * T * D * (8 * H)          # in-proj, both dirs
        encoder += 2 * T * (2.0 * B * H * (4 * H))    # recurrence, 2 dirs
        D = 2 * H

    # --- CTC head ---------------------------------------------------------
    T_enc, enc_dim = T, 2 * H
    ctc_head = 2.0 * B * T_enc * enc_dim * V

    # --- LAS decoder, teacher-forced over L steps (models/decoder.py) ----
    Hd, A, E = mc.dec_hidden, mc.att_dim, mc.dec_embed
    dec = 2.0 * B * T_enc * enc_dim * A               # key precompute
    per_step = 2.0 * B * (E + enc_dim) * (4 * Hd)     # cell0 input proj
    per_step += 2.0 * B * Hd * (4 * Hd)               # cell0 recurrence
    for _ in range(mc.dec_layers - 1):
        per_step += 2.0 * B * Hd * (4 * Hd) * 2       # deeper cells
    per_step += 2.0 * B * Hd * A                      # query projection
    if mc.att_type == "dot":
        per_step += 2.0 * B * T_enc * A               # q . k scores
    else:
        per_step += 2.0 * B * T_enc * A               # energy v-dot
        if mc.att_type == "loc":
            per_step += 2.0 * B * T_enc * mc.loc_conv_width \
                * mc.loc_conv_channels
            per_step += 2.0 * B * T_enc * mc.loc_conv_channels * A
    per_step += 2.0 * B * T_enc * enc_dim             # context sum
    per_step += 2.0 * B * (Hd + enc_dim) * V          # output projection
    dec += L * per_step

    fwd = frontend + encoder + ctc_head + dec
    return {
        "fwd": fwd,
        "train": 3.0 * fwd,
        "breakdown": {
            "frontend": frontend,
            "encoder": encoder,
            "ctc_head": ctc_head,
            "decoder": dec,
        },
    }


def bench_mfu(utt_per_sec: float, config: Config, vocab_size: int,
              batch_size: int, audio_samples: int,
              max_labels: int) -> Dict[str, float]:
    """Achieved TFLOP/s + MFU for a measured train throughput."""
    fl = train_step_flops(config, vocab_size, batch_size,
                          audio_samples, max_labels)
    flops_per_utt = fl["train"] / batch_size
    tps = utt_per_sec * flops_per_utt / 1e12
    peak = peak_tflops(config.model.compute_dtype)
    return {
        "model_tflops_per_step": fl["train"] / 1e12,
        "tflops_per_sec": tps,
        "mfu": tps / peak,
        "peak_tflops": peak,
    }
