"""Global CMVN statistics: one pass of the plain log-mel over the training
set, for ``frontend.cmvn: global``.

    python -m gluon_e2e_asr_tpu_torch.tools.compute_cmvn \
        --config configs/ls100_full.yaml --output cmvn_ls100.npz \
        [--set KEY=VAL ...] [--device cuda|cpu]

then set ``frontend.cmvn_stats_path`` to the file. Counterpart of the
root ``tools/compute_cmvn.py``: the port's ``build_datasets``, an
unshuffled bucket sampler and the loader (its native route for an
on-disk corpus, in the config's ``data.transfer_dtype``), then the plain
log-mel (``frontend/features.py::log_mel_spectrogram``) on the device.
Each batch's moments over its valid frames are summed in f32 on the
device, the sums across batches in f64 on the host. Writes the same
``npz`` keys, ``mean`` and ``std`` (f32), and prints the same line.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import Config, apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.data.loader import DataLoader
from gluon_e2e_asr_tpu_torch.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer
from gluon_e2e_asr_tpu_torch.frontend.features import log_mel_spectrogram, num_frames
from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets


@torch.inference_mode()
def moments(audio: torch.Tensor, audio_len: torch.Tensor, fcfg):
    """(valid frames, per-bin sum, per-bin sum of squares) of one batch,
    f32 on the batch's device."""
    # log_mel_spectrogram is called directly (the stats want the raw
    # per-bin moments, not CMVN-applied features), so the int16 transfer's
    # dequant (* 2^-15) that frontend_apply does must happen here too:
    # without it every log-mel mean is off by log(2^30) ~= 20.8.
    if audio.dtype == torch.int16:
        audio = audio.to(torch.float32) * (2.0 ** -15)
    feats = log_mel_spectrogram(audio, fcfg)
    F = feats.shape[1]
    feat_len = num_frames(audio_len, fcfg.win_length, fcfg.hop_length)
    mask = (torch.arange(F, device=feats.device)[None, :]
            < feat_len[:, None]).to(torch.float32)
    n = mask.sum()
    s1 = (feats * mask[..., None]).sum(dim=(0, 1))
    s2 = (feats ** 2 * mask[..., None]).sum(dim=(0, 1))
    return n, s1, s2


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--config", type=str, default="")
    p.add_argument("--output", type=str, default="cmvn.npz")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the log-mel pass: cuda or cpu")
    args = p.parse_args(argv)
    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False

    train_utts, _ = build_datasets(config)
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch,
    )
    sampler = BucketSampler(train_utts, specs, config.data.sample_rate,
                            seed=0, shuffle=False)
    loader = DataLoader(train_utts, sampler, CharTokenizer(),
                        config.data.sample_rate,
                        transfer_dtype=config.data.transfer_dtype)

    tot_n, tot_s1, tot_s2 = 0.0, 0.0, 0.0
    for b in loader.epoch(0):
        n, s1, s2 = moments(torch.from_numpy(b.audio).to(device),
                            torch.from_numpy(b.audio_len).to(device),
                            config.frontend)
        tot_n += float(n)
        tot_s1 = tot_s1 + s1.cpu().numpy().astype(np.float64)
        tot_s2 = tot_s2 + s2.cpu().numpy().astype(np.float64)
    mean = tot_s1 / max(tot_n, 1.0)
    var = tot_s2 / max(tot_n, 1.0) - mean ** 2
    std = np.sqrt(np.maximum(var, 1e-10))
    np.savez(args.output, mean=mean.astype(np.float32),
             std=std.astype(np.float32))
    print(f"wrote {args.output}: n={tot_n:.0f} frames, "
          f"mean[0]={mean[0]:.3f}, std[0]={std[0]:.3f}")
    return {"output": args.output, "frames": tot_n,
            "mean": mean.astype(np.float32), "std": std.astype(np.float32)}


if __name__ == "__main__":
    main()
