"""Attention-alignment plots: run the LAS decoder teacher-forced over dev
utterances and dump each one's attention matrix [n_tokens+1, T'] as
``.npy``, and a ``.png`` heatmap when matplotlib is importable and
``--no-png`` is not given.

    python -m gluon_e2e_asr_tpu_torch.tools.plot_attention --config <yaml> \
        --ckpt <ckpt> [--out plots/] [--num 4] [--no-png] \
        [--set KEY=VAL ...] [--device cuda|cpu]

Counterpart of the root ``tools/plot_attention.py``: the frontend and the
encoder through the port's kernels on the card, then the decoder's
single step (``model.decoder_step``, plain torch, as the JAX tool's
``decoder_step``) fed the gold tokens [sos, y_1..y_L]; row l is the
attention that emits output position l. A well-trained model shows a
monotonic diagonal ridge; a diffuse or collapsed map is the classic
mis-training diagnostic. Prints one ``attention_plots`` JSON line.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch.config import Config, apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.decode import make_eval_loader, restore_model
from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply
from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets


@torch.inference_mode()
def attention_maps(model, config, batch, cmvn_stats=None,
                   device: torch.device = torch.device("cpu")):
    """Teacher-forced attention weights of one padded batch (host arrays
    ``audio``, ``audio_len``, ``labels``). Returns (att [B, L+1, T'],
    enc_len [B]) as numpy arrays, where row l is the attention used to
    emit output position l."""
    if cmvn_stats is not None:
        cmvn_stats = tuple(torch.as_tensor(s, dtype=torch.float32,
                                           device=device) for s in cmvn_stats)
    to = lambda a: torch.as_tensor(a).to(device)  # noqa: E731
    feats, feat_len = frontend_apply(config.frontend, to(batch["audio"]),
                                     to(batch["audio_len"]),
                                     cmvn_stats=cmvn_stats)
    enc, enc_len, _ = model.encode(feats, feat_len)
    B, T = enc.shape[0], enc.shape[1]
    enc_mask = (torch.arange(T, device=device)[None, :]
                < enc_len[:, None]).to(torch.float32)
    enc_proj = model.decoder_precompute(enc)
    loc_band = model.decoder_loc_band(T)
    state = model.decoder_init_state(B, T)
    labels = to(batch["labels"]).long()
    sos = torch.full((B, 1), model.sos_id, dtype=torch.long, device=device)
    tokens_in = torch.cat([sos, labels], dim=1)  # [B, L+1]
    rows = []
    for l in range(tokens_in.shape[1]):
        state, _ = model.decoder_step(state, tokens_in[:, l], enc, enc_proj,
                                      enc_mask, loc_band)
        rows.append(state["att_w"])
    att = torch.stack(rows, dim=1)  # [B, L+1, T]
    return att.float().cpu().numpy(), enc_len.cpu().numpy()


def save_plot(path, att, ref_text):
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 4))
    im = ax.imshow(att, aspect="auto", origin="lower",
                   interpolation="nearest", cmap="viridis")
    ax.set_xlabel("encoder frames")
    ax.set_ylabel("output positions (teacher-forced)")
    ax.set_title(ref_text[:60])
    fig.colorbar(im, ax=ax, fraction=0.03)
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)


def _have_matplotlib() -> bool:
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description="attention alignment plots")
    p.add_argument("--config", type=str, default="")
    p.add_argument("--ckpt", type=str, required=True)
    p.add_argument("--out", type=str, default="att_plots")
    p.add_argument("--num", type=int, default=4)
    p.add_argument("--no-png", action="store_true",
                   help="dump .npy matrices only (no matplotlib)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels) or cpu (their "
                        "plain versions)")
    args = p.parse_args(argv)

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if config.loss.mtl_alpha >= 1.0:
        raise SystemExit("CTC-only config has no attention decoder to plot")
    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False

    model, cmvn_stats, tokenizer = restore_model(config, args.ckpt, device)
    _, dev_utts = build_datasets(config)
    loader = make_eval_loader(config, dev_utts, tokenizer)
    png = not args.no_png and _have_matplotlib()

    os.makedirs(args.out, exist_ok=True)
    by_id = {u.utt_id: u for u in dev_utts}
    written = []
    for b in loader.epoch(0):
        batch = {"audio": b.audio, "audio_len": b.audio_len,
                 "labels": b.labels}
        att, enc_len = attention_maps(model, config, batch, cmvn_stats,
                                      device)
        for row, utt_id in enumerate(b.utt_ids):
            n_tok = int(b.label_len[row]) + 1  # + eos position
            a = att[row, :n_tok, : int(enc_len[row])]
            base = os.path.join(args.out, utt_id)
            np.save(base + ".npy", a)
            if png:
                save_plot(base + ".png", a, by_id[utt_id].text)
            written.append(utt_id)
            if len(written) >= args.num:
                break
        if len(written) >= args.num:
            break
    summary = {"event": "attention_plots", "out": args.out, "utts": written,
               "png": png}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
