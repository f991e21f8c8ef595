"""Train CLI: ``python -m gluon_e2e_asr_tpu_torch.train --config <yaml>
[--set key=value] [--device cuda]``.

Counterpart of ``gluon_e2e_asr_tpu/train.py``: the same flags
(``--config``, ``--workdir``, ``--max-steps``, ``--set``) and
``--device`` and ``--resume`` (continue from the newest checkpoint of
``train.ckpt_dir``, exactly where it stopped, mid-epoch too). Hybrid
CTC/attention training (``loss.mtl_alpha < 1``, dot, add or
location-aware attention, one decoder layer or stacked ones), or CTC
alone at ``loss.mtl_alpha=1.0``; the ``blstm`` encoder or, for
``enc_type: vggblstm``, the VGG2L conv front before it; every training
option of the JAX trainer (Adam, SGD or Adadelta, gradient
accumulation, encoder dropout, plateau annealing, early stopping,
mid-epoch checkpoints, profiling). On a CUDA device the encoder runs the
hand-written kernels K1-fwd and K1-bwd, the CTC loss K2 and K3, the
attention decoder K4-fwd and K4-bwd (in the config's attention mode:
dot, add or loc; a stacked decoder runs plain torch, as the JAX package
runs its scan there), and, where ``frontend.impl`` is ``pallas`` or
``pallas_regrid``, the fused frontend K5 or K6; on the CPU their plain
versions. Writes ``<workdir>/metrics.jsonl`` and checkpoints under
``<workdir>/<train.ckpt_dir>/`` (``ckpt_<step>.pt``, ``best.pt``), which
``gluon_e2e_asr_tpu_torch.decode`` reads; prints one ``done`` JSON line.

``train.dp: true`` (the flagships and milestone 4 ship it) trains data
parallel, one process per device: ``torchrun --nproc_per_node=N -m
gluon_e2e_asr_tpu_torch.train --config <yaml> --device cuda`` runs rank r
on ``cuda:r`` (NCCL); without torchrun the process is a world of one on
the same code path (gloo on ``--device cpu``). Rank 0 writes the
metrics and checkpoints and prints the line.
"""

from __future__ import annotations

import argparse
import json

import torch

from gluon_e2e_asr_tpu_torch.config import Config, apply_overrides, load_config
from gluon_e2e_asr_tpu_torch.training.trainer import Trainer


def main(argv=None):
    p = argparse.ArgumentParser(description="E2E ASR training (PyTorch port)")
    p.add_argument("--config", type=str, default="", help="yaml config path")
    p.add_argument("--workdir", type=str, default=".", help="output directory")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in "
                        "<workdir>/<train.ckpt_dir>")
    p.add_argument("--max-steps", type=int, default=0,
                   help="override train.max_steps (0 = keep config)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VAL",
                   help="dotted config override, e.g. loss.mtl_alpha=1.0 "
                        "(repeatable)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device: cuda (the kernels; with train.dp, "
                        "cuda:LOCAL_RANK) or cpu (their plain versions)")
    args = p.parse_args(argv)

    config = load_config(args.config) if args.config else Config()
    apply_overrides(config, args.set)
    if args.max_steps:
        config.train.max_steps = args.max_steps
    device = torch.device(args.device)
    if device.type == "cuda":
        # The frontend's DFT and mel products must run in true f32.
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    # With train.dp the trainer joins the ranks (and takes cuda:LOCAL_RANK)
    # before it builds anything.
    trainer = Trainer(config, workdir=args.workdir, device=device)
    if args.resume:
        trainer.maybe_resume()
    final = trainer.train()
    if trainer.world.is_main:
        print(json.dumps({"event": "done", "step": trainer.state.step,
                          **final}, default=float))
    return trainer


if __name__ == "__main__":
    try:
        main()
    finally:
        # The process group train.dp joined, if any.
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
