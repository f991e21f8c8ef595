#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA card (H100).

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA device, ``nvcc`` and ``nvidia-smi``; it imports no JAX. (``python3
chip_smoke.py --dp-worker <dir>`` is one rank of phase 7b, which starts
its ranks itself; ``--traces <out>`` the child process of phase 8;
``--deterministic <out>`` that of phase 6e.)
Phases, each printing JSON lines:

1. device: the card, and ``nvidia-smi``'s name and power limit;
2. build: every CUDA library of the port's paths (``bilstm_fwd``,
   ``bilstm_bwd``, ``ctc``, ``las_decoder``, ``frontend``,
   ``pipeline_probe``) from ``csrc/``, one nvcc each, in parallel; then
   the host library ``native/asr_native.cpp`` (g++), its seconds;
3. kernels: each kernel against its plain PyTorch version on the card,
   within stated tolerances, at the shapes the flagship model
   (``configs/english_flagship.yaml``, the 4.0 s bucket, B=96) gives it:
   K1-fwd in f32 and bf16 in its serving and training forms, K1-bwd in
   f32 and bf16 (both also at milestone 2's layer shapes, B=16, H=256,
   and with B=50 and K1-fwd with B=1; every call of either through its
   cluster recurrence, and K1-bwd's dg alone against the plain sweep;
   both also at vgg_blstm's layer 0, D = 2560);
   K1-bwd's products (dx, dW_x, dW_h, db: bf16 on wgmma) through their own
   entry against their plain twin on the recurrence's dg at the
   flagship's three layers, milestone 2's, vgg_blstm's layer 0 and ragged
   shapes (B=1 and T=1,
   every length 1, odd widths); K1-fwd's bf16 projection (on wgmma)
   through its own entry against its plain twin at the flagship's three
   layers, vgg_blstm's layer 0 and ragged shapes (B=1 and T=1, every length 1, D=33 with
   H=130, H=256), with round_xg off and on; the f32 route of both
   (``csrc/gemm_f32.cuh``'s ``ring_kernel``) at the milestones' three
   layers (B=16, H=256) and the same ragged shapes, within
   ``TOL_BWD["float32"]``, dx and the projection's backward half exactly 0
   past lens; K2 and K3 (the warp design,
   ``ctc_alpha_warp_kernel`` and ``ctc_beta_post_warp_kernel``, the only
   kernels of the library) on a real training batch's lattice, at
   bench.py's shape (T=320, S=193), B=1, T=1, S=641 and 1024 (several warps
   a row) and a lattice with a row of length 0, an infeasible row and a
   time mask that is not a prefix, K4-fwd
   and K4-bwd in dot mode in f32 and bf16 with the scheduled-sampling
   coins off and on, on that batch's labels and encoder lengths; then
   K4-fwd and K4-bwd in add and loc mode the same way at the shapes of
   the location-aware flagship (``configs/flagship_bf16.yaml``: C=10
   channels of a width-100 filter), every cotangent checked, the
   filter's through the band; and loc once at bench.py's T'=320; every
   K4-fwd and K4-bwd call through its cluster kernel
   (``fwd_cluster_kernel``, ``bwd_cluster_kernel``); K5 and
   K6 (the fused frontend) at milestone 2's two buckets, the flagship's
   4.0 s bucket and bench.py's shape, on a batch of hard audio (tones,
   digital silence, a -60 dB stretch) at milestone 2's 4.0 s bucket, all
   through ``fft_kernel``, and with n_fft = 400 through
   ``spectral_kernel``, in every CMVN mode, eval and train;
   K7-fwd and K7-bwd (the v1 layer) at the flagship's layer-0 shape in
   f32, in bf16 and with bf16 projections and f32 compute (the backward
   recomputes the gates from the rounded h stream first, as the TPU
   kernel does: ``bilstm_v1_gates``); P1's two variants (``l2``, ``cluster``) and cuDNN's
   LSTM against P1's plain version at (M, N) = (96, 2) and (256, 4),
   T=640; K1-bwd's products also at ls100_full's 18.38 s bucket (B=32,
   T=1836, layer 0) in bf16; every
   kernel of the training path (K1 in every form and dtype at every
   shape above, its products and projections, K2, K3, K4-fwd and K4-bwd
   in every mode, K4-bwd also with its weight gradients, and K4's
   two-rows kernels at K4_ROWS_SHAPES, K5, K6, K7; K1 in both forms and
   dtypes also at ls100_full's 18.38 s layer 0, where phase 12 holds it
   to the plain versions)
   launched REPEATS times on identical inputs, every output
   ``torch.equal`` to the first launch's (``--only 3`` runs this phase
   alone);
4. serving slice: a seeded random full-width checkpoint of that model,
   decoded greedily through ``gluon_e2e_asr_tpu_torch.decode.main`` over
   the config's dev set; every kernel must have been launched (every
   K1-fwd launch through the cluster recurrence), and only the
   kernels; the encoder output on the card is held against the
   plain versions on the CPU for a few utterances;
5. serving timing: CUDA events, median of 10 runs after warm-up, K1-fwd
   whole, its recurrence alone in both forms (held against the plain
   recurrence on the same projection) and its projection alone, each
   through its own entry;
6. training slices: ``gluon_e2e_asr_tpu_torch.train.main`` at full
   width on the flagship config as shipped (hybrid CTC/attention, dot
   attention, ``train.dp: true``: data parallel at world size 1 over
   NCCL, as every flagship slice) for two epochs: the launch counts of
   all six kernels (every K1-bwd launch of every slice through the
   cluster recurrence, every bf16 K1-fwd launch through the wgmma
   projection, every K4-fwd and K4-bwd launch of the dot, loc and add
   slices through its cluster kernel), no plain call, a finite and falling loss, the
   attention loss and accuracy logged, a checkpoint (every K1-fwd and
   K7-fwd launch of every slice and decode through the cluster
   recurrence too); a CTC-only run
   (``loss.mtl_alpha=1.0``) of a few steps; the location-aware flagship
   (``flagship_bf16.yaml``) for two epochs, K4 in loc mode on every step
   and each epoch's dev evaluation through the beam as shipped (K=10,
   ctc_weight 0.3); a few steps of it with add attention; milestone 2
   (``configs/milestone2_fused_frontend.yaml``, K5 on every step and dev
   batch, every launch through ``fft_kernel``) for two epochs and a
   greedy decode of its checkpoint, and a few steps with
   ``frontend.impl=pallas_regrid`` (K6, the same); the tiny golden
   decoded greedily through K5 (``golden_greedy.jsonl``, 16/16); and K7's
   own path, ``bilstm_pallas`` forward and backward;
6b. milestones 1, 3, 4 and 5 (``configs/milestone*.yaml``) through the
   train CLI as shipped, no override, for their first epoch with its dev
   evaluation by the config's method (milestone 3: the attention-only
   beam, K=8; milestone 4 at ``train.dp``, world size 1 over NCCL): the
   launch counts (no K2 or K3 at milestone 3's ``mtl_alpha`` 0; every K1
   and K4 launch through the cluster kernels), no plain version, a
   finite and falling loss; each checkpoint decoded through the decode
   CLI by the config's method (greedy for 1 and 4; the beams of 3 and of
   5, K=10 with ctc_weight 0.3 and length normalization, on the first
   MILESTONE_BEAM_UTTS dev utterances); a step at the 4.0 s bucket and a
   decode of that batch by the config's method, timed; every f32 K1-fwd
   and K1-bwd launch through ``ring_kernel`` (phase 8 profiles milestone
   5's f32 step by kernel name: ``ring_kernel`` 4 launches a layer, none
   of the first kernels);
6c. the training options on milestone 4's model (f32, loc, B=16, as
   shipped at ``train.dp``, world size 1): resume (RESUME_REFS
   uninterrupted runs of 2 epochs with ``ckpt_every_steps``, a run
   stopped mid-epoch by ``max_steps`` and resumed through ``train.py
   --resume``: the same steps and batches, and every parameter, Adam
   slot and the generator state ``torch.equal`` to the uninterrupted
   run's, as the uninterrupted runs are to each other);
   ``accum_grad_steps=2`` (two halves of a 4.0 s batch against the whole
   batch from a trained state, through the kernels, within phase 7's
   tolerances; an epoch counts ceil(batches / 2) updates); a few steps of
   sgd and of adadelta; ``eps_decay`` with ``plateau_restore_best`` and
   ``early_stop_patience`` on scripted dev WERs; a ``profile_dir`` trace
   holding K1's recurrence kernels; an epoch with ``enc_dropout=0.1``;
   an epoch with ``dec_layers=2`` (no K4 launch: the stacked decoder is
   plain torch) and its checkpoint decoded greedily and by the beam;
6d. ``configs/vgg_blstm.yaml`` as shipped (B=96, bf16, loc, the VGG2L
   front): an epoch with its dev evaluation by its beam, the launch
   counts, the checkpoint decoded by the beam; K1 at its layer 0 (D =
   2560, checked in phase 3 in every form) timed against the plain
   versions, its bound and cuDNN's bidirectional LSTM; a step at the 4.0 s bucket with the VGG front's
   share (profiler, and the front alone by CUDA events) and a beam decode
   of that batch, timed;
6e. reproducibility: each of REPRO_CASES (the dot and loc flagships at
   bench.py's shape, add attention, vgg_blstm, milestone 5 in f32, and
   on milestone 4 the stacked decoder and gradient accumulation) run twice for REPRO_STEPS updates from the
   same seed through the kernels, every parameter, gradient, optimizer
   slot and the generator state ``torch.equal``; then a step of each in
   a child process (``--deterministic``) under
   ``torch.use_deterministic_algorithms(True)`` with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, which must pass and run none of
   ACCUMULATING_OPS on the card and no cuDNN convolution backward outside
   cuDNN's deterministic algorithms;
7. training reference: one hybrid step of the trained dot and loc models
   (scheduled sampling off) through the kernels and through the plain
   versions on the card (same batch, parameters, optimizer state and
   SpecAugment draws): loss, every gradient and the parameters after
   Adam;
7b. data parallelism: two processes on the one card (this script with
   ``--dp-worker``, as torchrun starts ranks) join over gloo with CUDA
   tensors (NCCL refuses two ranks on one device) and take one step of
   the trained location-aware flagship as shipped (SpecAugment and the
   coins on), on its 4.0 s batch and on that batch with rank 1's rows all
   padding: loss, every gradient and the parameters after Adam against
   the same step at world size 1 within phase 7's tolerances; a greedy
   decode of the dev set through the decode CLI at ``decode.dp`` and a
   beam search of a dev batch, every text as at world size 1;
8. training timing (run before 7 and 7b; its one-call traces, K2's,
   K3's, K5's and K6's device times and milestone 5's f32 profile are
   taken in a fresh child process, this script with ``--traces``: late
   in a long run this process's traces came back short or empty): each
   training kernel against its plain version and
   beside the one PyTorch call that computes the same function where
   there is one (cuDNN's LSTM for K1, ``F.ctc_loss`` for K2/K3,
   ``torch.addmm`` for K1-fwd's projection), K1-bwd's recurrence alone
   beside the whole call, K2 and K3 also by their device time
   (torch.profiler) and at bench.py's shape, with a trace of five calls of
   each holding its kernel and no other device operation, K1-bwd's
   products through their own entry
   beside cuBLAS on the same bf16 operands, K1-fwd's projection through
   its own entry beside ``torch.addmm`` on the same bf16 operands, K1's
   f32 products and projection at the milestones' three layers on
   ``ring_kernel``, plain and beside cuBLAS in f32 (TF32 off), with their f32 bound and TFLOP/s, milestone 5's f32
   step by kernel (torch.profiler; the share of ``ring_kernel``), K4 in
   its three modes, K5 and K6 (also by their device time, with a trace
   of five calls holding ``fft_kernel`` and no other device operation)
   beside the jnp path and ``torch.stft``, K7,
   the milestone 2 step and its frontend's share, the dot and loc hybrid
   train steps at the 4.0 s
   bucket and at bench.py's shape (B=96, 12.8 s, 96 labels), each also
   as shipped (``train.dp``, world size 1), the model's TFLOP/s and MFU
   of both at the latter (``utils/flops.py``: bench.py's count over the
   H100's dense peak), and a
   torch.profiler breakdown of both at the latter by kernel, whose CTC
   kernels must be one launch each of K2's and K3's warp kernels a step;
9. beam search: the blessed tiny golden (read from its JAX checkpoint
   without JAX) decoded with ``--method beam`` through the decode CLI on
   the card must reproduce ``tests/goldens/golden_beam.jsonl``; and one
   beam decode of a 96-utterance 4.0 s batch of the trained loc model,
   timed as frontend, encoder and search;
10. P1, the pipelining probe: its entry point
   (``python -m gluon_e2e_asr_tpu_torch.tools.pipeline_probe``) over
   M = 96 and 128, N = 1..4, both variants, the counts reset just before
   and read just after; the plain version and cuDNN's LSTM timed at the
   same shapes;
11. the external LM and forced alignment on ``configs/english_m5.yaml``
   as shipped (256 units, loc, hybrid; beam K=10, ctc_weight 0.3,
   length normalization): M5_EPOCHS of its 60 epochs through the train
   CLI (the launch counts, K1-bwd, K2/K3 and K4 loc on every step); the
   LM corpus (``tools/make_lm_corpus.py``) and ``train_lm.py`` at
   LMConfig's width (E 256, H 512, 2 layers, B 64, max_len 128) for
   LM_EPOCHS of its 20 epochs: the dev perplexity falls and ends below
   V, and one LM train step is timed; the LM's step loop against its
   forward and its batched log-probabilities against per-row ones on the
   card; MILESTONE_BEAM_UTTS dev utterances decoded by the beam through
   the decode CLI without and with the LM (``decode.lm_ckpt``,
   ``lm_weight`` 0.3, ``nbest`` 10), both WERs printed; on one dev batch
   the fused beam at weight 0 equal to the unfused one bit for bit, the
   fused beam through the kernels equal to it through plain_route()
   (texts, scores within TOL_FUSED_SCORE), both beams timed;
   ``tools/rescore_nbest.py`` on both decodes' records;
   ``transcribe.py --timestamps`` on wav files of synth_batch audio (one
   past the largest bucket): monotone spans inside each file;
   ``tools/align.py --ctm``; ``ctc_viterbi_align`` on the card against
   the CPU (states identical); an alignment batch timed. K1-fwd's
   launches in the fused beam, transcribe and align, the training
   kernels' in english_m5's epochs, each counted from 0 around its path;
12. ``configs/ls100_full.yaml`` (the LibriSpeech-100h recipe: BPE 128,
   global CMVN, speed perturbation, SortaGrad, dynamic buckets to 18.38 s,
   int16 transfer, loc, bf16) from a FLAC corpus on disk: the port's
   ``tools/make_synth_corpus.py`` with the config's flags, cut to
   LS100_TRAIN + LS100_DEV utterances (three files decoded to exactly the
   encoder's PCM); ``tools/compute_cmvn.py`` on the train split at int16
   and at float32 (within TOL_CMVN, finite, std > 0); on the first batch
   of the largest bucket from the native loader, K1-fwd and K1-bwd at
   layer 0 (T = 1836), K2/K3 (T' = 459, S = 641) and K4-fwd/K4-bwd loc
   (coins off and on) against their plain versions with phase 3's
   tolerances, the routes ``fwd_route``/``bwd_route`` predict (the cluster
   kernels at every ls100 bucket), each timed beside its bound; that
   batch through the loader's native and Python routes, bit-equal, int16
   and float32, with and without speed perturbation, and an epoch's host
   throughput; LS100_EPOCHS epochs through the train CLI as shipped but
   for the corpus, the stats file and the epoch count (the launch counts,
   every batch through the native route, the loss per label token
   falling, data_skipped, a step at each bucket and the epoch-end beam
   timed); ``tools/average_ckpts.py`` over the two epoch checkpoints
   (each parameter their mean), the decode CLI's beam on the average and
   the last, ``tools/tune_decode.py``'s 2x2 grid, ``tools/
   plot_attention.py --no-png`` (shapes [n_tokens+1, T'], rows summing to
   1) and ``transcribe.py`` on two of the corpus's .flac files (the decode
   CLI's texts). ``tools/run_milestones.py`` is not run here (it trains
   the five milestones for every epoch): phase 15 runs it.

Four phases run only when asked for (``--only``), each a chip call of
its own:

13. ``configs/ls100_shape.yaml`` (the LibriSpeech-100h dress rehearsal:
   dynamic batches 148 / 74 / 49 / 32 at the 4 / 8 / 12 / 18.5 s buckets,
   speed perturbation, float32 transfer): the disk free, its corpus
   rendered with its header's flags and cut to LS_SHAPE_TRAIN +
   LS_SHAPE_DEV utterances, ``tools/compute_cmvn.py``, LS_SHAPE_EPOCHS
   epoch through the train CLI (phase 6's launch counts); each bucket's
   B, T, T', L and K1's and K4's cluster plans at that B, a step timed;
   at the 4 s bucket's batch (B = 148) K1 at every layer, K2/K3 and K4
   loc against their plain versions at phase 3's tolerances and a train
   step against the plain one at phase 7's;
14a-14d. one config each (``english_flagship``, ``milestone5_beam``,
   ``english_m5_bpe``, ``flagship_bf16``) trained as shipped to
   convergence (every epoch, the dev evaluation picking best.pt; ``--set
   train.seed=N`` the only override, for a second seed), with phase 6's
   launch checks; best.pt decoded over the 192 dev utterances by the
   config's beam; the records held to the TPU run's record of the same
   utterances under ``docs/evidence/`` (refs equal 192/192, else the
   comparison is void and the phase fails): WER and CER with 95%
   bootstrap intervals and the paired difference port - TPU with its
   interval and p(diff >= 0) (``tools/convergence.py`` over the port's
   ``tools/wer_ci.py``: 10,000 resamples, seed 0); the records printed a
   line each and written to ``build/chip_smoke/``, beside the run's epoch
   lines (``<record>_epochs.jsonl``: dev WER/CER, the mean loss of the
   epoch's steps and of its logged lines). Where the config decodes by the
   joint beam, best.pt also by each branch alone (``ctc_beam``; ``beam``
   with ``decode.ctc_weight=0``), each with its intervals and paired
   against the joint beam's and the TPU record (``<record>_{ctc,att}``);
15. ``tools/run_milestones.py --device cuda``: the five milestones as
   shipped, every epoch, each best.pt decoded over the 192 dev utterances
   by its config's method; no plain call; each milestone's steps, train
   seconds, best epoch, WER and CER with 95% intervals, m5 also paired
   with the TPU run's record; the records written to
   ``build/chip_smoke/milestones_<m>_h100_dev192.jsonl``;
16. ``configs/ls100_full.yaml`` as shipped at its own scale: 28,500 train
   + 2,700 dev utterances (101.3 h of FLAC audio), its 5 epochs. The disk
   free where the corpus goes (it must hold the corpus's 11.7 GB of
   16-bit PCM and LS100_FULL_SPARE_BYTES for the stats and checkpoints);
   the corpus rendered with the config's header flags on every core
   (three files decoded to exactly the encoder's PCM; the render's
   seconds, hours and manifest walk), its walk equal to the utterances
   drawn from the texts alone (``ls100_full_manifest``); the dev refs
   equal to the TPU run's record's, 2,700/2,700, before any training;
   ``tools/compute_cmvn.py`` at int16; the train CLI as shipped but for
   the corpus, the stats path and LS100_FULL_EVAL (a greedy per-epoch
   evaluation: the config's beam six times would not fit a chip call),
   with phase 6's launch counts and no plain call, one line an epoch
   (steps and pad waste, which must equal the TPU table's; occupancy; the
   training part's seconds and utt/s; the evaluation's seconds; dev WER
   and CER; checkpoint save seconds; peak RSS; disk free); the trained
   kernels against their plain versions on the first batch of each
   bucket; best.pt (and the last checkpoint, where the greedy evaluation
   picked another epoch) decoded by the config's beam over the 2,700 dev
   utterances, the p50 latency, the records paired with the TPU record
   (a tie, a gap, or a fault: the paired interval wholly above +3
   points). The records go to ``build/chip_smoke/
   ls100_full_h100_dev2700.jsonl`` beside their epoch lines. ``--only
   16a`` stops after the CMVN with one timed dev evaluation of the
   untrained model, by the beam and greedily: the cost of an evaluation.

Then the kernels line (each kernel's launches on the main path, error,
time, plain time, bound and library time; also each row's launches in
vgg_blstm's epoch, in the dropout and stacked-decoder runs and on phase
11's and 12's paths, K1's rows at D = 2560 with cuDNN's time, and K1's,
K2's, K3's and K4 loc's numbers at ls100's largest bucket) and, last,
``{"ok": true, "device": {...}}``. Any
failed check exits non-zero before the last line. Artifacts go to
``build/chip_smoke/``. ``python3 chip_smoke.py --only 3,6c,6d,6e,11,12`` runs
the build and those phases alone (``--only 13``, ``--only 14a [--set
train.seed=1]``, ``--only 15``, ``--only 16``, ``--only 16a``: the phases
above), reports every failed check and prints neither the kernels line
nor the last line.
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
# Milestones 1, 3, 4 and 5, trained and decoded as shipped (milestone 2 is
# M2_CONFIG's slice).
MILESTONES = {n: os.path.join(REPO, "configs", f"{f}.yaml") for n, f in (
    (1, "milestone1_bilstm_ctc"), (3, "milestone3_las"),
    (4, "milestone4_hybrid_dp"), (5, "milestone5_beam"))}
VGG_CONFIG = os.path.join(REPO, "configs", "vgg_blstm.yaml")
M5_CONFIG = os.path.join(REPO, "configs", "english_m5.yaml")
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
# f32: sum order (the weight gradients sum split-K partial tiles in
# another order than the plain version). bf16: as above, and the kernel reads the activations the
# forward saved while the plain version recomputes them, so a rounding
# of dg to bf16 can also flip.
TOL_BWD = {"float32": 1e-4, "bfloat16": 3e-2}
# K1-bwd's products (dx, dW_x, dW_h, db) through their own entry against
# their plain twin on the same dg: both round the operands to bf16 and sum
# in f32 (db over the unrounded dg), so only the order of the sums
# differs (the weight gradients' split-K parts among it): max abs
# difference over each output's largest magnitude, TOL_BWD's f32 entry.
TOL_PRODUCTS = TOL_BWD["float32"]
# the products' ragged shapes: (name, B, T, D, H, every length 1)
PRODUCTS_RAGGED = (("B=1, T=1", 1, 1, 80, 256, False),
                   ("lens of 1", 8, 150, 1280, 256, True),
                   ("odd widths", 5, 37, 33, 130, False))
# K1-fwd's bf16 projection through its own entry against its plain twin:
# both round the operands to bf16 and sum in f32, so only the order of
# the sums differs: max abs difference over the output's largest
# magnitude, as for the products. With round_xg each element may also
# differ by one bf16 ulp of itself (BF16_ULP), where the two f32 sums fall
# on either side of a rounding boundary.
TOL_PROJ = TOL_BWD["float32"]
# the projection's ragged shapes: (name, B, T, D, H, every length 1)
PROJ_RAGGED = (("B=1, T=1", 1, 1, 80, 320, False),
               ("lens of 1", 8, 150, 1280, 320, True),
               ("odd widths", 5, 37, 33, 130, False),
               ("H=256", 16, 199, 512, 256, False))
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
MILESTONE_BEAM_UTTS = 48  # the dev subset a milestone's beam decode takes
DP_WORLD = 2  # ranks of the data-parallel check, on the one card
# Phase 6c: milestone 4's model for the training options; the runs whose
# dev WERs are scripted (plateau annealing, early stopping) and the
# profiled run take SMALL_TRAIN utterances (4 steps an epoch).
SMALL_TRAIN = 64
OPT_STEPS = 8  # sgd, adadelta and the stacked decoder train this many steps
# A resumed run against an uninterrupted one on the card: equal bit for bit
# in every parameter, Adam slot and generator state, as are RESUME_REFS
# uninterrupted runs to each other (a training step on the card is a
# function of its inputs: no float atomics on the gradient path).
RESUME_REFS = 2
# Phase 6e: the training forms held to two identical runs of REPRO_STEPS
# steps from one state (name, config, overrides, batch: "bench" for
# bench.py's, else the config's 4.0 s bucket), each run equal bit for bit
# in every parameter, gradient, optimizer slot and generator state; the
# same forms take a step each in a child process under
# torch.use_deterministic_algorithms(True) (``--deterministic``).
REPRO_STEPS = 3
REPRO_CASES = (
    ("dot flagship, bench.py", CONFIG, (), "bench"),
    ("loc flagship, bench.py", LOC_CONFIG, (), "bench"),
    ("add attention, flagship_bf16", LOC_CONFIG, ("model.att_type=add",),
     "bucket"),
    ("vgg_blstm", VGG_CONFIG, (), "bucket"),
    ("milestone 5 (f32, loc)", MILESTONES[5], (), "bucket"),
    ("stacked decoder, milestone 4", MILESTONES[4], ("model.dec_layers=2",),
     "bucket"),
    ("accumulation, milestone 4", MILESTONES[4],
     ("train.accum_grad_steps=2",), "bucket"),
)
# Library operations whose CUDA kernels add into one address in an order
# that varies from run to run (unless torch.use_deterministic_algorithms
# picks another kernel): none may run on the card in a training step.
ACCUMULATING_OPS = ("index_add", "scatter_add", "scatter_reduce",
                    "index_reduce", "embedding_bag", "_embedding_bag_backward",
                    "bincount", "histc")
# VGG2L's convolutions and pools among a step's device kernels, by name:
# cuDNN's (its layout transposes among them), the implicit-GEMM
# convolutions and the pools. Its ReLUs, re-zeroing and bias sums run as
# PyTorch's generic elementwise and reduction kernels, which other
# operations share: they are not counted.
VGG_KERNELS = ("cudnn", "implicit_gemm", "implicit_convolve", "max_pool")
# Phase 11: english_m5.yaml trains M5_EPOCHS of its 60 epochs; its LM
# (LMConfig's width: E 256, H 512, 2 layers, B 64, max_len 128) LM_EPOCHS
# of lm.num_epochs 20; the beam fuses it at LM_WEIGHT with an n-best list
# of LM_NBEST; transcribe takes N_WAVS files of synth_batch audio and one
# of LONG_WAV_SEC, past the config's largest bucket (4.0 s).
M5_EPOCHS, LM_EPOCHS, LM_WEIGHT, LM_NBEST = 2, 4, 0.3, 10
N_WAVS, LONG_WAV_SEC = 3, 5.5
# The LM on the card, f32 with TF32 off: step loop against the forward's
# logits, the batched log-probabilities against the per-row ones (only
# the order of the sums differs).
TOL_LM = 1e-4
# The fused beam through the kernels against it through plain_route() on
# the same batch (english_m5 is f32: K1-fwd and its plain version differ
# by sum order, about 1e-6 in the encoder's outputs): the same texts, the
# scores (sums of about 20 steps' log-probabilities) within this.
TOL_FUSED_SCORE = 1e-3
# Viterbi on the card against the CPU on the same log-probabilities: the
# gather is exact and the recursion adds and compares, so the states are
# identical and the scores within this.
TOL_VITERBI_SCORE = 1e-5
N_TIMED = 10
N_TIMED_PLAIN_STEP = 3  # the plain train step takes seconds
REPEATS = 3  # phase 3: launches of each kernel on identical inputs
BENCH_SEC, BENCH_LABELS = 12.8, 96  # bench.py's shape
# Phase 12: ls100_full.yaml's corpus as its header renders it (English
# text, LibriSpeech durations, the sentence split), cut from 28,500 train +
# 2,700 dev utterances to LS100_TRAIN + LS100_DEV, trained LS100_EPOCHS of
# its 5 epochs; tune_decode sweeps LS100_GRID. The joint beam is bound by
# the host (a loop over T' frames for each of 0.5 T' output steps: a dev
# pass took 32 s over 64 utterances, 21-27 s over 16 or 8, each of them
# mostly the one 12.6 s utterance, the first), and the phase runs eight
# such passes (two evaluations, two decodes with their warm passes, two
# of tune_decode's combinations), so the dev render is cut to 4, the
# fewest that plot_attention's 4 need.
LS100_CONFIG = os.path.join(REPO, "configs", "ls100_full.yaml")
LS100_RENDER = {"text_mode": "english", "durations": "librispeech",
                "jitter": 0.04, "noise": 0.05, "pool_split": "sentence",
                "seed": 0}
LS100_TRAIN, LS100_DEV, LS100_EPOCHS = 512, 4, 2
LS100_GRID = ("beam_size=5,10", "ctc_weight=0.0,0.3")
LS100_PLAIN_RUNS = 2  # the plain versions at the largest bucket take seconds
# The int16 and float32 CMVN stats: the same audio (int16 transfer is an
# exact inverse of the decoder's /32768), the log-mel on the card with TF32
# off, the moments summed in f32 over batches that differ only in dtype:
# max abs difference of mean and std.
TOL_CMVN = 1e-4
# plot_attention's rows: softmax weights summed in f32.
TOL_ATT_ROW = 1e-5
# Phase 13: ls100_shape.yaml (the LibriSpeech-100h dress rehearsal: dynamic
# batches 148 / 74 / 49 / 32 at its 4 / 8 / 12 / 18.5 s buckets, speed
# perturbation, float32 transfer) from a corpus rendered with its header's
# flags, cut from 5,000 train + 512 dev utterances to LS_SHAPE_TRAIN +
# LS_SHAPE_DEV (every bucket keeps a batch: 1, 2, 7 and 17 in epoch 0) and
# from 8 epochs to LS_SHAPE_EPOCHS.
LS_SHAPE_CONFIG = os.path.join(REPO, "configs", "ls100_shape.yaml")
LS_SHAPE_RENDER = {"text_mode": "english", "durations": "librispeech",
                   "jitter": 0.04, "noise": 0.05}
LS_SHAPE_TRAIN, LS_SHAPE_DEV, LS_SHAPE_EPOCHS = 1000, 4, 1
LS_SHAPE_BYTES = 400e3  # an upper bound on one rendered FLAC file
# Phase 16: ls100_full.yaml as shipped at its own scale, LS100_FULL train +
# dev utterances (101.3 h) for its 5 epochs, and its best checkpoint's
# decode of the 2,700 dev utterances paired with the TPU run's record of
# them (LS100_FULL_RECORD: round 5's, WER 0.0801; its summary sidecar
# still holds round 4's 0.0671). LS100_FULL_TPU: the TPU run's epoch table
# (BASELINE.md, "Round-5 epoch table").
LS100_FULL = (28500, 2700)
LS100_FULL_RECORD = "ls100_dev_decode_r5"
LS100_FULL_NAME = "ls100_full_h100_dev2700"
LS100_FULL_TPU = {"steps": (674, 674, 673, 673, 673),
                  "pad_waste": (0.1184, 0.1185, 0.1174, 0.1171, 0.1169),
                  "dev_wer": (0.6904, 0.1947, 0.1239, 0.0943, 0.0801),
                  "dev_cer": (0.4545, 0.0707, 0.0418, 0.0296, 0.0251)}
# A fault: the paired interval port - TPU wholly above +3 points (phase
# 14's +10 points at WER 0.25 is about as large relative to 0.08; twice the
# 1.3 points between the TPU's two rehearsals, 0.0671 and 0.0801).
LS100_FULL_FAULT = 0.03
# Beside the corpus (its 16-bit PCM, counted from the texts): the CMVN
# stats and the checkpoints the run keeps (train.keep_ckpts and best.pt,
# the parameters and two Adam moments in f32: about 0.1 GB each).
LS100_FULL_SPARE_BYTES = 2e9
# The per-epoch dev evaluation: greedy in place of the config's beam, so
# that the run fits one 60-minute chip call. The beam ran 319.9 s over the
# 2,700 (--only 16a on an H100; every batch runs to its length limit, 6,649
# output steps, trained or not, as the TPU's decode did), so six beam
# passes with the render and the training would take about 54 minutes.
# The evaluation only picks best.pt here (eps_decay 0, plateau_restore_best
# off, early_stop_patience 5 cannot fire in 5 epochs); best.pt and the last
# checkpoint are decoded by the beam.
LS100_FULL_EVAL = ("decode.method=greedy",)
# Phase 14: each config trained as shipped to convergence and its best
# checkpoint's dev decode held to the TPU run's record of the same 192
# utterances (tools/convergence.py; one id a chip call): id -> (config,
# the TPU record under docs/evidence/).
CONVERGENCE = {"14a": ("english_flagship", "english_clean_flagship_dev192"),
               "14b": ("milestone5_beam", "m5_beam_dev192"),
               "14c": ("english_m5_bpe", "english_clean_bpe_beam_dev192"),
               "14d": ("flagship_bf16", "flagship_loc_dev192")}
# Phase 15: the milestones with a per-utterance TPU record under
# docs/evidence/ (the others are compared by their intervals alone).
MILESTONE_RECORDS = {"m5": "m5_beam_dev192"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


FAILED = []  # with --only, the checks that failed (the run goes on)


def check(ok: bool, msg: str) -> None:
    if not ok:
        if main_only:
            FAILED.append(msg)
            print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
        else:
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


def host_ms(torch, fn, n=N_BEAM_TIMED) -> float:
    """Median host-clock time of ``fn`` over ``n`` runs after one warm
    run, synchronized before and after each."""
    fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
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


def tensors_of(out) -> list:
    """The tensors of a kernel's result (tuples, lists and dicts walked in
    order; other values dropped)."""
    if hasattr(out, "data_ptr"):
        return [out]
    if isinstance(out, dict):
        out = [out[k] for k in sorted(out)]
    if isinstance(out, (tuple, list)):
        return [t for o in out for t in tensors_of(o)]
    return []


REPEATS_SEEN = []  # phase 3's repeat checks, emitted together


def repeats_equal(torch, name, at, call) -> None:
    """Phase 3: ``call`` (a kernel's entry on inputs it does not change)
    REPEATS times; every output of every launch must be ``torch.equal`` to
    the first launch's: a training step on the card is a function of its
    inputs alone (no float atomics, no order that depends on timing)."""
    outs = []
    for _ in range(REPEATS):
        outs.append([t.detach().clone() for t in tensors_of(call())])
    torch.cuda.synchronize()
    first, diff, same = outs[0], 0.0, True
    for o in outs[1:]:
        for a, b in zip(o, first):
            if not torch.equal(a, b):
                same = False
                if a.is_floating_point() and a.shape == b.shape:
                    diff = max(diff, float((a - b).abs().nan_to_num(
                        float("inf")).max()))
        same = same and len(o) == len(first)
    REPEATS_SEEN.append({"kernel": name, "at": at, "outputs": len(first),
                         "equal": same, "max_abs_diff": diff})
    check(same, f"{name} at {at}: {REPEATS} launches on identical inputs "
                f"differ (max abs {diff})")


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
               "bilstm_fwd_projection": K.bilstm_fused_proj_kernel,
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
              "bilstm_fwd_projection": K.bilstm_fused_proj_plain,
              "ctc_alpha": C._alpha_plain,
              "ctc_beta_post": C._beta_post_plain,
              "las_decoder_fwd": LD.las_decoder_fwd_plain,
              "las_decoder_bwd": LD.las_decoder_bwd_plain,
              "frontend_k5": FE.compute_features_pallas_plain,
              "frontend_k6": FE.compute_features_pallas_regrid_plain,
              "bilstm_v1_fwd": K.bilstm_pallas_plain,
              "bilstm_v1_bwd": K.bilstm_pallas_bwd_plain}
    return kernels, plains


# K1's and K7's launches through the cluster recurrences, and K4's
# through fwd_cluster_kernel and bwd_cluster_kernel, counted beside their
# launches (ops/bilstm.py, ops/las_decoder.py): name -> the kernel of
# kernels().
CLUSTER_COUNTS = {"bilstm_fwd_cluster": "bilstm_fwd",
                  "bilstm_bwd_cluster": "bilstm_bwd",
                  "bilstm_v1_fwd_cluster": "bilstm_v1_fwd",
                  "bilstm_v1_bwd_cluster": "bilstm_v1_bwd",
                  "las_decoder_fwd_cluster": "las_decoder_fwd",
                  "las_decoder_bwd_cluster": "las_decoder_bwd"}
# K1's f32 projection and products (csrc/gemm_f32.cuh's ring_kernel),
# counted in .f32_launches beside their wrappers' launches: name -> the
# kernel of kernels().
F32_COUNTS = {"bilstm_fwd_projection_f32": "bilstm_fwd_projection",
              "bilstm_bwd_products_f32": "bilstm_bwd_products"}


def reset_counts() -> None:
    kernels, plains = counters()
    for f in kernels.values():
        f.launches = 0
        if hasattr(f, "by_mode"):
            f.by_mode.update(dict.fromkeys(f.by_mode, 0))
        if hasattr(f, "cluster_launches"):
            f.cluster_launches = 0
        if hasattr(f, "fft_launches"):
            f.fft_launches = 0
        if hasattr(f, "f32_launches"):
            f.f32_launches = 0
    for f in plains.values():
        f.calls = 0


def read_counts():
    """(launches by kernel, with K4's by mode as ``<name>_<mode>``,
    K1's and K7's through the cluster recurrences and K4's through its
    cluster kernels as CLUSTER_COUNTS names them, K1's f32 projection
    and products as F32_COUNTS names them, and K5's and K6's through
    ``fft_kernel`` as ``<name>_fft``; calls of the plain versions)."""
    kernels, plains = counters()
    launches = {k: f.launches for k, f in kernels.items()}
    for k, of in CLUSTER_COUNTS.items():
        launches[k] = kernels[of].cluster_launches
    for k, of in F32_COUNTS.items():
        launches[k] = kernels[of].f32_launches
    for k in ("frontend_k5", "frontend_k6"):
        launches[f"{k}_fft"] = kernels[k].fft_launches
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
main_only = False  # --only: a failed check is reported and the run goes on


def main(only=(), overrides=()) -> None:
    """The phases in order; ``only`` (phase names "3", "6c", "6d", "6e",
    "11", "12", "13", "14a".."14d", "15", "16", "16a"): the device, the build
    and those phases
    alone, with no kernels line and no last line (a quicker run while a
    phase is written; phase 14's runs, which take a chip call each);
    ``overrides`` (``--set``), phase 14's training overrides."""
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
    kernels_s = time.perf_counter() - t0
    # the host library (FLAC, the fused loader; g++), after the kernels
    from gluon_e2e_asr_tpu_torch.utils import native
    t0 = time.perf_counter()
    native.get_lib()
    emit({"phase": "build", "kernels": list(libs),
          "seconds": round(kernels_s, 3),
          "built_now": {n: b is not None for n, b in built.items()},
          "ptxas": {n: b[1].splitlines() for n, b in built.items() if b},
          "native_library": os.path.relpath(native._LIB_PATH, REPO),
          "native_seconds": round(time.perf_counter() - t0, 3)})

    if only:
        global main_only
        main_only = True
        phases = {"3": lambda torch, dev, card: kernel_phase(torch, dev),
                  "6c": training_options, "6d": vgg_slice, "6e": repro_phase,
                  "11": lm_phase,
                  "12": ls100_phase, "13": ls_shape_phase,
                  "15": milestones_phase, "16": ls100_full_phase,
                  "16a": lambda *a: ls100_full_phase(*a, measure_only=True)}
        for name in only:
            if name in CONVERGENCE:
                convergence_phase(torch, dev, card, name, overrides)
            else:
                phases[name](torch, dev, card)
        emit({"phases": list(only), "failed": FAILED,
              "seconds": round(time.perf_counter() - T_START, 1)})
        if torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
        sys.exit(1 if FAILED else 0)

    # 3. each kernel against its plain version at the flagship shapes
    p3 = kernel_phase(torch, dev)
    config, shapes, errs = p3["config"], p3["shapes"], p3["errs"]
    m2_config, loc_config = p3["m2_config"], p3["loc_config"]
    bwd_errs, products_errs = p3["bwd_errs"], p3["products_errs"]
    proj_errs, dec_errs, mode_errs = (p3["proj_errs"], p3["dec_errs"],
                                      p3["mode_errs"])
    fe_errs, v1_errs, probe_errs = (p3["fe_errs"], p3["v1_errs"],
                                    p3["probe_errs"])
    mc, fc = config.model, config.frontend
    H, B = mc.enc_hidden, config.data.batch_size

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
    proj_launches = bilstm.bilstm_fused_proj_kernel.launches
    plain_calls = bilstm_fused_plain.calls
    expect = mc.enc_layers * (result["num_batches"] + result["warm_passes"])
    with open(out_jsonl) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    emit({"phase": "slice", "decode_done": result,
          "note": "random weights: the WER means nothing",
          "bilstm_fwd_launches": launches, "expected_launches": expect,
          "bilstm_fwd_cluster_launches": cluster_launches,
          "bilstm_fwd_projection_launches": proj_launches,
          "plain_calls": plain_calls, "records": len(recs)})
    check(launches == expect,
          f"bilstm_fwd launched {launches} times, expected {expect}")
    check(cluster_launches == launches,
          f"{launches - cluster_launches} bilstm_fwd launches of the decode "
          "missed the cluster recurrence")
    check(proj_launches == launches,
          f"{launches - proj_launches} bf16 bilstm_fwd launches of the decode "
          "missed the wgmma projection")
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
    # projection, held against the plain recurrence (bilstm_scan) on it,
    # and its projection alone
    kernel_ms, plain_ms, recur_ms, recur_errs, proj_ms = {}, {}, {}, {}, {}
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
            pk_ms = time_ms(torch, lambda: bilstm.bilstm_fused_proj_kernel(
                x, lens, w_x, b_x, cd))
            pp_ms = time_ms(torch, lambda: bilstm.bilstm_fused_proj_plain(
                x, lens, w_x, b_x, cd))
            proj_ms[(layer, cd_name)] = (pk_ms, pp_ms)
            emit({"phase": "timing", "what": "bilstm_fwd", "layer": layer,
                  "B": B, "T": T, "D": D, "H": H, "compute_dtype": cd_name,
                  "kernel_ms": k_ms, "plain_ms": p_ms,
                  "recurrence_kernel_ms": r_ms,
                  "recurrence_us_per_step": r_ms * 1e3 / T,
                  "recurrence_training_form_ms": rt_ms,
                  "recurrence_training_form_us_per_step": rt_ms * 1e3 / T,
                  "projection_kernel_ms": pk_ms, "projection_plain_ms": pp_ms,
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
    m2_decode_counts, _ = decode_slice(torch, m2_trainer, M2_CONFIG, "train_m2")
    _, regrid_counts = train_slice(
        torch, M2_CONFIG, "train_m2_regrid", M2_REGRID_STEPS,
        ["--set", "frontend.impl=pallas_regrid"], ctc_only=True, falls=False)
    golden_greedy(torch)
    v1_counts = v1_path(torch, shapes[0], config, dev)
    # 6b. milestones 1, 3, 4 and 5 as shipped
    milestone_counts = milestone_slices(torch, dev, card)
    # 6c. the training options on milestone 4's model; 6d. vgg_blstm.yaml
    option_counts = training_options(torch, dev, card)
    vgg_counts, vgg_layer0_rows = vgg_slice(torch, dev, card)
    # 6e. two identical runs of each training form, and a step of each
    # under torch.use_deterministic_algorithms(True)
    repro_phase(torch, dev, card)
    # 8 runs before 7 and 7b. Its profiler readings of single calls and
    # milestone 5's f32 profile come from a fresh child process: late in a
    # long run this process's traces came back short or empty
    traces = profiler_traces(card)
    train_ms = train_timing(torch, trainer, dev, card, traces["ctc"])
    train_ms.update(loc_timing(torch, loc_trainer, dev, card))
    fe_ms, fe_notes, fe_detail = frontend_timing(
        torch, m2_trainer, config, dev, card, traces["frontend"])
    train_ms.update(k1_bwd_timing(torch, trainer, shapes, dev, card))
    lib_ms = library_timing(torch, config, shapes, dev, card)
    train_ms.update(fe_ms)
    train_ms.update(v1_timing(torch, config, shapes[0], dev, card))
    train_ms["bilstm_bwd_products"], lib_ms["bilstm_bwd_products"] = \
        products_timing(torch, config, shapes, dev, card, m2_config)
    f32_ms = f32_timing(torch, dev, card)
    # 7. the training reference; 7b. two ranks on the one card against
    # world size 1
    step_errs = train_reference(torch, trainer, dev)
    loc_step_errs = train_reference(torch, loc_trainer, dev)
    dp_check(torch, loc_trainer, dev, card)
    # 9. beam search
    golden_beam(torch)
    beam_timing(torch, loc_trainer, dev, card)
    # 10. P1
    probe_ms, probe_counts, probe_lib = probe_path(torch, dev, card)
    # 11. the external LM and forced alignment on english_m5
    lm_counts = lm_phase(torch, dev, card)
    # 12. ls100_full.yaml from a FLAC corpus, and the last tools
    ls100_counts, ls100_shape = ls100_phase(torch, dev, card)
    bounds = kernel_bounds(config, shapes, dev, loc_config, m2_config)
    for name, (k_ms, p_ms, l_ms, b_ms, b_by) in f32_ms.items():
        train_ms[name], lib_ms[name], bounds[name] = (k_ms, p_ms), l_ms, (
            b_ms, b_by)

    bf16 = [(layer, "bfloat16") for layer, _, _ in shapes]
    timed = {
        "bilstm_fwd": (sum(kernel_ms[k] for k in bf16),
                       sum(plain_ms[k] for k in bf16)),
        "bilstm_fwd_cluster": (sum(recur_ms[k][0] for k in bf16),
                               sum(recur_ms[k][1] for k in bf16)),
        "bilstm_fwd_projection": (sum(proj_ms[k][0] for k in bf16),
                                  sum(proj_ms[k][1] for k in bf16)),
        **{k: train_ms[k] for k in ("bilstm_bwd", "bilstm_bwd_cluster",
                                     "bilstm_bwd_products",
                                     "bilstm_bwd_products_f32",
                                     "bilstm_fwd_projection_f32", "ctc_alpha",
                                     "ctc_beta_post",
                                     "las_decoder_fwd", "las_decoder_bwd",
                                     "frontend_k5", "frontend_k6",
                                     "bilstm_v1_fwd", "bilstm_v1_bwd")}}
    errors = {"bilstm_fwd": max(v for k, v in errs.items() if k[1] == "bfloat16"),
              "bilstm_fwd_cluster": max(recur_errs[k] for k in bf16),
              "bilstm_bwd": max(bwd_errs["bilstm_bwd"]),
              "bilstm_bwd_cluster": max(bwd_errs["bilstm_bwd_cluster"]),
              "bilstm_bwd_products": max(products_errs["bfloat16"]),
              "bilstm_fwd_projection": max(proj_errs["bfloat16"]),
              "bilstm_bwd_products_f32": max(products_errs["float32"]),
              "bilstm_fwd_projection_f32": max(proj_errs["float32"]),
              "ctc_alpha": bwd_errs["ctc_alpha"],
              "ctc_beta_post": bwd_errs["ctc_beta_post"],
              "las_decoder_fwd": dec_errs["las_decoder_fwd"],
              "las_decoder_bwd": dec_errs["las_decoder_bwd"],
              **fe_errs, **v1_errs}
    where = {
        "bilstm_fwd": ("bilstm_fwd.cu",
                       "gluon_e2e_asr_tpu/ops/pallas_lstm.py:411",
                       "serving form, sum over the flagship's 3 layer shapes, "
                       "bf16, B=96, 4.0 s"),
        "bilstm_fwd_cluster": (
            "bilstm_fwd.cu",
            "gluon_e2e_asr_tpu/ops/pallas_lstm.py:411",
            "K1-fwd's recurrence alone (fwd_cluster_kernel through "
            "bilstm_fused_fwd_recur_kernel), serving form, sum over the "
            "flagship's 3 layer shapes, bf16, B=96, 4.0 s; launches: "
            "K1-fwd's through the cluster kernel in the slice; plain: "
            "models/lstm.py::bilstm_scan on the same projection; error: max "
            "abs of y against it"),
        "bilstm_fwd_projection": (
            "proj_sm90.cuh",
            "gluon_e2e_asr_tpu/ops/pallas_lstm.py:426",
            "K1-fwd's bf16 projection alone (proj_kernel on wgmma through "
            "bilstm_fused_proj_kernel), sum over the flagship's 3 layer "
            "shapes, B=96, 4.0 s; launches: the bf16 K1-fwd launches of "
            "the dot slice; plain: ops/bilstm.py::bilstm_fused_proj_plain; "
            "library: torch.addmm on the same bf16-rounded operands (bf16 "
            "out, no mask), the casts outside the timing; error: max abs "
            "of xg, round_xg off"),
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
        "bilstm_fwd_projection_f32": (
            "gemm_f32.cuh",
            "gluon_e2e_asr_tpu/ops/pallas_lstm.py:426",
            "K1-fwd's f32 projection alone (ring_kernel through "
            "bilstm_fused_proj_kernel), sum over the milestones' 3 layer "
            "shapes, B=16, H=256, 4.0 s; launches: the f32 K1-fwd launches "
            "of the milestone 1, 3, 4 and 5 runs (phase 6b); plain: ops/"
            "bilstm.py::bilstm_fused_proj_plain; library: torch.addmm in "
            "f32, TF32 off; bound: operations at 67 TFLOP/s, the forward "
            "half over every frame and the backward half over the live "
            "ones; error: max abs of xg"),
        "bilstm_bwd_products_f32": (
            "gemm_f32.cuh",
            "gluon_e2e_asr_tpu/ops/pallas_lstm.py:617",
            "K1-bwd's f32 products alone (ring_kernel for dx, dW_x with "
            "db, dW_h of each direction, through "
            "bilstm_fused_bwd_products_kernel) on the f32 recurrence's dg, "
            "sum over the milestones' 3 layer shapes, B=16, H=256, 4.0 s; "
            "launches: the f32 K1-bwd launches of the milestone 1, 3, 4 "
            "and 5 runs (phase 6b); plain: "
            "ops/bilstm.py::bilstm_fused_bwd_products_plain; library: four "
            "torch.matmul and torch.sum in f32, TF32 off; bound: "
            "operations at 67 TFLOP/s over the live frames; error: max abs "
            "over dx, dW_x, db, dW_h"),
        "ctc_alpha": ("ctc.cu",
                      "gluon_e2e_asr_tpu/ops/pallas_ctc.py:55",
                      "T=100, B=96, S of a 4.0 s training batch, through "
                      "ctc_alpha_warp_kernel (3 warps a row); device_ms: "
                      "torch.profiler, the kernel alone; bench_shape: T=320, "
                      "S=193; error: max abs over live cells of phase 3's "
                      "lattices"),
        "ctc_beta_post": ("ctc.cu",
                          "gluon_e2e_asr_tpu/ops/pallas_ctc.py:81",
                          "as K2, through ctc_beta_post_warp_kernel; error: "
                          "max abs of post over phase 3's lattices"),
        "las_decoder_fwd": ("las_decoder.cu",
                            "gluon_e2e_asr_tpu/ops/pallas_decoder.py:161",
                            "dot attention, bf16, B=96, T'=100, L=81 (the 4.0 s "
                            "bucket's label budget + 1), through "
                            "fwd_cluster_kernel (8 rows a cluster, one a CTA); "
                            "error: logits, coins off"),
        "las_decoder_bwd": ("las_decoder.cu",
                            "gluon_e2e_asr_tpu/ops/pallas_decoder.py:462",
                            "as K4-fwd, through bwd_cluster_kernel (8 rows a "
                            "cluster, one a CTA); error: max abs over every "
                            "cotangent"),
        "frontend_k5": ("frontend.cu",
                        "gluon_e2e_asr_tpu/frontend/pallas_frontend.py:56",
                        "impl pallas, cmvn utterance (milestone 2), eval, B=16, "
                        "4.0 s bucket, through fft_kernel (a cluster of 8 CTAs "
                        "an utterance, a real FFT a warp per frame, the mel "
                        "product over each filter's band, utterance CMVN "
                        "through distributed shared memory; one launch a "
                        "call); device_ms: torch.profiler, the kernel alone; "
                        "bound: the FFT's operations (5 N2 log2 N2 + 13 "
                        "(N2 + 1) + 2 nnz + win a live frame, N2 = n_fft/2) "
                        "against the live audio in and the features out; "
                        "dft_bound_ms: the DFT product's operations; error: "
                        "max abs over every shape, CMVN mode, eval and train, "
                        "the hard audio and n_fft 400 (spectral_kernel)"),
        "frontend_k6": ("frontend.cu",
                        "gluon_e2e_asr_tpu/frontend/pallas_frontend.py:181",
                        "impl pallas_regrid, as K5, through the same "
                        "fft_kernel"),
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
                           f"{m} attention, flagship_bf16, bf16, B=96, T'=100"
                           f", through {d}_cluster_kernel; error: "
                           + ("logits" if d == "fwd" else
                              "max abs over every cotangent") + ", coins off")
            timed[name] = train_ms[name]
            errors[name] = mode_errs[m][f"las_decoder_{d}"]
            launches[name] = counts[name]
    # K5 from the milestone 2 slice, K6 from its pallas_regrid steps, K7
    # from its own path
    launches["frontend_k5"] = m2_counts["frontend_k5"]
    launches["frontend_k6"] = regrid_counts["frontend_k6"]
    launches["frontend_k5_fft"] = m2_counts["frontend_k5_fft"]
    launches["frontend_k6_fft"] = regrid_counts["frontend_k6_fft"]
    for name in ("bilstm_v1_fwd", "bilstm_v1_bwd"):
        launches[name] = v1_counts[name]
    # K1's f32 rows from the milestone runs (every milestone runs f32)
    for name in F32_COUNTS:
        launches[name] = sum(c[name] for c in milestone_counts.values())
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
    for row in rows:
        if row["name"] in F32_COUNTS:
            check(row["launches"] > 0,
                  f"{row['name']} launched no time in the milestone runs")
    for row in rows:  # the launches of each milestone's training run
        # K4's rows are one a mode: the dot rows count dot launches alone
        key = row["name"] + ("_dot" if row["name"] in (
            "las_decoder_fwd", "las_decoder_bwd") else "")
        row["milestone_launches"] = {f"milestone{n}": c.get(key, 0)
                                     for n, c in milestone_counts.items()}
        row["vgg_blstm_launches"] = vgg_counts.get(key, 0)
        row["option_launches"] = {
            k: option_counts[f"{k}_launches"].get(key, 0)
            for k in ("dropout", "stacked")}
        if row["name"] in vgg_layer0_rows:
            row["vgg_layer0"] = vgg_layer0_rows[row["name"]]
        row["lm_phase_launches"] = {k: c.get(key, 0)
                                    for k, c in lm_counts.items()}
        row["ls100_phase_launches"] = {k: c.get(key, 0)
                                       for k, c in ls100_counts.items()}
        if row["name"] in ls100_shape:
            row["ls100_largest_bucket"] = ls100_shape[row["name"]]
    # K4's launches through its cluster kernels, from the same slices:
    # every one of them
    for d in ("fwd", "bwd"):
        for m, counts in (("", train_counts), ("_add", add_counts),
                          ("_loc", loc_counts)):
            row = next(r for r in rows if r["name"] == f"las_decoder_{d}{m}")
            row["cluster_launches"] = counts[f"las_decoder_{d}_cluster"]
            check(row["cluster_launches"] == row["launches"] > 0,
                  f"{row['name']}: {row['launches']} launches, "
                  f"{row['cluster_launches']} through {d}_cluster_kernel")
    # K2's and K3's device time and their numbers at bench.py's shape
    for name in ("ctc_alpha", "ctc_beta_post"):
        row = next(r for r in rows if r["name"] == name)
        detail = train_ms["ctc_detail"][name]
        b_ms, b_by = bounds[f"{name}_bench"]
        row["device_ms"] = detail["device_ms"]
        row["bench_shape"] = dict(detail["bench_shape"],
                                  library_ms=lib_ms[f"{name}_bench"],
                                  bound_ms=b_ms, bound_by=b_by)
    next(r for r in rows if r["name"] == "bilstm_fwd_cluster")[
        "decode_launches"] = cluster_launches
    next(r for r in rows if r["name"] == "bilstm_fwd_projection")[
        "decode_launches"] = proj_launches
    next(r for r in rows if r["name"] == "frontend_k5")["decode_launches"] = \
        m2_decode_counts["frontend_k5"]
    # K5's and K6's device time, the frontend's route (the row's "route"
    # is the contract's: cuda) and the DFT product's bound
    for name in ("frontend_k5", "frontend_k6"):
        row = next(r for r in rows if r["name"] == name)
        row["device_ms"], row["frontend_route"] = fe_detail[name]
        row["dft_bound_ms"] = bounds["frontend_dft"][0]
        row["fft_launches"] = launches[f"{name}_fft"]
    # K7's other pairing: bf16 streams with f32 compute (its backward
    # recomputes the gates), at the same shape
    for d in ("fwd", "bwd"):
        row = next(r for r in rows if r["name"] == f"bilstm_v1_{d}")
        k_ms, p_ms = train_ms["bilstm_v1_bf16_f32"][d]
        row["bf16_streams_f32_compute"] = {
            "max_abs_err": errors["bilstm_v1_bf16_f32"][f"bilstm_v1_{d}"],
            "ms": k_ms, "plain_ms": p_ms,
            "note": "the backward's ms include the gate recompute"
                    if d == "bwd" else "the forward as in bf16 compute, "
                    "with its product in f32"}
    emit({"kernels": rows, "train_step": step_errs,
          "train_step_loc": loc_step_errs,
          "seconds": round(time.perf_counter() - T_START, 1)})
    # the process group the shipped training slices joined (train.dp)
    if torch.distributed.is_initialized():
        torch.distributed.destroy_process_group()
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


def kernel_phase(torch, dev) -> dict:
    """Phase 3: each kernel against its plain version (and each launched
    REPEATS times on identical inputs, every output equal) at the
    flagship's shapes and the others the module docstring lists. Returns
    what the later phases and the kernels line read."""
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
    from gluon_e2e_asr_tpu_torch.ops.bilstm import (
        bilstm_fused_kernel, bilstm_fused_plain)

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
                repeats_equal(torch, "bilstm_fwd", f"flagship layer {layer} "
                              f"{cd_name} round_xg={round_xg}",
                              lambda: bilstm_fused_kernel(
                                  *args, compute_dtype=cd, round_xg=round_xg))
    m2_config = load_config(M2_CONFIG)
    bwd_errs = check_training_kernels(torch, config, shapes, dev, m2_config)
    products_errs = check_products_kernels(torch, config, shapes, dev,
                                           m2_config)
    proj_errs = check_projection_kernels(torch, config, shapes, dev)
    dec_errs = check_decoder_kernels(torch, config, dev)
    loc_config = load_config(LOC_CONFIG)
    mode_errs = {m: check_decoder_kernels(torch, loc_config, dev, m)
                 for m in ("add", "loc")}
    check_decoder_kernels(torch, loc_config, dev, "loc",
                          cases=[("bfloat16", 0.0, True)])
    check_decoder_rows(torch, config, loc_config, dev)
    fe_errs = check_frontend_kernels(torch, m2_config, config, dev)
    v1_errs = check_v1_kernels(torch, config, shapes[0], dev)
    probe_errs = check_probe_kernels(torch, dev)

    emit({"phase": "repeats", "repeats": REPEATS, "cases": REPEATS_SEEN,
          "all_equal": all(r["equal"] for r in REPEATS_SEEN)})
    return {"config": config, "shapes": shapes, "errs": errs,
            "m2_config": m2_config, "bwd_errs": bwd_errs,
            "products_errs": products_errs, "proj_errs": proj_errs,
            "dec_errs": dec_errs, "loc_config": loc_config,
            "mode_errs": mode_errs, "fe_errs": fe_errs, "v1_errs": v1_errs,
            "probe_errs": probe_errs}


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


def bench_ctc_inputs(torch, config):
    """bench.py's batch for the CTC loss (``synth_batch``: B=96, 12.8 s, 48
    to 96 labels in 4..29) through the flagship's frame count and
    subsampling (T=320): (seeded logits [B,T,32], encoder lengths, labels,
    label lengths), on the CPU."""
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames

    fc = config.frontend
    b = synth_batch(config.data.batch_size, BENCH_SEC, BENCH_LABELS, SEED)
    lens = num_frames(torch.from_numpy(b["audio_len"]), fc.win_length,
                      fc.hop_length)
    T = num_frames(b["audio"].shape[1], fc.win_length, fc.hop_length)
    for f in config.model.enc_subsample:
        lens, T = (lens + int(f) - 1) // int(f), -(-T // int(f))
    rng = np.random.RandomState(SEED)
    logits = torch.from_numpy(
        rng.randn(len(lens), T, 32).astype(np.float32) * 3)
    return (logits, lens.int(), torch.from_numpy(b["labels"]),
            torch.from_numpy(b["label_len"]))


def bench_ctc_batch(torch, config, dev):
    """real_ctc_batch's tuple at bench.py's shape (T=320, B=96, S=193)."""
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    logits, lens, labels, label_lens = (
        t.to(dev) for t in bench_ctc_inputs(torch, config))
    ext, skip, svalid, tmask = C._lattice(logits.shape[1], lens, labels,
                                          label_lens, 0)
    return (C._gather_states(torch.log_softmax(logits, -1), ext), tmask,
            skip, svalid, label_lens)


def ctc_cases(torch, config, dev):
    """Phase 3's lattices for K2 and K3, name -> real_ctc_batch's tuple:
    the flagship's 4.0 s training batch, bench.py's shape, B=1, T=1,
    ``tools/ctc_probe.py::lattice``'s rows of length 0, infeasible and
    with a time mask that is not a prefix (B=8, rows 1-3), and S=641 and
    1024 (three and four warps a row) over enough frames to reach every
    state."""
    from gluon_e2e_asr_tpu_torch.tools.ctc_probe import lattice

    def probe(T, B, S):
        emit_, tmask, skip, svalid, last = lattice(T, B, S, SEED, dev)
        return emit_, tmask, skip, svalid, last // 2

    return {"4.0 s batch": real_ctc_batch(torch, config, dev),
            "bench.py": bench_ctc_batch(torch, config, dev),
            "B=1": probe(100, 1, 161), "T=1": probe(1, 96, 161),
            "hard rows": probe(100, 8, 161), "S=641": probe(400, 8, 641),
            "S=1024": probe(520, 4, 1024)}


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
    """Phase 3, K4 in mode ``kind``: K4-fwd (logits and residuals;
    through fwd_cluster_kernel) and K4-bwd (every cotangent; through
    bwd_cluster_kernel) against the plain versions. ``cases``: (dtype,
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
        n_fwd = LD.las_decoder_fwd_kernel.cluster_launches
        logits, resid, extras = LD.las_decoder_fwd_kernel(*args, cd, kind, filt)
        fwd_cluster = LD.las_decoder_fwd_kernel.cluster_launches - n_fwd
        ref, ref_resid = LD.las_decoder_fwd_plain(*args, cd, kind, band)
        torch.cuda.synchronize()
        same = (resid[4].long() == ref_resid[4].long()).all(1)
        share = int(same.sum()) / same.numel()  # exact: 1.0 when all agree
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
        n_cluster = LD.las_decoder_bwd_kernel.cluster_launches
        got = LD.las_decoder_bwd_kernel(dl, resid, extras, enc, enc_proj,
                                        enc_len, w, cd, kind, filt)
        cluster = LD.las_decoder_bwd_kernel.cluster_launches - n_cluster
        want = LD.las_decoder_bwd_plain(dl, resid, enc, enc_proj, enc_len,
                                        w, cd, kind, band)
        gk = decoder_grads(torch, LD, got, resid, dl, w, filt, T)
        gp = decoder_grads(torch, LD, want, resid, dl, w, filt, T)
        torch.cuda.synchronize()
        bwd = {k: rel_err(gk[k], gp[k]) for k in gp}
        finite = bool(torch.isfinite(logits).all()) and all(
            bool(torch.isfinite(v).all()) for v in gk.values())
        sec = config.data.bucket_bounds_sec[bucket_batch(torch, config)[0]
                                            .bucket]
        emit({"phase": "kernel_check", "kernel": "las_decoder_fwd+bwd",
              "att_type": kind, "B": B, "L": L, "T": T,
              "longest_label": longest, "shape": "bench.py" if bench
              else f"{sec} s bucket",
              "compute_dtype": cd_name, "coin_p": coin_p,
              "rows_tokens_agree": share, "fwd_rel_err": fwd,
              "bwd_rel_err": bwd, "tol_rel": tol, "finite": finite,
              "fwd_cluster_launches": fwd_cluster,
              "bwd_cluster_launches": cluster})
        check(finite, f"las_decoder ({kind}) non-finite output ({cd_name})")
        check(fwd_cluster == 1, f"las_decoder_fwd ({kind}, {cd_name}) did not "
                                "go through fwd_cluster_kernel")
        check(cluster == 1, f"las_decoder_bwd ({kind}, {cd_name}) did not go "
                            "through bwd_cluster_kernel")
        check(max(fwd.values()) <= tol,
              f"las_decoder_fwd ({kind}) disagrees with its plain version "
              f"({cd_name}, coins {coin_p}): {fwd}")
        check(max(bwd.values()) <= tol,
              f"las_decoder_bwd ({kind}) disagrees with its plain version "
              f"({cd_name}, coins {coin_p}): {bwd}")
        at = f"{kind} {cd_name} coins {coin_p}" + (" bench.py" if bench
                                                    else "")
        repeats_equal(torch, "las_decoder_fwd", at,
                      lambda: LD.las_decoder_fwd_kernel(*args, cd, kind, filt))
        repeats_equal(torch, "las_decoder_bwd", at,
                      lambda: LD.las_decoder_bwd_kernel(
                          dl, resid, extras, enc, enc_proj, enc_len, w, cd,
                          kind, filt))
        repeats_equal(torch, "las_decoder_bwd (with weight_grads)", at,
                      lambda: decoder_grads(torch, LD, LD.las_decoder_bwd_kernel(
                          dl, resid, extras, enc, enc_proj, enc_len, w, cd,
                          kind, filt), resid, dl, w, filt, T))
        if cd_name == "bfloat16" and coin_p == 0.0 and not bench:
            errs["las_decoder_fwd"] = float((logits - ref).abs().max())
            errs["las_decoder_bwd"] = max(
                float((gk[k] - gp[k]).abs().max()) for k in bwd)
    return errs


# K4's two-rows kernels (fwd_kernel, bwd_kernel) serve the shapes whose
# cluster plan does not fit a block's shared memory; no config reaches
# them, so phase 3 holds them to REPEATS launches at one such shape a
# mode at the 4.0 s bucket (T'=100): (mode, dec_hidden, enc_hidden,
# att_dim), both routes "rows" in f32 and bf16.
K4_ROWS_SHAPES = (("dot", 1024, 640, 320), ("add", 512, 1024, 512),
                  ("loc", 512, 1024, 320))


def check_decoder_rows(torch, config, loc_config, dev):
    """Phase 3, K4's two-rows kernels at K4_ROWS_SHAPES in f32 and bf16:
    REPEATS launches of K4-fwd and of K4-bwd on identical inputs, every
    output equal, none through a cluster kernel."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD

    for kind, H, EH, A in K4_ROWS_SHAPES:
        cfg = copy.deepcopy(config if kind == "dot" else loc_config)
        cfg.model.dec_hidden, cfg.model.enc_hidden = H, EH
        cfg.model.att_dim = A
        args, filt, _ = decoder_case(torch, cfg, dev, 0.0, att_type=kind)
        tokens, coins, enc, enc_proj, enc_len, w = args
        B, L = tokens.shape
        dl = torch.from_numpy(np.random.RandomState(SEED + 7).randn(
            B, L, w.embed.shape[0]).astype(np.float32) * 0.05).to(dev)
        for cd_name in ("float32", "bfloat16"):
            cd = getattr(torch, cd_name)
            n = (LD.las_decoder_fwd_kernel.cluster_launches,
                 LD.las_decoder_bwd_kernel.cluster_launches)
            _, resid, extras = LD.las_decoder_fwd_kernel(*args, cd, kind, filt)
            at = f"{kind} {cd_name}, two-rows plan (dec {H}, enc {EH}, att {A})"
            repeats_equal(torch, "las_decoder_fwd", at,
                          lambda: LD.las_decoder_fwd_kernel(*args, cd, kind,
                                                            filt))
            repeats_equal(torch, "las_decoder_bwd", at,
                          lambda: LD.las_decoder_bwd_kernel(
                              dl, resid, extras, enc, enc_proj, enc_len, w,
                              cd, kind, filt))
            check((LD.las_decoder_fwd_kernel.cluster_launches,
                   LD.las_decoder_bwd_kernel.cluster_launches) == n,
                  f"K4 at {at} went through a cluster kernel")


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


def frontend_check_cases(torch, m2_config, config, dev):
    """Phase 3's batches for K5 and K6, (name, frontend config, audio,
    audio_len, the route of the shape): frontend_cases' four shapes
    (bench.py's seeded noise) and a batch of hard audio at milestone 2's
    4.0 s bucket (``tools/fe_probe.py::hard_audio``, from the seed: tones,
    digital silence and a -60 dB stretch, which put cells at the power
    floor), all on the FFT route; and milestone 2's 2.0 s bucket with
    n_fft = 400, no power of two, on the spectral route."""
    from gluon_e2e_asr_tpu_torch.tools.fe_probe import hard_audio

    cases = [(case, fc, *frontend_audio(torch, B, sec, dev), "fft")
             for case, fc, B, sec in frontend_cases(m2_config, config)]
    _, fc, B, sec = frontend_cases(m2_config, config)[1]
    audio, alen = hard_audio(B, int(sec * fc.sample_rate), SEED)
    cases.append(("hard audio, milestone2 4.0 s", fc,
                  torch.from_numpy(audio).to(dev),
                  torch.from_numpy(alen).to(dev), "fft"))
    fc400 = copy.deepcopy(fc)
    fc400.n_fft = 400
    cases.append(("n_fft 400, milestone2 2.0 s", fc400,
                  *frontend_audio(torch, B, 2.0, dev), "spectral"))
    return cases


def check_frontend_kernels(torch, m2_config, config, dev):
    """Phase 3, K5 and K6 against their plain versions on every batch of
    frontend_check_cases, each CMVN mode (utterance, global with the
    batch's own stats, none), eval and train (the same SpecAugment draws
    on both sides), rows of different lengths: |kernel - plain| within
    TOL_FE, the masked cells exactly 0 in both, and each call through
    its shape's route (``.fft_launches``). Returns each kernel's max abs
    error over all of them."""
    from gluon_e2e_asr_tpu_torch.frontend import fused as FE
    from gluon_e2e_asr_tpu_torch.frontend.features import (
        draw_spec_augment, num_frames)

    errs = {"frontend_k5": 0.0, "frontend_k6": 0.0}
    pairs = {"frontend_k5": (FE.compute_features_pallas_kernel,
                             FE.compute_features_pallas_plain),
             "frontend_k6": (FE.compute_features_pallas_regrid_kernel,
                             FE.compute_features_pallas_regrid_plain)}
    for case, fc0, audio, alen, route in frontend_check_cases(
            torch, m2_config, config, dev):
        B = int(audio.shape[0])
        F = num_frames(audio.shape[1], fc0.win_length, fc0.hop_length)
        rec = {"phase": "kernel_check", "kernel": "frontend_k5+frontend_k6",
               "shape": case, "B": B, "samples": int(audio.shape[1]), "F": F,
               "n_fft": fc0.n_fft, "route": route,
               "plan": FE.fft_plan(F, fc0.win_length, fc0.hop_length,
                                   fc0.n_fft, fc0.n_mels),
               "tol": {"rtol": TOL_FE_RTOL, "atol": TOL_FE_ATOL}, "cases": []}
        check(FE.route(fc0, F) == route,
              f"{case}: the plan routes to {FE.route(fc0, F)}, not {route}")
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
                    fft = kernel.fft_launches
                    got, got_len = kernel(fc, audio, alen, **kw)
                    fft = kernel.fft_launches - fft
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
                        "masked_share": float(mask.float().mean()),
                        "fft_launches": fft})
                    check(bool(torch.isfinite(got).all()) and zeros
                          and over <= TOL_FE_ATOL
                          and torch.equal(got_len, ref_len),
                          f"{name} disagrees with its plain version at {case}, "
                          f"cmvn {cmvn}, train {train}: max abs {err}, masked "
                          f"cells zero {zeros}")
                    check(fft == (route == "fft"),
                          f"{name} at {case} did not take the {route} route")
                    repeats_equal(torch, name, f"{case} cmvn {cmvn} "
                                  f"train {train}",
                                  lambda: kernel(fc, audio, alen, **kw))
        emit(rec)
    return errs


# K7's (stream dtype, compute dtype) pairs: the reference's bilstm_pallas
# takes all three; bf16 streams with f32 compute recompute the gates in
# the backward (ops/bilstm.py::_recompute_gates).
V1_PAIRS = (("float32", "float32"), ("bfloat16", "bfloat16"),
            ("bfloat16", "float32"))


def v1_case(torch, config, shape, dev, cd_name, stream_name=None):
    """K7's inputs at one layer shape of ``config``: the projections of
    layer_inputs (x . w_x + b_x, split by direction) in the stream dtype
    ``stream_name`` (by default ``cd_name``), lens, W_h, a seeded cotangent
    in that dtype, and the compute dtype ``cd_name``."""
    layer, T, D = shape
    H, B = config.model.enc_hidden, config.data.batch_size
    x, lens, w_x, b_x, w_hf, w_hb = layer_inputs(torch, B, T, D, H, layer, dev)
    sd = getattr(torch, stream_name or cd_name)
    xg = torch.matmul(x, w_x) + b_x
    xg_f = xg[..., :4 * H].contiguous().to(sd)
    xg_b = xg[..., 4 * H:].contiguous().to(sd)
    dy = layer_cotangent(torch, B, T, H, layer, dev).to(sd)
    return (xg_f, xg_b, lens, w_hf, w_hb), dy, getattr(torch, cd_name)


def check_v1_kernels(torch, config, shape, dev):
    """Phase 3, K7-fwd (h and c streams) and K7-bwd (d(xg) of both
    directions, dW_h of both) against their plain versions at the
    flagship's layer-0 shape in each of V1_PAIRS (bf16 streams with f32
    compute: one gate recompute a backward call). Returns the bf16 max abs
    errors, and the last pairing's under "bilstm_v1_bf16_f32"."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    errs = {}
    for sd_name, cd_name in V1_PAIRS:
        args, dy, cd = v1_case(torch, config, shape, dev, cd_name, sd_name)
        sd = args[0].dtype
        y, c, acts = K.bilstm_pallas_kernel(*args, cd, with_cell=True)
        yp, cp = K.bilstm_pallas_plain(*args, cd, with_cell=True)
        n_gate = K.bilstm_pallas_bwd_kernel.gate_launches
        got = K.bilstm_pallas_bwd_kernel(args[2], args[3], args[4], y, c, acts,
                                         dy, cd, sd, args[:2])
        ref = K.bilstm_pallas_bwd_plain(*args, yp, cp, dy, cd)
        torch.cuda.synchronize()
        gates = K.bilstm_pallas_bwd_kernel.gate_launches - n_gate
        outs = {"h": (y, yp), "c": (c, cp)}
        outs.update(zip(("dxg_f", "dxg_b", "dw_hf", "dw_hb"), zip(got, ref)))
        rel = {k: rel_err(a.float(), b.float()) for k, (a, b) in outs.items()}
        absd = {k: float((a.float() - b.float()).abs().max())
                for k, (a, b) in outs.items()}
        finite = all(bool(torch.isfinite(a).all()) for a, _ in outs.values())
        emit({"phase": "kernel_check", "kernel": "bilstm_v1_fwd+bwd",
              "B": int(y.shape[0]), "T": int(y.shape[1]),
              "H": int(y.shape[2] // 2), "dtype": sd_name,
              "compute_dtype": cd_name, "rel_err": rel, "max_abs_err": absd,
              "tol_rel": TOL_V1[sd_name], "gate_recomputes": gates,
              "finite": finite})
        check(finite and max(rel.values()) <= TOL_V1[sd_name],
              f"bilstm_v1 disagrees with its plain version ({sd_name} "
              f"streams, {cd_name} compute): {rel}")
        check(gates == (sd_name != cd_name),
              f"bilstm_v1_bwd ({sd_name} streams, {cd_name} compute) "
              f"recomputed the gates {gates} times")
        at = f"{sd_name} streams {cd_name} compute"
        repeats_equal(torch, "bilstm_v1_fwd", at, lambda: K.bilstm_pallas_kernel(
            *args, cd, with_cell=True))
        repeats_equal(torch, "bilstm_v1_bwd", at,
                      lambda: K.bilstm_pallas_bwd_kernel(
                          args[2], args[3], args[4], y, c, acts, dy, cd, sd,
                          args[:2]))
        err = {"bilstm_v1_fwd": absd["h"],
               "bilstm_v1_bwd": max(absd[k] for k in
                                    ("dxg_f", "dxg_b", "dw_hf", "dw_hb"))}
        if (sd_name, cd_name) == ("bfloat16", "bfloat16"):
            errs.update(err)
        elif sd_name != cd_name:
            errs["bilstm_v1_bf16_f32"] = dict(err, rel_err=rel)
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


def decode_slice(torch, trainer, path, name, max_utts=0, method=None,
                 extra=(), tag=""):
    """A decode of the last checkpoint of ``trainer``'s run (of the config
    at ``path`` with the ``extra`` overrides, in OUT_DIR/``name``) through
    the decode CLI on the card by ``method``, by default the config's
    ``decode.method`` (the first ``max_utts`` dev utterances, 0: all): the
    frontend kernel of its config on every batch (and warm pass), K1-fwd
    through the cluster recurrence, no K2, K3 or K4 (the beams' decoder
    steps are plain torch operations, as in the JAX package), no plain
    version, a hypothesis per dev utterance. The records go to
    ``decode_<method><tag>.jsonl``; returns the launches and the CLI's
    result."""
    from gluon_e2e_asr_tpu_torch import decode

    config, steps = trainer.config, trainer.state.step
    method = method or config.decode.method
    workdir = os.path.join(OUT_DIR, name)
    ckpt = os.path.join(workdir, config.train.ckpt_dir, f"ckpt_{steps}.pt")
    out = os.path.join(workdir, f"decode_{method}{tag}.jsonl")
    impl = config.frontend.impl
    reset_counts()
    t0 = time.perf_counter()
    result = decode.main(["--config", path, *extra, "--ckpt", ckpt,
                          "--output", out, "--method", method,
                          "--max-utts", str(max_utts), "--device", "cuda"])
    wall = time.perf_counter() - t0
    launches, plain = read_counts()
    with open(out) as f:
        recs = [json.loads(line) for line in f if line.strip()]
    batches = result["num_batches"] + result["warm_passes"]
    emit({"phase": "decode_slice", "config": os.path.relpath(path, REPO),
          "checkpoint": os.path.relpath(ckpt, REPO), "frontend_impl": impl,
          "method": method, "overrides": list(extra[1::2]),
          "max_utts": max_utts,
          "wall_s": round(wall, 2), "decode_done": result,
          "launches": launches, "plain_calls": plain, "records": len(recs)})
    check(result["method"] == method,
          f"decoded by {result['method']}, asked for {method}")
    fe = {"pallas": "frontend_k5", "pallas_regrid": "frontend_k6"}.get(impl)
    for key in ("frontend_k5", "frontend_k6"):
        want = batches if key == fe else 0
        check(launches[key] == launches[f"{key}_fft"] == want,
              f"{key} launched {launches[key]} times in the decode "
              f"({launches[f'{key}_fft']} through fft_kernel), expected {want}")
    check(launches["bilstm_fwd"] == config.model.enc_layers * batches,
          f"bilstm_fwd launched {launches['bilstm_fwd']} times in the decode")
    check(launches["bilstm_fwd_cluster"] == launches["bilstm_fwd"],
          "a bilstm_fwd launch of the decode missed the cluster recurrence")
    bf16 = config.model.compute_dtype == "bfloat16"
    check(launches["bilstm_fwd_projection"] == launches["bilstm_fwd"] * bf16,
          f"the wgmma projection launched {launches['bilstm_fwd_projection']} "
          "times in the decode")
    check(launches["bilstm_fwd_projection_f32"]
          == launches["bilstm_fwd"] * (not bf16),
          f"the f32 projection (ring_kernel) launched "
          f"{launches['bilstm_fwd_projection_f32']} times in the decode")
    check(not any(launches[k] for k in ("ctc_alpha", "ctc_beta_post",
                                        "las_decoder_fwd", "las_decoder_bwd")),
          f"a training kernel launched in the decode: {launches}")
    check(not any(plain.values()), f"plain versions ran in the decode: {plain}")
    check(result["num_utts"] == len(recs) > 0
          and all(isinstance(r["hyp"], str) for r in recs),
          "the decode wrote no hypothesis per utterance")
    if method != "greedy":
        check(result["beam_steps_total"] > 0, "the beam ran no output step")
    return launches, result


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
    check(launches["frontend_k5"] == launches["frontend_k5_fft"] > 0
          and not any(plain.values()),
          f"golden greedy ({impl}): launches {launches}, plain {plain}")


def check_k1_case(torch, name, layer, args, dy, cd_name, serving=True,
                  recurrence=False):
    """K1-fwd's training form (h, and c against TOL_BWD), with
    ``serving`` its serving form too, and K1-bwd (dx, dW_x, db, dW_h)
    against their plain versions on one layer's inputs ``args`` and
    cotangent ``dy``, every launch through its cluster recurrence; with
    ``recurrence``, K1-bwd's recurrence alone against the plain sweep's dg.
    Emits the two kernel_check lines; returns (K1-fwd's max abs error of
    h, K1-bwd's record: by output max_abs_err, rel_err, max_abs; "dg" with
    ``recurrence``)."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    x, lens, w_x, b_x, w_hf, w_hb = args
    Bc, T, D = x.shape
    Hc = w_hf.shape[0]
    cd = getattr(torch, cd_name)
    n_fwd = K.bilstm_fused_kernel.cluster_launches
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                       with_cell=True)
    ys = K.bilstm_fused_kernel(*args, compute_dtype=cd) if serving else None
    yp, cp = K.bilstm_fused_plain(*args, compute_dtype=cd, with_cell=True)
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
    check(fwd_cluster == (2 if serving else 1),
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
    for out, g, r in zip(("dx", "dw_x", "db", "dw_hf", "dw_hb"), got, ref):
        rec[out] = {"max_abs_err": float((g - r).abs().max()),
                    "rel_err": rel_err(g, r),
                    "max_abs": float(r.abs().max())}
        check(bool(torch.isfinite(g).all())
              and rel_err(g, r) <= TOL_BWD[cd_name],
              f"bilstm_bwd {out} disagrees with its plain version "
              f"at {name} layer {layer} {cd_name}: {rel_err(g, r)}")
    at = f"{name} layer {layer} {cd_name}"
    repeats_equal(torch, "bilstm_fwd (training form)", at,
                  lambda: K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                                with_cell=True))
    if serving:
        repeats_equal(torch, "bilstm_fwd", at,
                      lambda: K.bilstm_fused_kernel(*args, compute_dtype=cd))
    repeats_equal(torch, "bilstm_bwd", at, lambda: K.bilstm_fused_bwd_kernel(
        x, lens, w_x, w_hf, w_hb, y, c, acts, dy, compute_dtype=cd))
    if recurrence:
        dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy, cd)
        xg = torch.cat(K._project(x, lens, w_x, b_x, cd, False), -1)
        dg_ref = K._bwd_sweep(xg, lens, w_hf, w_hb, y, c, dy, cd)
        torch.cuda.synchronize()
        rec["dg"] = {"max_abs_err": float((dg - dg_ref).abs().max()),
                     "rel_err": rel_err(dg, dg_ref)}
        check(bool(torch.isfinite(dg).all())
              and rel_err(dg, dg_ref) <= TOL_BWD[cd_name],
              f"the K1-bwd recurrence's dg disagrees with the plain "
              f"sweep at layer {layer} {cd_name}: {rel_err(dg, dg_ref)}")
    emit(rec)
    return y_err, rec


def check_training_kernels(torch, config, shapes, dev, m2_config):
    """Phase 3, the training kernels: K1-fwd's training form and K1-bwd at
    the flagship's layer shapes (B=96, H=320), at milestone 2's (B=16,
    H=256) and at the flagship's last layer with B=50 (a partial group of
    rows in the cluster recurrences) and B=1 (serving's batch), K1-fwd's
    serving form too where phase 3's first loop does not take it, every
    K1-fwd and K1-bwd launch through its cluster kernel, and at the flagship's shapes the recurrence alone
    against the plain sweep's dg; at ls100_full's 18.38 s layer 0 every
    K1 form's repeats alone; K2 and K3 on ctc_cases' lattices, each call
    one launch of its kernel."""
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

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
    cases.append(vgg_case())
    errs = {"bilstm_bwd": [], "bilstm_bwd_cluster": []}
    for name, Bc, Hc, (layer, T, D) in cases:
        args = layer_inputs(torch, Bc, T, D, Hc, layer, dev)
        dy = layer_cotangent(torch, Bc, T, Hc, layer, dev)
        for cd_name in ("float32", "bfloat16"):
            _, rec = check_k1_case(torch, name, layer, args, dy, cd_name,
                                   serving=name != "flagship",
                                   recurrence=name == "flagship")
            if cd_name == "bfloat16" and name == "flagship":
                errs["bilstm_bwd"] += [rec[out]["max_abs_err"] for out in
                                       ("dx", "dw_x", "db", "dw_hf", "dw_hb")]
                errs["bilstm_bwd_cluster"].append(rec["dg"]["max_abs_err"])

    # ls100_full's 18.38 s layer 0 (T=1836): every K1 form REPEATS times
    # (phase 12 holds K1 there to the plain versions on a real batch)
    name, Bc, Hc, (layer, T, D) = ls100_case()
    args = layer_inputs(torch, Bc, T, D, Hc, layer, dev)
    dy = layer_cotangent(torch, Bc, T, Hc, layer, dev)
    for cd_name in ("float32", "bfloat16"):
        cd, at = getattr(torch, cd_name), f"{name} layer {layer} {cd_name}"
        y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                           with_cell=True)
        repeats_equal(torch, "bilstm_fwd (training form)", at,
                      lambda: K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                                    with_cell=True))
        repeats_equal(torch, "bilstm_fwd", at,
                      lambda: K.bilstm_fused_kernel(*args, compute_dtype=cd))
        repeats_equal(torch, "bilstm_bwd", at, lambda: K.bilstm_fused_bwd_kernel(
            args[0], args[1], args[2], args[4], args[5], y, c, acts, dy,
            compute_dtype=cd))

    errs["ctc_alpha"], errs["ctc_beta_post"] = 0.0, 0.0
    for name, lattice in ctc_cases(torch, config, dev).items():
        a_err, p_err = check_ctc_case(torch, name, lattice)
        errs["ctc_alpha"] = max(errs["ctc_alpha"], a_err)
        errs["ctc_beta_post"] = max(errs["ctc_beta_post"], p_err)
    return errs


def check_ctc_case(torch, name, lattice):
    """K2 and K3 against their plain versions on one lattice
    (real_ctc_batch's tuple), one launch of each kernel: alpha on the live
    cells (rtol; the dead cells dead in both), post (atol). Emits a
    kernel_check line; returns (alpha's max abs error on the live cells,
    post's max abs error)."""
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    emit_, tmask, skip, svalid, label_lens = lattice
    last = 2 * label_lens
    n_a = C.ctc_alpha_kernel.launches
    n_b = C.ctc_beta_post_kernel.launches
    alpha = C.ctc_alpha_kernel(emit_, tmask, skip, svalid)
    alpha_p = C._alpha_plain(emit_, tmask, skip, svalid)
    ll = C._log_likelihood(alpha_p, label_lens)
    post = C.ctc_beta_post_kernel(emit_, tmask, skip, svalid, last,
                                  alpha_p, ll)
    post_p = C._beta_post_plain(emit_, tmask, skip, svalid, last,
                                alpha_p, ll)
    torch.cuda.synchronize()
    launched = (C.ctc_alpha_kernel.launches - n_a,
                C.ctc_beta_post_kernel.launches - n_b)
    live = alpha_p > -1e29
    diff = (alpha - alpha_p).abs()
    a_err = float(diff[live].max()) if bool(live.any()) else 0.0
    a_rel = float((diff / alpha_p.abs().clamp(min=1.0))[live].max()) \
        if bool(live.any()) else 0.0
    dead_ok = bool((alpha[~live] <= -1e29).all())
    p_err = float((post - post_p).abs().max())
    finite = bool(torch.isfinite(post).all())
    T, Bc, S = emit_.shape
    emit({"phase": "kernel_check", "kernel": "ctc_alpha+ctc_beta_post",
          "lattice": name, "T": T, "B": Bc, "S": S,
          "plan_k_W_smem": C.warp_plan(T, S),
          "rows_of_length_0": int((~tmask.any(0)).sum()),
          "alpha_max_abs_err_live": a_err,
          "alpha_max_rel_err_live": a_rel, "alpha_dead_cells_agree": dead_ok,
          "post_max_abs_err": p_err, "post_finite": finite,
          "launches": launched, "tol_alpha_rel": TOL_ALPHA_REL,
          "tol_post": TOL_POST})
    check(a_rel <= TOL_ALPHA_REL and dead_ok,
          f"ctc_alpha disagrees with its plain version at {name}: {a_rel}")
    check(p_err <= TOL_POST and finite,
          f"ctc_beta_post disagrees with its plain version at {name}: "
          f"{p_err}")
    check(launched == (1, 1), f"K2/K3 at {name} did not launch their "
                              f"kernels once each: {launched}")
    repeats_equal(torch, "ctc_alpha", name,
                  lambda: C.ctc_alpha_kernel(emit_, tmask, skip, svalid))
    repeats_equal(torch, "ctc_beta_post", name,
                  lambda: C.ctc_beta_post_kernel(emit_, tmask, skip, svalid,
                                                 last, alpha_p, ll))
    return a_err, p_err


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
    for name, Bc, Hc, (layer, T, D) in (vgg_case(), ls100_case()):
        cases.append((name, Bc, Hc, layer, T, D, False))
    return cases


def products_inputs(torch, Bc, Hc, layer, T, D, ones, dev, cd=None):
    """A layer's x, lens, w_x and K1-fwd's h stream y (the training form,
    in the compute dtype ``cd``, bf16 by default), and the reverse
    recurrence's dg on them: the products' inputs as the training path
    hands them over."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args = layer_inputs(torch, Bc, T, D, Hc, layer, dev)
    x, lens, w_x, b_x, w_hf, w_hb = args
    if ones:
        lens = torch.ones_like(lens)
        args = (x, lens, w_x, b_x, w_hf, w_hb)
    dy = layer_cotangent(torch, Bc, T, Hc, layer, dev)
    cd = cd or torch.bfloat16
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd, with_cell=True)
    dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy, cd)
    return x, lens, w_x, y, dg


def f32_cases(products_or_proj):
    """The f32 route's shapes (name, B, H, layer, T, D, every length 1):
    the milestones' three layers (B=16, H=256, the 4.0 s bucket: every
    milestone, english_m5 and english_m5_bpe run f32), then PRODUCTS_RAGGED
    or PROJ_RAGGED."""
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames

    config = load_config(MILESTONES[1])
    fc = config.frontend
    T0 = num_frames(int(BUCKET_SEC * fc.sample_rate), fc.win_length,
                    fc.hop_length)
    cases = [("milestones", config.data.batch_size, config.model.enc_hidden,
              layer, T, D, False) for layer, T, D in layer_shapes(config, T0)]
    ragged = PRODUCTS_RAGGED if products_or_proj == "products" else PROJ_RAGGED
    return cases + [(name, Bc, Hc, 0, T, D, ones)
                    for name, Bc, T, D, Hc, ones in ragged]


def check_products_kernels(torch, config, shapes, dev, m2_config):
    """Phase 3, K1-bwd's products through their own entry
    (``bilstm_fused_bwd_products_kernel``: bf16 on wgmma, f32 on
    ring_kernel) against their plain twin on the same dg: bf16 at the
    flagship's 3 layer shapes, milestone 2's, vgg_blstm's layer 0 and
    PRODUCTS_RAGGED, f32 at ``f32_cases`` (the milestones' 3 layer shapes
    and PRODUCTS_RAGGED), within TOL_PRODUCTS (TOL_BWD's f32 entry); dx
    exactly 0 past each row's length. Returns the max abs errors at the
    flagship's shapes (bf16) and at the milestones' (f32)."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    errs = {"bfloat16": [], "float32": []}
    for cd_name, cases in (
            ("bfloat16", products_cases(config, shapes, m2_config)),
            ("float32", f32_cases("products"))):
        cd = getattr(torch, cd_name)
        for name, Bc, Hc, layer, T, D, ones in cases:
            x, lens, w_x, y, dg = products_inputs(torch, Bc, Hc, layer, T, D,
                                                  ones, dev, cd)
            n = K.bilstm_fused_bwd_products_kernel.launches
            n32 = K.bilstm_fused_bwd_products_kernel.f32_launches
            got = K.bilstm_fused_bwd_products_kernel(x, lens, w_x, y, dg, cd)
            ref = K.bilstm_fused_bwd_products_plain(x, lens, w_x, y, dg, cd)
            torch.cuda.synchronize()
            past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
            rec = {"phase": "kernel_check", "kernel": "bilstm_bwd_products",
                   "shapes": name, "layer": layer, "B": Bc, "T": T, "D": D,
                   "H": Hc, "compute_dtype": cd_name,
                   "launches": K.bilstm_fused_bwd_products_kernel.launches - n,
                   "f32_launches":
                       K.bilstm_fused_bwd_products_kernel.f32_launches - n32,
                   "dx_zero_past_lens": not bool(got[0][past].any()),
                   "tol_rel": TOL_PRODUCTS}
            for out, g, r in zip(("dx", "dw_x", "db", "dw_hf", "dw_hb"), got,
                                 ref):
                rec[out] = {"max_abs_err": float((g - r).abs().max()),
                            "rel_err": rel_err(g, r),
                            "max_abs": float(r.abs().max())}
                check(bool(torch.isfinite(g).all())
                      and rel_err(g, r) <= TOL_PRODUCTS,
                      f"bilstm_bwd_products {out} disagrees with its plain "
                      f"twin at {name} layer {layer} {cd_name}: "
                      f"{rel_err(g, r)}")
                if name in ("flagship", "milestones"):
                    errs[cd_name].append(rec[out]["max_abs_err"])
            emit(rec)
            check(rec["launches"] == 1 and rec["dx_zero_past_lens"]
                  and rec["f32_launches"] == (cd_name == "float32"),
                  f"bilstm_bwd_products at {name} layer {layer} {cd_name}: "
                  f"{rec}")
            repeats_equal(torch, "bilstm_bwd_products",
                          f"{name} layer {layer} {cd_name}",
                          lambda: K.bilstm_fused_bwd_products_kernel(
                              x, lens, w_x, y, dg, cd))
            del x, lens, w_x, y, dg, got, ref
    return errs


def check_projection_kernels(torch, config, shapes, dev):
    """Phase 3, K1-fwd's projection through its own entry
    (``bilstm_fused_proj_kernel``: bf16 on wgmma, f32 on ring_kernel)
    against its plain twin: bf16 at the flagship's 3 layer shapes,
    PROJ_RAGGED and vgg_blstm's layer 0, round_xg off and on; f32 at
    ``f32_cases`` (the milestones' 3 layer shapes and PROJ_RAGGED): within
    TOL_PROJ of the output's largest magnitude, with bf16's round_xg plus
    one bf16 ulp of each element; the backward half exactly 0 past each
    row's length. Returns the max abs errors at the flagship's shapes
    (bf16, round_xg off) and at the milestones' (f32)."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    H, B = config.model.enc_hidden, config.data.batch_size
    cases = [("flagship", B, H, layer, T, D, False) for layer, T, D in shapes]
    cases += [(name, Bc, Hc, 0, T, D, ones)
              for name, Bc, T, D, Hc, ones in PROJ_RAGGED]
    name, Bc, Hc, (layer, T, D) = vgg_case()
    cases.append((name, Bc, Hc, layer, T, D, False))
    errs = {"bfloat16": [], "float32": []}
    for cd_name, cd_cases, xg_rounds in (
            ("bfloat16", cases, (False, True)),
            ("float32", f32_cases("projection"), (False,))):
        cd = getattr(torch, cd_name)
        for name, Bc, Hc, layer, T, D, ones in cd_cases:
            x, lens, w_x, b_x, _, _ = layer_inputs(torch, Bc, T, D, Hc, layer,
                                                   dev)
            if ones:
                lens = torch.ones_like(lens)
            for round_xg in xg_rounds:
                n = K.bilstm_fused_proj_kernel.launches
                n32 = K.bilstm_fused_proj_kernel.f32_launches
                got = K.bilstm_fused_proj_kernel(x, lens, w_x, b_x, cd,
                                                 round_xg)
                ref = K.bilstm_fused_proj_plain(x, lens, w_x, b_x, cd,
                                                round_xg)
                torch.cuda.synchronize()
                diff = (got - ref).abs()
                top = float(ref.abs().max())
                ulp = BF16_ULP * ref.abs() if round_xg else 0.0
                ok = bool((diff <= TOL_PROJ * top + ulp).all())
                past = (torch.arange(T, device=dev)[None, :] >= lens[:, None])
                zero = not bool(got[..., 4 * Hc:][past].any())
                bf16 = cd_name == "bfloat16"
                rec = {"phase": "kernel_check",
                       "kernel": "bilstm_fwd_projection",
                       "shapes": name, "layer": layer, "B": Bc, "T": T,
                       "D": D, "H": Hc, "compute_dtype": cd_name,
                       "round_xg": round_xg,
                       "launches": K.bilstm_fused_proj_kernel.launches - n,
                       "f32_launches":
                           K.bilstm_fused_proj_kernel.f32_launches - n32,
                       "max_abs_err": float(diff.max()),
                       "rel_err": rel_err(got, ref),
                       "max_abs": top, "tol_rel": TOL_PROJ,
                       "tol_ulp": BF16_ULP if round_xg else 0.0,
                       "backward_half_zero_past_lens": zero,
                       "finite": bool(torch.isfinite(got).all())}
                emit(rec)
                check(rec["finite"] and ok and zero
                      and (rec["launches"], rec["f32_launches"])
                      == (int(bf16), int(not bf16)),
                      f"bilstm_fwd_projection disagrees with its plain twin "
                      f"at {name} layer {layer} {cd_name} "
                      f"round_xg={round_xg}: {rec}")
                repeats_equal(torch, "bilstm_fwd_projection",
                              f"{name} layer {layer} {cd_name} "
                              f"round_xg={round_xg}",
                              lambda: K.bilstm_fused_proj_kernel(
                                  x, lens, w_x, b_x, cd, round_xg))
                if name in ("flagship", "milestones") and not round_xg:
                    errs[cd_name].append(rec["max_abs_err"])
                del got, ref, diff
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


def f32_timing(torch, dev, card):
    """Phase 8 for K1's f32 route through its own entries at the
    milestones' 3 layer shapes (B=16, H=256, the 4.0 s bucket): the
    products (``bilstm_fused_bwd_products_kernel`` on the f32
    recurrence's dg) and the projection (``bilstm_fused_proj_kernel``),
    each on ring_kernel, beside its plain twin and the library in f32
    with TF32 off (cuBLAS: ``tools/k1b_probe.py::products_library``, four
    torch.matmul and torch.sum; ``tools/k1f_probe.py::proj_library``,
    torch.addmm), with the f32 bound (operations at 67 TFLOP/s, or the
    bytes: ``products_bound``, ``proj_bound``) and TFLOP/s over the work
    the inputs need. Returns {row: (kernel ms, plain ms, library ms, bound
    ms, bound by)}, each summed over the 3 layers."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.tools.k1b_probe import (
        PEAK_F32, products_bound, products_library, products_work)
    from gluon_e2e_asr_tpu_torch.tools.k1f_probe import (
        proj_bound, proj_library, proj_work)

    f32 = torch.float32
    sums = {"bilstm_bwd_products_f32": [0.0] * 4,
            "bilstm_fwd_projection_f32": [0.0] * 4}
    by = {}
    for name, Bc, Hc, layer, T, D, ones in f32_cases("products")[:3]:
        x, lens, w_x, y, dg = products_inputs(torch, Bc, Hc, layer, T, D,
                                              ones, dev, f32)
        b_x = layer_inputs(torch, Bc, T, D, Hc, layer, dev)[3]
        lens_h = lens.cpu().tolist()
        for row, run, plain, lib, work, bound in (
                ("bilstm_bwd_products_f32",
                 lambda: K.bilstm_fused_bwd_products_kernel(
                     x, lens, w_x, y, dg, f32),
                 lambda: K.bilstm_fused_bwd_products_plain(
                     x, lens, w_x, y, dg, f32),
                 products_library(x, w_x, y, dg, f32), products_work,
                 products_bound),
                ("bilstm_fwd_projection_f32",
                 lambda: K.bilstm_fused_proj_kernel(x, lens, w_x, b_x, f32),
                 lambda: K.bilstm_fused_proj_plain(x, lens, w_x, b_x, f32),
                 proj_library(x, w_x, b_x, f32), proj_work, proj_bound)):
            k_ms = time_ms(torch, run)
            p_ms = time_ms(torch, plain, n=5, warm=1)
            l_ms = time_ms(torch, lib)
            ops, _ = work(lens_h, T, D, Hc)
            b_ms, by[row] = bound(lens_h, T, D, Hc, PEAK_F32)
            emit({"phase": "timing", "what": row, "shapes": name,
                  "layer": layer, "B": Bc, "T": T, "D": D, "H": Hc,
                  "compute_dtype": "float32", "kernel_ms": k_ms,
                  "plain_ms": p_ms, "plain_runs": 5,
                  "library_ms": l_ms, "bound_ms": b_ms, "bound_by": by[row],
                  "kernel_share_of_bound": b_ms / k_ms,
                  "kernel_tflops": ops / k_ms / 1e9,
                  "library_tflops": ops / l_ms / 1e9,
                  "live_frames": sum(lens_h), "card": card})
            for i, v in enumerate((k_ms, p_ms, l_ms, b_ms)):
                sums[row][i] += v
        del x, lens, w_x, y, dg
    return {row: (*v, by[row]) for row, v in sums.items()}


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


def _params_of(trainer):
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


def _max_diff(a, b) -> float:
    return max(float((a[k].float() - b[k].float()).abs().max()) for k in a)


def _run_cli(torch, path, name, extra, record=None, resume=False):
    """The train CLI on the card on the config at ``path`` with ``extra``
    arguments, in OUT_DIR/``name`` (emptied first unless resuming); with
    ``record``, a list that gets each step's (loss, the batch's labels and
    lengths as bytes). Returns the trainer and its metrics lines."""
    from gluon_e2e_asr_tpu_torch import train
    from gluon_e2e_asr_tpu_torch.training import trainer as TR

    workdir = os.path.join(OUT_DIR, name)
    if not resume:
        shutil.rmtree(workdir, ignore_errors=True)
    make_step = TR.make_train_step

    def recorded(*a, **k):
        fn = make_step(*a, **k)

        def step(state, batch):
            m = fn(state, batch)
            record.append((float(m["loss"]), batch["labels"].numpy().tobytes()
                           + batch["audio_len"].numpy().tobytes()))
            return m
        return step

    if record is not None:
        TR.make_train_step = recorded
    try:
        trainer = train.main(["--config", path, *extra, "--workdir", workdir,
                              "--device", "cuda"] + (["--resume"] if resume
                                                     else []))
    finally:
        TR.make_train_step = make_step
    torch.cuda.synchronize()
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    return trainer, lines


def expected_launches(config, steps: int, eval_batches: int,
                       use_dec: bool) -> dict:
    """The launch counts of a training run of ``config`` through the train
    CLI: ``steps`` steps and ``eval_batches`` dev batches (greedy or beam:
    one encoder pass each). K2 and K3 where ``loss.mtl_alpha`` > 0, K4 in
    the config's attention mode on every step of a model with a decoder
    (``use_dec``; a stacked decoder runs plain torch, never K4), every K1
    and every K4-fwd and K4-bwd launch through its cluster kernel, every
    bf16 K1-fwd launch through the wgmma projection and every f32 K1-fwd
    and K1-bwd launch through ring_kernel (the projection's and the
    products' ``.f32_launches``), the frontend kernel of
    ``frontend.impl`` on every step and dev batch through
    ``fft_kernel``."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm

    layers = config.model.enc_layers
    kind = config.model.att_type if use_dec else None
    dec = steps if use_dec and config.model.dec_layers == 1 else 0
    ctc = steps if config.loss.mtl_alpha > 0 else 0
    # every K1-fwd and K1-bwd launch through its cluster recurrence
    # (H <= 320 in every config of the repo)
    cluster = config.model.enc_hidden <= bilstm.CLUSTER_MAX_HIDDEN
    fwd = layers * (steps + eval_batches)
    bf16 = config.model.compute_dtype == "bfloat16"
    expect = {"bilstm_fwd": fwd, "bilstm_fwd_cluster": fwd * cluster,
              "bilstm_fwd_projection": fwd * bf16,
              "bilstm_fwd_projection_f32": fwd * (not bf16),
              "bilstm_bwd": layers * steps,
              "bilstm_bwd_cluster": layers * steps * cluster,
              "bilstm_bwd_products": layers * steps,
              "bilstm_bwd_products_f32": layers * steps * (not bf16),
              "bilstm_v1_fwd_cluster": 0, "bilstm_v1_bwd_cluster": 0,
              "ctc_alpha": ctc, "ctc_beta_post": ctc,
              "las_decoder_fwd": dec, "las_decoder_bwd": dec,
              # every K4-fwd and K4-bwd launch through its cluster kernel
              # (every bucket's shape of the configs' widths routes there)
              "las_decoder_fwd_cluster": dec,
              "las_decoder_bwd_cluster": dec}
    for k in ("las_decoder_fwd", "las_decoder_bwd"):
        for m in ATT_MODES:
            expect[f"{k}_{m}"] = dec if m == kind else 0
    fe = steps + eval_batches
    impl = config.frontend.impl
    # every K5 and K6 launch through fft_kernel (every config's buckets)
    expect.update(frontend_k5=fe if impl == "pallas" else 0,
                  frontend_k6=fe if impl == "pallas_regrid" else 0,
                  frontend_k5_fft=fe if impl == "pallas" else 0,
                  frontend_k6_fft=fe if impl == "pallas_regrid" else 0,
                  bilstm_v1_fwd=0, bilstm_v1_bwd=0)
    return expect


def train_slice(torch, path, name, steps=None, extra=(), ctc_only=False,
                falls=True, shipped=False, losses_out=None):
    """Phase 6: the training CLI at full width on the config at ``path``
    as shipped (``train.dp`` too: the flagships and milestone 4 train
    data parallel at world size 1 over NCCL), with a train line every step
    and ``extra`` overrides, for ``steps`` steps or TRAIN_EPOCHS epochs;
    with ``shipped``, no override at all (its metrics lines as the config
    logs them; the step's losses read from the step itself). Every kernel
    of the path launched (K2 and K3 where ``loss.mtl_alpha`` > 0, K4 in
    the config's attention mode on every step of a model with a decoder,
    every K1 and every K4-fwd and K4-bwd launch through its cluster
    kernel) and no plain version; with ``ctc_only``, ``loss.mtl_alpha=1.0``
    and a greedy dev evaluation (a model without a decoder has no beam).
    Each epoch's dev evaluation decodes as the config's ``decode.method``
    says. The frontend kernel of the config's ``frontend.impl`` (K5 for
    pallas, K6 for pallas_regrid, none for jnp) runs on every step and dev
    batch. With ``falls``, the loss must fall. ``losses_out``, a list,
    gets each step's loss."""
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config

    extra = list(extra)
    if ctc_only:
        extra += ["--set", "loss.mtl_alpha=1.0", "--set", "decode.method=greedy"]
    if not shipped:
        extra = ["--set", "train.log_every_steps=1", *extra]
    config = load_config(path)
    apply_overrides(config, extra[1::2])
    if steps is None:
        steps = epoch_steps(config, TRAIN_EPOCHS)
    workdir = os.path.join(OUT_DIR, name)
    record = []
    reset_counts()
    t0 = time.perf_counter()
    trainer, lines = _run_cli(torch, path, name,
                              [*extra, "--max-steps", str(steps)], record)
    wall = time.perf_counter() - t0
    step_losses = [loss for loss, _ in record]
    if losses_out is not None:
        losses_out.extend(step_losses)
    launches, plain = read_counts()
    train_lines = [r for r in lines if r["event"] == "train"]
    losses = [r["loss"] for r in train_lines]
    epochs = [r for r in lines if r["event"] == "epoch"]
    dev_batches = len(list(trainer.dev_loader.sampler.epoch_batches(0)))
    use_dec = trainer.model.use_decoder
    kind = config.model.att_type if use_dec else None
    expect = expected_launches(config, steps, dev_batches * len(epochs),
                               use_dec)
    impl = config.frontend.impl
    ckpt = os.path.join(workdir, config.train.ckpt_dir, f"ckpt_{steps}.pt")
    k = min(5, max(1, steps // 2))
    first = float(np.mean(step_losses[:k]))
    last = float(np.mean(step_losses[-k:]))
    dc = trainer.config.decode
    evaluation = ({"method": dc.method, "beam_size": dc.beam_size,
                   "ctc_weight": dc.ctc_weight} if trainer._beam is not None
                  else {"method": "greedy"})
    world = trainer.world
    emit({"phase": "train_slice", "config": os.path.relpath(path, REPO),
          "name": name, "objective": "hybrid" if use_dec else "ctc",
          "overrides": extra[1::2], "frontend_impl": impl,
          "att_type": kind, "mtl_alpha": trainer.config.loss.mtl_alpha,
          "scheduled_sampling": trainer.config.loss.scheduled_sampling,
          "compute_dtype": config.model.compute_dtype,
          "train_dp": config.train.dp, "world_size": world.size,
          "backend": (torch.distributed.get_backend(world.group)
                      if world.group is not None else None),
          "steps": trainer.state.step,
          "wall_s": round(wall, 2), "launches": launches,
          "expected_launches": expect, "plain_calls": plain,
          "dev_evaluation": evaluation,
          "epochs": [{k_: r[k_] for k_ in ("epoch", "step", "dev_wer",
                                           "dev_cer", "epoch_time_s",
                                           "utt_per_sec_per_chip")}
                     for r in epochs],
          "dev_batches_per_eval": dev_batches, "losses": step_losses,
          "logged_losses": losses,
          "loss_att": [r["loss_att"] for r in train_lines],
          "att_acc": [r["att_acc"] for r in train_lines],
          f"loss_first{k}": first, f"loss_last{k}": last,
          "checkpoint": os.path.relpath(ckpt, REPO),
          "note": "random init: the WER means nothing"})
    check(trainer.state.step == steps == len(step_losses),
          f"trained {trainer.state.step} steps, recorded {len(step_losses)}")
    log_every = 1 if not shipped else config.train.log_every_steps
    check(len(losses) == steps // log_every,
          f"{len(losses)} train lines for {steps} steps")
    check(config.train.dp == (world.group is not None) and world.size == 1,
          f"train.dp={config.train.dp} ran at world size {world.size} "
          f"(group {world.group})")
    check(launches == expect, f"training launches {launches}, expected {expect}")
    check(not any(plain.values()), f"plain versions ran in training: {plain}")
    check(all(np.isfinite(step_losses)), f"non-finite loss: {step_losses}")
    check(last < first or not falls,
          f"the loss did not fall: first {first}, last {last}")
    if use_dec:
        check(all(r["loss_att"] > 0 and 0.0 <= r["att_acc"] <= 1.0
                  for r in train_lines), "loss_att / att_acc not logged")
    check(all("dev_wer" in r and "dev_cer" in r for r in epochs),
          "an epoch line without dev_wer / dev_cer")
    check(os.path.exists(ckpt), f"no checkpoint at {ckpt}")
    return trainer, launches


def milestone_slices(torch, dev, card):
    """Phase 6b: milestones 1, 3, 4 and 5 through the training CLI as
    shipped (no override: milestone 4 at train.dp, world size 1 over
    NCCL) for their first epoch, its dev evaluation by the config's method
    (milestone 3: the attention-only beam, K=8), each run's launch counts
    (no K2 or K3 at milestone 3's mtl_alpha 0; every K1 and K4 launch
    through the cluster kernels), no plain version and a falling loss;
    then its checkpoint through the decode CLI by the config's method (the
    beams on the first MILESTONE_BEAM_UTTS dev utterances); and, timed, a
    step at the 4.0 s bucket and a decode of that batch by the config's
    method. Every f32 K1-fwd and K1-bwd launch of the runs goes through
    ring_kernel (``expected_launches``). Returns {milestone: launches of
    its training run}."""
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
    from gluon_e2e_asr_tpu_torch.decoding.greedy import make_greedy_decoder
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device

    counts = {}
    for n, path in MILESTONES.items():
        config = load_config(path)
        name = f"milestone{n}"
        trainer, counts[n] = train_slice(torch, path, name,
                                         epoch_steps(config, 1), shipped=True)
        c = counts[n]
        if config.model.compute_dtype == "float32":
            check(c["bilstm_fwd_projection_f32"] == c["bilstm_fwd"] > 0
                  and c["bilstm_bwd_products_f32"] == c["bilstm_bwd"] > 0,
                  f"milestone {n}: an f32 K1 launch missed ring_kernel: {c}")
        beam = config.decode.method != "greedy"
        decode_slice(torch, trainer, path, name,
                     MILESTONE_BEAM_UTTS if beam else 0)
        b = bucket_batch(torch, config)[0]
        batch = batch_to_device(b, dev)
        step = stepper(torch, trainer, dev)
        step_ms = time_ms(torch, lambda: step(batch))
        dp_ms = None
        if trainer.world.group is not None:
            # the shipped data-parallel step: world size 1 over NCCL
            step = stepper(torch, trainer, dev, world=trainer.world)
            dp_ms = time_ms(torch, lambda: step(batch))
        model = trainer.model.eval()
        if beam:
            decoder = make_beam_decoder(model, config, trainer.tokenizer,
                                        trainer.cmvn_stats, device=dev)
            dec_ms = host_ms(torch, lambda: decoder(b.audio, b.audio_len))
            runs = N_BEAM_TIMED
        else:
            decoder = make_greedy_decoder(model, config, trainer.cmvn_stats,
                                          dev)
            dec_ms = time_ms(torch, lambda: [t.cpu() for t in decoder(
                b.audio, b.audio_len)])
            runs = N_TIMED
        emit({"phase": "timing", "what": "milestone", "milestone": n,
              "config": os.path.relpath(path, REPO), "shape": "4.0 s bucket",
              "B": int(b.audio.shape[0]), "samples": int(b.audio.shape[1]),
              "max_labels": int(b.labels.shape[1]),
              "mtl_alpha": config.loss.mtl_alpha,
              "att_type": config.model.att_type if trainer.model.use_decoder
              else None, "dtype": config.model.compute_dtype,
              "train_step_ms": step_ms,
              "utt_per_s": b.num_real / (step_ms / 1e3),
              "train_step_dp_world1_ms": dp_ms,
              "decode_method": config.decode.method,
              "beam_size": config.decode.beam_size if beam else None,
              "ctc_weight": config.decode.ctc_weight if beam else None,
              "decode_ms": dec_ms, "decode_runs": runs,
              "decode_basis": "host audio in, hypotheses (beam) or ids "
                              "(greedy) on the host; greedy CUDA events, "
                              "beam host clock",
              "card": card})
        del step, decoder, trainer, model
    return counts


def profiler_traces(card) -> dict:
    """Phase 8's torch.profiler readings of single calls, from a fresh
    child process (this script with ``--traces``, ``trace_worker``): late
    in a long run this process's traces came back short or empty, while a
    fresh process's held every launch. Emits milestone 5's f32 profile
    (``f32_step_profile``) and returns {"ctc": ..., "frontend": ...} for
    ``ctc_timing`` and ``frontend_timing``."""
    out = os.path.join(OUT_DIR, "traces.json")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--traces", out], cwd=REPO, capture_output=True,
                          text=True, timeout=900)
    check(proc.returncode == 0, f"the --traces process failed (rc "
                                f"{proc.returncode}): {proc.stderr[-3000:]}")
    with open(out) as f:
        traces = json.load(f)
    emit({"phase": "traces", "seconds": round(time.perf_counter() - t0, 1),
          "card": card})
    f32_step_profile(card, **traces["m5"])
    return traces


def trace_worker(out: str) -> None:
    """``chip_smoke.py --traces <out.json>`` (phase 8 starts it): in a fresh
    process, K2's and K3's device time at the flagship's 4.0 s batch and
    at bench.py's shape and the device operations of five calls of each
    at the former; K5's and K6's device time at each of
    ``frontend_cases`` and the device operations of five calls of each at
    milestone 2's 4.0 s bucket; milestone 5's f32 train step at its 4.0 s
    bucket by kernel (``f32_step_trace``; a fresh model from seed 0,
    ``train.dp`` off). Writes them to ``out``."""
    import torch

    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
    from gluon_e2e_asr_tpu_torch.frontend import fused as FE
    from gluon_e2e_asr_tpu_torch.ops import ctc as C
    from gluon_e2e_asr_tpu_torch.tools import ctc_probe, fe_probe
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device
    from gluon_e2e_asr_tpu_torch.training.trainer import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    config, m2_config = load_config(CONFIG), load_config(M2_CONFIG)
    result = {"ctc": {}, "frontend": {}}
    for shape, batch in (("4.0 s bucket", real_ctc_batch(torch, config, dev)),
                         ("bench.py", bench_ctc_batch(torch, config, dev))):
        emit_, tmask, skip, svalid, label_lens = batch
        alpha = C.ctc_alpha_kernel(emit_, tmask, skip, svalid)
        ll = C._log_likelihood(alpha, label_lens)
        last = 2 * label_lens
        calls = {"ctc_alpha": lambda: C.ctc_alpha_kernel(
                     emit_, tmask, skip, svalid),
                 "ctc_beta_post": lambda: C.ctc_beta_post_kernel(
                     emit_, tmask, skip, svalid, last, alpha, ll)}
        result["ctc"][shape] = {
            name: {"device_ms": ctc_probe.device_ms(call, (name,)),
                   "events": ctc_probe.one_call(call)
                   if shape == "4.0 s bucket" else None}
            for name, call in calls.items()}
    for case, fc, B, sec in frontend_cases(m2_config, config):
        audio, alen = frontend_audio(torch, B, sec, dev)
        calls = {"frontend_k5": lambda: FE.compute_features_pallas_kernel(
                     fc, audio, alen),
                 "frontend_k6": lambda: FE.compute_features_pallas_regrid_kernel(
                     fc, audio, alen)}
        result["frontend"][case] = {
            "device_ms": {k: fe_probe.device_ms(c) for k, c in calls.items()},
            "ops": {k: fe_probe.one_call(c) for k, c in calls.items()}
            if case == "milestone2 4.0 s" else None}
    config = load_config(MILESTONES[5])
    apply_overrides(config, ["train.dp=false"])
    workdir = os.path.join(OUT_DIR, "traces_m5")
    os.makedirs(workdir, exist_ok=True)
    trainer = Trainer(config, workdir=workdir, device=dev)
    batch = batch_to_device(bucket_batch(torch, config)[0], dev)
    step = stepper(torch, trainer, dev)
    result["m5"] = f32_step_trace(torch, lambda: step(batch),
                                  config.model.enc_layers)
    with open(out, "w") as f:
        json.dump(result, f)


def f32_step_trace(torch, fn, layers, steps=3) -> dict:
    """torch.profiler over ``steps`` f32 train steps (``fn``): the host ms
    a step and {kernel name (a template's instances together): [device ms
    a step, launches a step]}. A trace that holds fewer than the 4
    ring_kernel launches a layer a step that the step makes (short or
    empty) is taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    from gluon_e2e_asr_tpu_torch.tools.k1b_probe import kernel_name

    for _ in range(3):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(steps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / steps
        by = {}
        for evt in prof.key_averages():
            us = getattr(evt, "self_device_time_total", None)
            if us is None:
                us = getattr(evt, "self_cuda_time_total", 0)
            if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
                ms, n = by.get(kernel_name(evt.key), (0.0, 0))
                by[kernel_name(evt.key)] = (ms + us / 1e3 / steps,
                                            n + evt.count // steps)
        if by.get("ring_kernel", (0.0, 0))[1] >= layers * 4:
            break
    return {"wall_ms_per_step": wall, "by_kernel": by, "layers": layers,
            "steps": steps}


def f32_step_profile(card, wall_ms_per_step, by_kernel, layers, steps):
    """Milestone 5's f32 train step at the 4.0 s bucket by kernel
    (``f32_step_trace``'s reading): device time by kernel name, the share
    of K1's f32 projection and products (ring_kernel), and the check that
    every f32 product ran on ring_kernel: 4 launches a K1 layer, its
    forward's projection and its backward's dx, dW_x with db and the two
    directions' dW_h, and none of the first kernels."""
    busy = sum(ms for ms, _ in by_kernel.values())
    rows = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])
    ring = by_kernel.get("ring_kernel", (0.0, 0))
    old = {k: v for k, v in by_kernel.items()
           if k in ("proj_f32_kernel", "gemm_f32_kernel", "colsum_kernel")}
    wall = wall_ms_per_step
    emit({"phase": "profile", "what": "milestone 5 f32 train step, 4.0 s "
                                      "bucket",
          "steps": steps, "wall_ms_per_step": wall,
          "device_busy_ms_per_step": busy,
          "idle_share": 1.0 - busy / wall if wall > 0 else None,
          "by_kernel": [{"kernel": k, "ms_per_step": ms,
                         "launches_per_step": n, "share": ms / busy}
                        for k, (ms, n) in rows[:20]],
          "ring_kernel": {"ms_per_step": ring[0], "launches_per_step": ring[1],
                          "share": ring[0] / busy if busy else None},
          "first_f32_kernels": old, "basis": "phase 8's --traces process",
          "card": card})
    check(busy > 0 and ring[1] == layers * 4 and not old,
          f"milestone 5's f32 step: ring_kernel {ring}, first kernels {old} "
          f"(expected {layers * 4} ring_kernel launches a step, none of the "
          "first kernels)")


def state_of(torch, model, state) -> dict:
    """A training run's state as tensors: every parameter and buffer, every
    optimizer slot, the update count and the step's generator."""
    out = {f"param {k}": v.detach().clone()
           for k, v in model.state_dict().items()}
    for slot, v in state.opt_state.items():
        if isinstance(v, dict):
            out.update({f"{slot} {k}": t.detach().clone()
                        for k, t in v.items()})
        elif not isinstance(v, str):
            out[f"opt {slot}"] = torch.tensor(float(v), dtype=torch.float64)
    out["step"] = torch.tensor(state.step)
    out["generator"] = state.generator.get_state()
    return out


def state_diff(torch, a: dict, b: dict) -> dict:
    """(every entry of two ``state_of`` results torch.equal, the entries
    that differ, the largest float difference)."""
    differ = sorted(k for k in a if k not in b or not torch.equal(a[k], b[k]))
    differ += sorted(k for k in b if k not in a)
    diff = max((float((a[k].double() - b[k].double()).abs().max())
                for k in differ if k in a and k in b
                and a[k].is_floating_point() and a[k].shape == b[k].shape),
               default=0.0)
    return {"equal": not differ, "differ": differ[:20],
            "n_differ": len(differ), "max_abs_diff": diff}


def resume_check(torch, card):
    """Phase 6c, resume: milestone 4 as shipped (f32, loc, train.dp at world
    size 1) with a mid-epoch checkpoint every ckpt_every steps,
    RESUME_REFS uninterrupted runs of 2 epochs, a run stopped mid-epoch 1
    by max_steps, and a fresh trainer resumed from its checkpoint through
    ``train.py --resume``: the step count and the batches of every step
    after the resume the first uninterrupted run's, and every parameter,
    Adam slot and the generator state equal to it bit for bit, as the
    uninterrupted runs are to each other (the JAX package's contract,
    ``tests/test_resume_fault.py``). Returns that run's trainer."""
    from gluon_e2e_asr_tpu_torch.config import load_config

    path = MILESTONES[4]
    config = load_config(path)
    per_epoch = epoch_steps(config, 1)
    total, stop = epoch_steps(config, 2), per_epoch + per_epoch // 2
    every = per_epoch // 4
    common = ["--set", "train.num_epochs=2", "--set",
              f"train.ckpt_every_steps={every}", "--set",
              "train.log_every_steps=1"]
    t0 = time.perf_counter()
    ref_rec, resumed_rec = [], []
    refs = [_run_cli(torch, path, f"resume_ref{i}", common,
                     ref_rec if i == 0 else None)[0]
            for i in range(RESUME_REFS)]
    ref = refs[0]
    cut, _ = _run_cli(torch, path, "resume_cut",
                      common + ["--max-steps", str(stop)])
    cut_step = cut.state.step
    resumed, lines = _run_cli(torch, path, "resume_cut", common,
                              resumed_rec, resume=True)
    wall = time.perf_counter() - t0
    s_refs = [state_of(torch, t.model, t.state) for t in refs]
    pairs = [state_diff(torch, a, b) for i, a in enumerate(s_refs)
             for b in s_refs[i + 1:]]
    resumed_diff = state_diff(torch, state_of(torch, resumed.model,
                                              resumed.state), s_refs[0])
    same_batches = ([b for _, b in resumed_rec]
                    == [b for _, b in ref_rec[cut_step:]])
    res_line = [r for r in lines if r["event"] == "resume"]
    loss_diff = max(abs(a - b) for (a, _), (b, _) in
                    zip(resumed_rec, ref_rec[cut_step:]))
    emit({"phase": "training_options", "option": "resume",
          "config": os.path.relpath(path, REPO), "steps": total,
          "stopped_at_step": cut_step, "ckpt_every_steps": every,
          "resume_line": res_line[-1] if res_line else None,
          "resumed_steps": resumed.state.step,
          "state_entries": len(s_refs[0]),
          "params_max_abs_diff_resumed_vs_uninterrupted":
              resumed_diff["max_abs_diff"],
          "resumed_vs_uninterrupted": resumed_diff,
          "params_max_abs_diff_uninterrupted_pairs":
              [p["max_abs_diff"] for p in pairs],
          "uninterrupted_pairs": pairs,
          "step_loss_max_abs_diff_after_resume": loss_diff,
          "same_batches_after_resume": same_batches,
          "same_generator_state": "generator" not in resumed_diff["differ"],
          "wall_s": round(wall, 2), "card": card})
    check(cut_step == stop and resumed.state.step == ref.state.step == total,
          f"resume: stopped at {cut_step}, resumed to {resumed.state.step}, "
          f"the uninterrupted runs reached {ref.state.step}")
    check(res_line and res_line[-1]["epoch"] == 1
          and res_line[-1]["skip_batches"] == per_epoch // 2,
          f"resume: the resume line {res_line}")
    check(same_batches and len(resumed_rec) == total - stop,
          "resume: the steps after the resume took other batches")
    check(all(p["equal"] for p in pairs),
          f"resume: two uninterrupted runs differ: {pairs}")
    check(resumed_diff["equal"] and loss_diff == 0.0,
          f"resume: the resumed run differs from the uninterrupted one: "
          f"{resumed_diff}, step losses by {loss_diff}")
    return ref


def repro_batch(torch, path, shape):
    """(batch on the host, tokenizer) of a REPRO_CASES entry, from the
    config at ``path`` as shipped (an entry's overrides leave its data
    alone, and an earlier phase's bucket_batch of the config serves it):
    the config's 4.0 s bucket, or bench.py's batch (labels folded into
    the vocabulary as bucket_batch folds them)."""
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.training.trainer import (
        build_datasets, build_tokenizer)

    config = load_config(path)
    if shape == "bucket":
        b, tok, _, _ = bucket_batch(torch, config)
    else:
        key = config.fingerprint()
        if key in _BATCH:
            tok = _BATCH[key][1]
        else:
            utts, _ = build_datasets(config)
            tok = build_tokenizer(config, (u.text for u in utts))
        sb = synth_batch(config.data.batch_size, BENCH_SEC, BENCH_LABELS, SEED)
        sb["labels"] = np.where(sb["labels"] > 0,
                                4 + sb["labels"] % (tok.vocab_size - 4), 0)
        b = types.SimpleNamespace(**sb)
    return {k: torch.from_numpy(np.asarray(getattr(b, k)))
            for k in ("audio", "audio_len", "labels", "label_len")}, tok


def repro_run(torch, config, tok, batch, dev, steps):
    """``steps`` updates of a fresh model of ``config`` (parameters and
    generator from ``train.seed``, as the trainer starts) on ``batch``;
    with ``train.accum_grad_steps`` 2, each update over the batch's two
    halves. Returns (state_of the run, plus the last pass's gradients)."""
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training import train_step as T

    model = build_model(config, tok.vocab_size, train=True,
                        sos_id=tok.sos_id, eos_id=tok.eos_id)
    opt = T.make_optimizer(config)
    state = T.create_train_state(config, model, opt, dev)
    batch = {k: v.to(dev) for k, v in batch.items()}
    if config.train.accum_grad_steps > 1:
        grad_fn, acc = T.make_grad_step(model, config), T.Accumulator(model, opt)
        half = batch["audio"].shape[0] // 2
        for _ in range(steps):
            for rows in (slice(0, half), slice(half, None)):
                acc.add(*grad_fn(state, {k: v[rows] for k, v in batch.items()}))
            acc.apply(state)
    else:
        step = T.make_train_step(model, config, opt)
        for _ in range(steps):
            step(state, batch)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    out = state_of(torch, model, state)
    out.update({f"grad {k}": p.grad.detach().clone()
                for k, p in model.named_parameters() if p.grad is not None})
    return out


def repro_config(case):
    """(the config of a REPRO_CASES entry with its overrides, its batch's
    shape); repro_run trains at world size 1 whatever ``train.dp`` says."""
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config

    _, path, sets, shape = case
    config = load_config(path)
    apply_overrides(config, list(sets))
    return config, shape


def repro_phase(torch, dev, card):
    """Phase 6e: each of REPRO_CASES run twice from the same state for
    REPRO_STEPS updates through the kernels, the two runs equal bit for
    bit; then the same forms a step each in a child process under
    torch.use_deterministic_algorithms(True) (``deterministic_worker``),
    which must pass and run none of ACCUMULATING_OPS on the card, and no
    cuDNN convolution backward outside cuDNN's deterministic algorithms."""
    t0 = time.perf_counter()
    for case in REPRO_CASES:
        t_case = time.perf_counter()
        config, shape = repro_config(case)
        batch, tok = repro_batch(torch, case[1], shape)
        runs = [repro_run(torch, config, tok, batch, dev, REPRO_STEPS)
                for _ in range(2)]
        d = state_diff(torch, *runs)
        emit({"phase": "repro", "case": case[0],
              "config": os.path.relpath(case[1], REPO), "overrides": case[2],
              "B": int(batch["audio"].shape[0]),
              "samples": int(batch["audio"].shape[1]),
              "compute_dtype": config.model.compute_dtype,
              "steps": REPRO_STEPS, "entries": len(runs[0]), **d,
              "seconds": round(time.perf_counter() - t_case, 1), "card": card})
        check(d["equal"], f"two identical runs of {case[0]} differ: {d}")
        del runs
    os.makedirs(OUT_DIR, exist_ok=True)
    t_child = time.perf_counter()
    out = os.path.join(OUT_DIR, "deterministic.json")
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--deterministic", out], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=900)
    result = {}
    if proc.returncode == 0:
        with open(out) as f:
            result = json.load(f)
    emit({"phase": "repro", "case": "use_deterministic_algorithms(True)",
          "rc": proc.returncode, "steps": result,
          "child_seconds": round(time.perf_counter() - t_child, 1),
          "seconds": round(time.perf_counter() - t0, 1), "card": card})
    check(proc.returncode == 0, f"the --deterministic process failed (rc "
                                f"{proc.returncode}): {proc.stderr[-3000:]}")
    bad = {k: v for k, v in result.items() if v["accumulating_ops"]
           or v["nondeterministic_convolutions"]}
    check(not bad, f"accumulating library operations on the card: {bad}")


def accumulation_audit(torch, device_type: str):
    """A dispatch mode that records, by op name, the operations of
    ACCUMULATING_OPS (index_put with accumulate; scatter_add with more than
    one index along its dim) run on a tensor of ``device_type``
    (``.accumulating``), and counts the cuDNN convolution backwards taken
    there while torch.backends.cudnn.deterministic was off (``.convs``)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Audit(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.accumulating, self.convs = {}, 0

        def __torch_dispatch__(self, func, types_, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.__name__.split(".")[0].rstrip("_")
            on = any(getattr(a, "device", None) is not None
                     and a.device.type == device_type for a in args)
            acc = name in ACCUMULATING_OPS or name.lstrip("_") in \
                ACCUMULATING_OPS or ("index_put" in name and (
                    kwargs.get("accumulate") or (len(args) > 3
                                                 and args[3] is True)))
            if acc and name == "scatter_add" and args[2].shape[args[1]] == 1:
                acc = False  # one index along the dim (a gather's backward)
            if on and acc:
                self.accumulating[name] = self.accumulating.get(name, 0) + 1
            if name == "convolution_backward" and on and \
                    not torch.backends.cudnn.deterministic:
                self.convs += 1
            return func(*args, **kwargs)

    return Audit()


def deterministic_worker(out: str) -> None:
    """``chip_smoke.py --deterministic <out.json>`` (phase 6e starts it,
    with CUBLAS_WORKSPACE_CONFIG set): one update of each of REPRO_CASES
    under torch.use_deterministic_algorithms(True), which raises where a
    library operation of the step has no deterministic CUDA form; and the
    ops of each step through a dispatch mode: those of ACCUMULATING_OPS
    (index_put with accumulate; scatter_add with more than one index
    along its dim) on a CUDA tensor, and cuDNN
    convolution backwards taken while torch.backends.cudnn.deterministic
    was off (the port must choose the deterministic algorithms itself,
    the mode only forces them). Writes {case: what it saw} to ``out``."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.use_deterministic_algorithms(True)
    dev = torch.device("cuda", 0)

    result = {}
    for case in REPRO_CASES:
        config, shape = repro_config(case)
        batch, tok = repro_batch(torch, case[1], shape)
        audit = accumulation_audit(torch, "cuda")
        with audit:
            repro_run(torch, config, tok, batch, dev, 1)
        result[case[0]] = {"accumulating_ops": audit.accumulating,
                           "nondeterministic_convolutions": audit.convs}
        print(json.dumps({case[0]: result[case[0]]}), flush=True)
    with open(out, "w") as f:
        json.dump(result, f)


def accum_check(torch, dev, card, trained):
    """Phase 6c, accumulation: from ``trained`` (milestone 4 after
    resume_check's 2 epochs: its parameters and Adam moments, as phase 7
    starts from a trained state), a 4.0 s batch in two halves through the
    micro-batch pass and one update (``accum_grad_steps=2``) against one
    step on the whole batch, through the kernels (SpecAugment, the coins
    and dropout off, so both take the same inputs): the loss, the combined
    gradient and the parameters after Adam within phase 7's tolerances;
    and an epoch at accum_grad_steps=2 through the train CLI counts
    ceil(batches / 2) updates, every batch through the kernels."""
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training import train_step as T

    path = MILESTONES[4]
    config = copy.deepcopy(trained.config)
    apply_overrides(config, ["frontend.specaug_freq_masks=0",
                             "frontend.specaug_time_masks=0",
                             "loss.scheduled_sampling=0.0"])
    tok = trained.tokenizer
    b = bucket_batch(torch, config)[0]
    batch = T.batch_to_device(b, dev)
    half = batch["audio"].shape[0] // 2
    runs = {}
    for how in ("whole", "accum"):
        model = build_model(config, tok.vocab_size, train=True,
                            sos_id=tok.sos_id, eos_id=tok.eos_id)
        model.load_state_dict(trained.model.state_dict())
        model.to(dev)
        opt = T.make_optimizer(config)
        state = T.TrainState(step=trained.state.step,
                             opt_state=copy.deepcopy(trained.state.opt_state),
                             generator=torch.Generator().manual_seed(SEED))
        if how == "whole":
            m = T.make_train_step(model, config, opt)(state, batch)
            grads = {k: p.grad.detach().clone()
                     for k, p in model.named_parameters()}
        else:
            grad_fn = T.make_grad_step(model, config)
            acc = T.Accumulator(model, opt)
            for rows in (slice(0, half), slice(half, None)):
                acc.add(*grad_fn(state, {k: v[rows] for k, v in batch.items()}))
            grads = {k: g / acc.n for k, g in acc.grads.items()}
            m = acc.apply(state)
        torch.cuda.synchronize()
        runs[how] = (grads, _params_of(types.SimpleNamespace(model=model)),
                     float(m["loss"]), state.step)
    (gw, pw, lw, sw), (ga, pa, la, sa) = runs["whole"], runs["accum"]
    grad_rel = max(rel_err(ga[k], gw[k]) for k in gw)
    lr = T.make_optimizer(config).lr(trained.state.opt_state["count"])
    param_lr = _max_diff(pa, pw) / lr
    loss_rel = abs(la - lw) / abs(lw)

    # an epoch at accum_grad_steps=2 through the train CLI
    batches = epoch_steps(load_config(path), 1)
    reset_counts()
    trainer, lines = _run_cli(torch, path, "accum_epoch", [
        "--set", "train.accum_grad_steps=2", "--set", "train.num_epochs=1",
        "--set", "train.log_every_steps=1"])
    launches, plain = read_counts()
    losses = [r["loss"] for r in lines if r["event"] == "train"]
    k = min(5, len(losses) // 2)
    emit({"phase": "training_options", "option": "accum_grad_steps",
          "config": os.path.relpath(path, REPO), "B": int(b.audio.shape[0]),
          "samples": int(b.audio.shape[1]), "loss_whole": lw,
          "loss_two_halves": la, "loss_rel_err": loss_rel,
          "grad_max_rel_err": grad_rel, "param_max_abs_err_over_lr": param_lr,
          "tol": {"loss_rel": TOL_STEP_LOSS, "grad_rel": TOL_STEP_GRAD,
                  "param_over_lr": TOL_STEP_PARAM_LR},
          "epoch_batches": batches, "epoch_updates": trainer.state.step,
          "epoch_launches": launches, "plain_calls": plain,
          "losses": losses, "card": card})
    check(sw == sa == trained.state.step + 1,
          f"accumulation: steps {sw} and {sa}")
    check(loss_rel <= TOL_STEP_LOSS and grad_rel <= TOL_STEP_GRAD
          and param_lr <= TOL_STEP_PARAM_LR,
          f"accumulation against the whole batch: loss {loss_rel}, "
          f"gradients {grad_rel}, parameters {param_lr} x LR")
    check(trainer.state.step == -(-batches // 2),
          f"an epoch of {batches} batches at accum_grad_steps=2 took "
          f"{trainer.state.step} updates")
    layers = config.model.enc_layers
    check(launches["bilstm_bwd"] == launches["bilstm_bwd_cluster"]
          == layers * batches and launches["las_decoder_bwd"] == batches
          and launches["ctc_alpha"] == batches and not any(plain.values()),
          f"accumulation epoch: launches {launches}, plain {plain}")
    check(np.mean(losses[-k:]) < np.mean(losses[:k]),
          f"accumulation epoch: the loss did not fall: {losses}")
    return {"grad_rel": grad_rel, "param_over_lr": param_lr}


def scripted_trainer(torch, name, overrides, wers):
    """A Trainer on the card of milestone 4 (SMALL_TRAIN utterances) with
    ``overrides``, whose dev evaluation returns the WERs of ``wers`` in
    turn; trained, returned with its metrics lines."""
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
    from gluon_e2e_asr_tpu_torch.training.trainer import Trainer

    config = load_config(MILESTONES[4])
    apply_overrides(config, [f"data.synth_num_train={SMALL_TRAIN}",
                             *overrides])
    workdir = os.path.join(OUT_DIR, name)
    shutil.rmtree(workdir, ignore_errors=True)
    trainer = Trainer(config, workdir=workdir, device=torch.device("cuda"))
    script = iter(wers)
    trainer.evaluate = lambda: {"dev_wer": next(script), "dev_cer": 0.0}
    trainer.train()
    torch.cuda.synchronize()
    with open(os.path.join(workdir, "metrics.jsonl")) as f:
        return trainer, [json.loads(line) for line in f], workdir


def plateau_checks(torch, card):
    """Phase 6c, ``eps_decay`` with ``plateau_restore_best`` (adadelta; the
    dev WERs scripted 0.5, 0.7, 0.6: epochs 1 and 2 are stale) and
    ``early_stop_patience`` 2 (0.9, 0.5, 0.5, 0.6, ...: it stops after
    epoch 3)."""
    from gluon_e2e_asr_tpu_torch.training.checkpoint import (
        restore_train_checkpoint)

    trainer, lines, workdir = scripted_trainer(torch, "plateau", [
        "train.optimizer=adadelta", "train.learning_rate=1.0",
        "train.warmup_steps=0", "train.eps_decay=0.01",
        "train.plateau_restore_best=true", "train.num_epochs=3"],
        [0.5, 0.7, 0.6])
    ckpts = os.path.join(workdir, trainer.config.train.ckpt_dir)
    best = restore_train_checkpoint(os.path.join(ckpts, "best.pt"),
                                    params_only=True)
    last = {k: v.detach().cpu() for k, v in trainer.model.state_dict().items()}
    same = all(torch.equal(last[k], best.params[k].cpu()) for k in last)
    decays = [r for r in lines if r["event"] == "eps_decay"]
    eps = trainer.state.opt_state["eps"]
    want = float(np.float32(np.float32(1e-8) * np.float32(0.01))
                 * np.float32(0.01))
    emit({"phase": "training_options", "option": "eps_decay",
          "scripted_dev_wer": [0.5, 0.7, 0.6], "eps_decay_lines": decays,
          "eps_after": eps, "params_equal_best_after_restore": same,
          "best": os.readlink(os.path.join(ckpts, "best.pt")),
          "steps": trainer.state.step, "card": card})
    check([r["epoch"] for r in decays] == [1, 2]
          and all(r["restored_best"] for r in decays) and same
          and eps == want, f"plateau annealing: {decays}, eps {eps}, the "
                           f"parameters equal best.pt's: {same}")

    trainer, lines, _ = scripted_trainer(torch, "early_stop", [
        "train.early_stop_patience=2", "train.num_epochs=10"],
        [0.9, 0.5, 0.5, 0.6, 0.4, 0.4, 0.4])
    epochs = [r["epoch"] for r in lines if r["event"] == "epoch"]
    stops = [r for r in lines if r["event"] == "early_stop"]
    emit({"phase": "training_options", "option": "early_stop_patience",
          "scripted_dev_wer": [0.9, 0.5, 0.5, 0.6], "epochs": epochs,
          "early_stop": stops, "card": card})
    check(epochs == [0, 1, 2, 3] and len(stops) == 1
          and stops[0]["epoch"] == 3 and trainer.best_wer == 0.5,
          f"early stopping: epochs {epochs}, lines {stops}")


def k1_kernel_names(torch, config, dev):
    """The device kernels one K1-fwd (training form) and K1-bwd call
    launches at ``config``'s first layer shape, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    fc, mc = config.frontend, config.model
    T = num_frames(int(BUCKET_SEC * fc.sample_rate), fc.win_length,
                   fc.hop_length)
    layer, T, D = layer_shapes(config, T)[0]
    args = layer_inputs(torch, config.data.batch_size, T, D, mc.enc_hidden,
                        layer, dev)
    dy = layer_cotangent(torch, config.data.batch_size, T, mc.enc_hidden,
                         layer, dev)
    cd = getattr(torch, mc.compute_dtype)

    def call():
        x, lens, w_x, b_x, w_hf, w_hb = args
        y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                           with_cell=True)
        K.bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, y, c, acts, dy,
                                  compute_dtype=cd)

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    return sorted({e.name for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA
                   and "cluster_kernel" in e.name})


def profile_check(torch, dev, card):
    """Phase 6c, ``profile_dir``: milestone 4 (SMALL_TRAIN utterances)
    through the train CLI with steps 2 and 3 profiled; the trace under
    profile_dir must hold K1's recurrence kernels (fwd_cluster_kernel and
    bwd_cluster_kernel, by the names a K1 call launches). A trace with no
    device operation at all is taken again in a new run, up to three
    times, as tools/ctc_probe.py::one_call retakes one, and the retakes are
    reported."""
    from gluon_e2e_asr_tpu_torch.config import load_config

    names = k1_kernel_names(torch, load_config(MILESTONES[4]), dev)
    prof_dir = os.path.join(OUT_DIR, "profile_run", "prof")
    for attempt in range(3):
        shutil.rmtree(prof_dir, ignore_errors=True)
        _run_cli(torch, MILESTONES[4], "profile_run", [
            "--set", f"data.synth_num_train={SMALL_TRAIN}", "--set",
            f"train.profile_dir={prof_dir}", "--set",
            "train.profile_start_step=2", "--set", "train.profile_num_steps=2",
            "--max-steps", "6"])
        traces = sorted(os.listdir(prof_dir))
        with open(os.path.join(prof_dir, traces[0])) as f:
            events = json.load(f)["traceEvents"]
        kernels = {e.get("name") for e in events if e.get("cat") == "kernel"}
        if kernels:
            break
    found = {n: sum(e.get("name") == n for e in events) for n in names}
    emit({"phase": "training_options", "option": "profile_dir",
          "traces": traces, "device_kernels_in_trace": len(kernels),
          "k1_kernels": found, "retakes_of_an_empty_trace": attempt,
          "card": card})
    check(traces == ["trace_2-4_rank0.json"], f"profile_dir holds {traces}")
    check(len(names) == 2 and all(found.values()),
          f"the trace lacks K1's kernels: {found}")


def training_options(torch, dev, card):
    """Phase 6c: the training options of the JAX trainer on milestone 4's
    model (f32, loc, B=16, train.dp at world size 1): resume,
    accumulation, sgd and adadelta, plateau annealing with restore-best,
    early stopping, profiling, encoder dropout and a stacked decoder
    (dec_layers=2: no K4 launch, its checkpoint decoded greedily and by
    the beam). Returns the launches of the dropout run."""
    from gluon_e2e_asr_tpu_torch.config import load_config

    path = MILESTONES[4]
    out = {"accum": accum_check(torch, dev, card, resume_check(torch, card))}
    for name, sets in (
            ("sgd", ["train.optimizer=sgd", "train.learning_rate=0.05",
                     "train.warmup_steps=0"]),
            ("adadelta", ["train.optimizer=adadelta",
                          "train.learning_rate=1.0", "train.warmup_steps=0",
                          "train.adadelta_eps=1e-6"])):
        train_slice(torch, path, f"opt_{name}", OPT_STEPS,
                    [a for s in sets for a in ("--set", s)])
    plateau_checks(torch, card)
    profile_check(torch, dev, card)
    config = load_config(path)
    _, out["dropout_launches"] = train_slice(
        torch, path, "enc_dropout", epoch_steps(config, 1),
        ["--set", "model.enc_dropout=0.1"])
    extra = ["--set", "model.dec_layers=2"]
    stacked, out["stacked_launches"] = train_slice(
        torch, path, "dec_layers2", epoch_steps(config, 1), extra)
    decode_slice(torch, stacked, path, "dec_layers2", extra=extra)
    decode_slice(torch, stacked, path, "dec_layers2", MILESTONE_BEAM_UTTS,
                 method="beam", extra=extra)
    return out


def vgg_slice(torch, dev, card):
    """Phase 6d: configs/vgg_blstm.yaml as shipped (B=96, bf16, loc,
    train.dp at world size 1): an epoch with its dev evaluation by its
    beam, the launch counts (every K1 and K4 launch through the cluster
    kernels, no plain version) and a falling loss; its checkpoint decoded
    by the beam on the first MILESTONE_BEAM_UTTS dev utterances; K1 at its
    layer 0 (D = 2560) against the plain versions, timed; a step at the
    4.0 s bucket, timed, with the VGG front's share of the device time
    from the profiler; a beam decode of that batch, timed. Returns
    (launches, the D = 2560 row)."""
    from torch.profiler import ProfilerActivity, profile

    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
    from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device

    config = load_config(VGG_CONFIG)
    trainer, launches = train_slice(torch, VGG_CONFIG, "vgg_blstm",
                                    epoch_steps(config, 1), shipped=True)
    decode_slice(torch, trainer, VGG_CONFIG, "vgg_blstm", MILESTONE_BEAM_UTTS)
    d2560 = k1_vgg_timing(torch, trainer, dev, card)

    b = bucket_batch(torch, config)[0]
    batch = batch_to_device(b, dev)
    step = stepper(torch, trainer, dev, world=trainer.world)
    step_ms = time_ms(torch, lambda: step(batch))
    step(batch)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            step(batch)
        torch.cuda.synchronize()
    rows = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            rows.append((evt.key, us / 1e3 / 3))
    busy = sum(ms for _, ms in rows)
    vgg = [(k, ms) for k, ms in rows if any(w in k for w in VGG_KERNELS)]
    vgg_ms = sum(ms for _, ms in vgg)
    rows.sort(key=lambda r: -r[1])
    # the VGG front alone, forward and backward (the parameters' gradients),
    # on the batch's features
    front = trainer.model.encoder.vgg
    with torch.no_grad():
        feats, feat_len = frontend_apply(config.frontend, batch["audio"],
                                         batch["audio_len"])
    weights = list(front.parameters())

    def front_pass():
        out, _ = front(feats, feat_len, torch.bfloat16)
        torch.autograd.grad(out, weights, torch.ones_like(out))

    front_ms = time_ms(torch, front_pass)
    decoder = make_beam_decoder(trainer.model.eval(), config,
                                trainer.tokenizer, trainer.cmvn_stats,
                                device=dev)
    beam_ms = host_ms(torch, lambda: decoder(b.audio, b.audio_len))
    emit({"phase": "timing", "what": "vgg_blstm",
          "config": os.path.relpath(VGG_CONFIG, REPO), "shape": "4.0 s bucket",
          "B": int(b.audio.shape[0]), "samples": int(b.audio.shape[1]),
          "max_labels": int(b.labels.shape[1]), "dtype": "bfloat16",
          "train_step_dp_world1_ms": step_ms,
          "utt_per_s": b.num_real / (step_ms / 1e3),
          "profiled_device_busy_ms_per_step": busy,
          "vgg_front_device_ms_per_step": vgg_ms,
          "vgg_front_share_of_busy": vgg_ms / busy if busy else None,
          "vgg_front_alone_fwd_bwd_ms": front_ms,
          "vgg_front_alone_share_of_step": front_ms / step_ms,
          "vgg_front_kernels": [{"kernel": k[:120], "ms_per_step": ms}
                                for k, ms in sorted(vgg, key=lambda r: -r[1])[:12]],
          "by_kernel": [{"kernel": k[:120], "ms_per_step": ms,
                         "share": ms / busy} for k, ms in rows[:15]],
          "vgg_basis": "profiler: device time of the kernels whose names "
                       "hold " + ", ".join(VGG_KERNELS) + " (cuDNN's "
                       "convolutions and layout transposes, the pools; the "
                       "ReLUs, re-zeroing and bias sums are not counted); "
                       "alone: CUDA events over the front's forward and the "
                       "backward to its weights on the batch's features",
          "beam_decode_ms": beam_ms,
          "beam_size": config.decode.beam_size,
          "ctc_weight": config.decode.ctc_weight,
          "decode_basis": "host audio in, hypotheses on the host, host clock",
          "card": card})
    check(busy > 0 and vgg_ms > 0, "the profiler saw no VGG2L kernel")
    del step, decoder, trainer
    return launches, d2560


def k1_vgg_timing(torch, trainer, dev, card):
    """K1 at vgg_blstm's layer 0 (B=96, T'=100, D = 2560, H=320, bf16, the
    4.0 s bucket): K1-fwd (serving form) and K1-bwd against their plain
    versions (phase 3 checks them at this shape in every form), their
    bounds and cuDNN's bidirectional LSTM (forward; backward alone) on the
    same inputs, timed by CUDA events."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    config = trainer.config
    H, B = config.model.enc_hidden, config.data.batch_size
    layer, T, D = vgg_layer0(config)
    args = layer_inputs(torch, B, T, D, H, layer, dev)
    x, lens, w_x, b_x, w_hf, w_hb = args
    dy = layer_cotangent(torch, B, T, H, layer, dev)
    cd = torch.bfloat16
    y = K.bilstm_fused_kernel(*args, compute_dtype=cd)
    y_ref = K.bilstm_fused_plain(*args, compute_dtype=cd)
    yt, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd,
                                        with_cell=True)
    got = K.bilstm_fused_bwd_kernel(x, lens, w_x, w_hf, w_hb, yt, c, acts, dy,
                                    compute_dtype=cd)
    ref = K.bilstm_fused_bwd_plain(x, lens, w_x, b_x, w_hf, w_hb, yt, c, dy,
                                   compute_dtype=cd)
    torch.cuda.synchronize()
    fwd_err = float((y - y_ref).abs().max())
    bwd_err = max(float((g - r).abs().max()) for g, r in zip(got, ref))
    bwd_rel = max(rel_err(g, r) for g, r in zip(got, ref))
    ms = {
        "bilstm_fwd": (time_ms(torch, lambda: K.bilstm_fused_kernel(
            *args, compute_dtype=cd)), time_ms(torch, lambda: K.bilstm_fused_plain(
                *args, compute_dtype=cd), n=5, warm=1)),
        "bilstm_bwd": (time_ms(torch, lambda: K.bilstm_fused_bwd_kernel(
            x, lens, w_x, w_hf, w_hb, yt, c, acts, dy, compute_dtype=cd)),
            time_ms(torch, lambda: K.bilstm_fused_bwd_plain(
                x, lens, w_x, b_x, w_hf, w_hb, yt, c, dy, compute_dtype=cd),
                n=5, warm=1))}
    bounds = k1_layer_bounds(torch, B, T, D, H, layer)
    lib = dict(zip(("bilstm_fwd", "bilstm_bwd"),
                   cudnn_lstm_ms(torch, x, lens, w_x, b_x, w_hf, w_hb, dev)))
    out = {}
    for name, err in (("bilstm_fwd", fwd_err), ("bilstm_bwd", bwd_err)):
        out[name] = {"B": B, "T": T, "D": D, "H": H, "dtype": "bfloat16",
                     "ms": ms[name][0], "plain_ms": ms[name][1],
                     "bound_ms": bounds[name][0],
                     "bound_by": bounds[name][1], "library_ms": lib[name],
                     "max_abs_err": err}
    emit({"phase": "timing", "what": "k1_vgg_layer0", **out,
          "bwd_max_rel_err": bwd_rel, "tol": TOL["bfloat16"],
          "tol_bwd_rel": TOL_BWD["bfloat16"], "card": card})
    check(fwd_err <= TOL["bfloat16"] and bwd_rel <= TOL_BWD["bfloat16"],
          f"K1 at D = {D}: fwd {fwd_err}, bwd {bwd_rel}")
    return out


def vgg_case():
    """(name, B, H, (layer, T', D)) of vgg_blstm's first BiLSTM layer at the
    4.0 s bucket, for phase 3's K1 checks: D = 2560, a reduction width no
    other config gives K1."""
    from gluon_e2e_asr_tpu_torch.config import load_config

    config = load_config(VGG_CONFIG)
    return ("vgg_blstm", config.data.batch_size, config.model.enc_hidden,
            vgg_layer0(config))


def ls100_case():
    """(name, B, H, (layer, T, D)) of ls100_full.yaml's first BiLSTM layer
    at its largest bucket (18.38 s: T = 1836, B = 32, the dynamic batch
    there), for phase 3's K1 and products checks: the longest walk over
    frames of any config."""
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.data.sampler import make_bucket_specs
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames

    config = load_config(LS100_CONFIG)
    dc, fc = config.data, config.frontend
    spec = make_bucket_specs(dc.bucket_bounds_sec, dc.sample_rate,
                             dc.batch_size, dc.max_label_len, fc.hop_length,
                             dc.dynamic_batch)[-1]
    T = num_frames(int(dc.bucket_bounds_sec[-1] * fc.sample_rate),
                   fc.win_length, fc.hop_length)
    return ("ls100_full 18.38 s", spec.batch_size, config.model.enc_hidden,
            layer_shapes(config, T)[0])


def vgg_layer0(config):
    """(layer, T', D) of vgg_blstm's first BiLSTM layer at the 4.0 s
    bucket: VGG2L's two pools halve T and the mel bins twice."""
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames

    fc, mc = config.frontend, config.model
    T = num_frames(int(BUCKET_SEC * fc.sample_rate), fc.win_length,
                   fc.hop_length)
    feat = fc.n_mels * (1 + fc.deltas) // mc.vgg_in_channels
    for _ in mc.vgg_channels:
        T, feat = (T + 1) // 2, (feat + 1) // 2
    return 0, T, feat * int(mc.vgg_channels[-1])


def dp_payload(torch, trainer):
    """What the data-parallel check's ranks and its single process share:
    the trained location-aware flagship (parameters, optimizer state,
    step, tokenizer, last checkpoint), a 4.0 s batch and the same batch
    with the rows of every rank but the first made padding, and a dev
    batch to decode."""
    b = bucket_batch(torch, trainer.config)[0]
    batch = {k: np.asarray(getattr(b, k)) for k in
             ("audio", "audio_len", "labels", "label_len")}
    pad = {k: v.copy() for k, v in batch.items()}
    rows = len(batch["audio"]) // DP_WORLD
    for v in pad.values():
        v[rows:] = 0
    dev_b = next(iter(trainer.dev_loader.epoch(0)))
    steps = trainer.state.step
    return {"state_dict": {k: v.detach().cpu() for k, v in
                           trainer.model.state_dict().items()},
            "opt_state": copy.deepcopy(trainer.state.opt_state),
            "step": steps, "tokenizer": trainer.tokenizer,
            "ckpt": os.path.join(OUT_DIR, "train_loc",
                                 trainer.config.train.ckpt_dir,
                                 f"ckpt_{steps}.pt"),
            "batch": batch, "pad_batch": pad,
            "dev_audio": dev_b.audio, "dev_audio_len": dev_b.audio_len}


def dp_runs(torch, payload, world, dev, workdir, steps_only=False):
    """One flagship_bf16 train step (SpecAugment and the coins on, as
    shipped) from the payload's state on its batch and on its padded batch,
    a greedy decode of the dev set through the decode CLI (``decode.dp``
    when ``world`` has a group) and a beam search of the dev batch, at
    ``world`` (the steps alone with ``steps_only``): {name: results on
    the host}."""
    from gluon_e2e_asr_tpu_torch import decode
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training.train_step import (
        TrainState, make_optimizer, make_train_step)

    config = load_config(LOC_CONFIG)
    tok = payload["tokenizer"]
    out = {}

    def model_at_state():
        model = build_model(config, tok.vocab_size, train=True,
                            sos_id=tok.sos_id, eos_id=tok.eos_id)
        model.load_state_dict(payload["state_dict"])
        return model.to(dev)

    opt = make_optimizer(config)
    for name in ("batch", "pad_batch"):
        model = model_at_state()
        state = TrainState(
            step=payload["step"],
            opt_state={k: ({n: t.to(dev) for n, t in v.items()}
                           if isinstance(v, dict) else v)
                       for k, v in payload["opt_state"].items()},
            generator=torch.Generator().manual_seed(SEED))
        fn = make_train_step(model, config, opt, world=world)
        m = fn(state, {k: torch.from_numpy(v) for k, v in payload[name].items()})
        torch.cuda.synchronize()
        out[name] = {
            "metrics": {k: float(v) for k, v in m.items()},
            "grads": {k: p.grad.detach().cpu() for k, p in
                      model.named_parameters() if p.grad is not None},
            "params": {k: v.detach().cpu() for k, v in
                       model.state_dict().items()},
            "lr": opt.lr(payload["step"])}
    if steps_only:
        return out
    records = os.path.join(workdir, f"greedy_{world.rank}_{world.size}.jsonl")
    sets = (["--set", "decode.dp=true"] if world.group is not None else
            ["--set", "decode.dp=false"])
    out["greedy"] = decode.main(["--config", LOC_CONFIG, "--ckpt",
                                 payload["ckpt"], "--method", "greedy",
                                 "--output", records, *sets,
                                 "--device", "cuda"])
    if world.is_main:
        with open(records) as f:
            out["greedy_records"] = {r["utt_id"]: r["hyp"]
                                     for r in map(json.loads, f)}
    model = model_at_state().eval()
    beam = make_beam_decoder(model, config, tok, mesh=world, device=dev)
    texts, scores = beam(payload["dev_audio"], payload["dev_audio_len"])
    out["beam"] = {"texts": texts, "scores": np.asarray(scores),
                   "last_steps": beam.last_steps}
    return out


def dp_worker(workdir: str) -> None:
    """A rank of dp_check: joins the ranks over gloo (NCCL refuses two
    ranks on one device) with CUDA tensors, runs dp_runs, writes
    ``rank<r>.pt``."""
    import torch
    import torch.distributed as dist

    from gluon_e2e_asr_tpu_torch.parallel.mesh import init_data_parallel

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method="env://")
    world = init_data_parallel("cuda")
    dev = torch.device("cuda", world.local_rank)
    payload = torch.load(os.path.join(workdir, "payload.pt"),
                         weights_only=False, map_location="cpu")
    out = dp_runs(torch, payload, world, dev, workdir)
    out["world"] = (world.rank, world.size, dist.get_backend())
    torch.save(out, os.path.join(workdir, f"rank{world.rank}.pt"))
    dist.destroy_process_group()


def dp_check(torch, trainer, dev, card):
    """Phase 7b: data parallelism on the one card. DP_WORLD processes
    (this script with ``--dp-worker``, the environment torchrun gives its
    ranks) join over gloo with CUDA tensors and run dp_runs from the
    trained location-aware flagship; this process runs the same at world
    size 1 meanwhile, and the steps once more (how far two runs of the
    kernels differ by themselves). Each rank's loss, every gradient and the parameters
    after Adam against world size 1 within phase 7's tolerances, on the
    batch and on the batch whose later ranks hold only padding (K1, K2,
    K3 and K4 launched on lengths of 0); the greedy decode CLI's
    hypotheses and the beam's texts identical."""
    import socket

    from gluon_e2e_asr_tpu_torch.parallel.mesh import SINGLE

    workdir = os.path.join(OUT_DIR, "dp")
    shutil.rmtree(workdir, ignore_errors=True)
    os.makedirs(workdir)
    torch.save(dp_payload(torch, trainer), os.path.join(workdir, "payload.pt"))
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    t0 = time.perf_counter()
    procs = []
    try:
        for rank in range(DP_WORLD):
            env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(DP_WORLD),
                       LOCAL_RANK="0", MASTER_ADDR="127.0.0.1",
                       MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), "--dp-worker",
                 workdir], env=env, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        payload = torch.load(os.path.join(workdir, "payload.pt"),
                             weights_only=False, map_location="cpu")
        single = dp_runs(torch, payload, SINGLE, dev, workdir)
        # the same steps again at world size 1: how far two runs of the
        # kernels differ with no rank involved
        again = dp_runs(torch, payload, SINGLE, dev, workdir, steps_only=True)
        logs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.perf_counter() - t0
    for rank, (p, log) in enumerate(zip(procs, logs)):
        with open(os.path.join(workdir, f"rank{rank}.log"), "w") as f:
            f.write(log)
        check(p.returncode == 0, f"dp rank {rank} failed: {log[-3000:]}")
    ranks = [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                        weights_only=False) for r in range(DP_WORLD)]
    line = {"phase": "dp_check", "world": DP_WORLD, "wall_s": round(wall, 2),
            "ranks": [r["world"] for r in ranks],
            "cuda_tensors_over_gloo": True}
    for name in ("batch", "pad_batch"):
        ref = single[name]
        lr = ref["lr"]
        for r in ranks:
            got = r[name]
            loss_rel = abs(got["metrics"]["loss"] - ref["metrics"]["loss"]) / \
                abs(ref["metrics"]["loss"])
            check(set(got["grads"]) == set(ref["grads"]),
                  f"dp {name}: the ranks' gradients cover other parameters")
            rels = {k: rel_err(got["grads"][k], ref["grads"][k])
                    for k in ref["grads"]}
            worst = max(rels, key=rels.get)
            grad_rel = rels[worst]
            rerun = max(rel_err(again[name]["grads"][k], ref["grads"][k])
                        for k in ref["grads"])
            param_lr = max(float((got["params"][k] - ref["params"][k])
                                 .abs().max()) for k in ref["params"]) / lr
            line[name] = {"loss_world1": ref["metrics"]["loss"],
                          "loss_rel_err": loss_rel,
                          "grad_norm_world1": ref["metrics"]["grad_norm"],
                          "grad_norm": got["metrics"]["grad_norm"],
                          "grad_max_rel_err": grad_rel,
                          "grad_max_rel_err_at": worst,
                          "grad_max_rel_err_world1_rerun": rerun,
                          "loss_world1_rerun": again[name]["metrics"]["loss"],
                          "param_max_abs_err_over_lr": param_lr, "lr": lr,
                          "num_real": got["metrics"]["num_real"]}
            check(np.isfinite(got["metrics"]["loss"])
                  and loss_rel <= TOL_STEP_LOSS,
                  f"dp {name}: loss {got['metrics']['loss']} against "
                  f"{ref['metrics']['loss']} at world size 1")
            check(grad_rel <= TOL_STEP_GRAD,
                  f"dp {name}: gradients differ by {grad_rel}")
            check(param_lr <= TOL_STEP_PARAM_LR,
                  f"dp {name}: parameters after Adam differ by {param_lr} x LR")
            check(got["metrics"]["num_real"] == ref["metrics"]["num_real"],
                  f"dp {name}: num_real differs")
    g1 = single["greedy_records"]
    g2 = ranks[0]["greedy_records"]
    same = sum(g2.get(u) == h for u, h in g1.items())
    beam_same = all(r["beam"]["texts"] == single["beam"]["texts"]
                    for r in ranks)
    score_diff = max(float(np.abs(r["beam"]["scores"]
                                  - single["beam"]["scores"]).max())
                     for r in ranks)
    line.update(greedy_utts=len(g1), greedy_identical=same,
                greedy_decode_done=ranks[0]["greedy"],
                beam_utts=len(single["beam"]["texts"]),
                beam_texts_identical=beam_same,
                beam_max_abs_score_diff=score_diff,
                beam_steps=[r["beam"]["last_steps"] for r in ranks],
                beam_steps_world1=single["beam"]["last_steps"],
                tol={"loss_rel": TOL_STEP_LOSS, "grad_rel": TOL_STEP_GRAD,
                     "param_over_lr": TOL_STEP_PARAM_LR}, card=card)
    emit(line)
    check(len(g1) == len(g2) == same > 0,
          f"dp greedy decode: {same} of {len(g1)} hypotheses identical")
    check(beam_same, "dp beam: the texts differ from world size 1")
    check(all(r["beam"]["last_steps"] == single["beam"]["last_steps"]
              for r in ranks), "dp beam: last_steps differ")


def train_reference(torch, trainer, dev):
    """Phase 7: one hybrid step of the trained model through the kernels
    and through the plain versions on the card, from the same state."""
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device

    b = bucket_batch(torch, trainer.config)[0]
    batch = batch_to_device(b, dev)
    params0 = {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}
    runs = {route: hybrid_step(torch, trainer, trainer.config, batch, params0,
                               route) for route in ("kernel", "plain")}
    runs.update({f"{r}_att": runs[r][4] for r in ("kernel", "plain")})
    (lk, nk, gk, pk, _), (lp, np_, gp, pp, _) = runs["kernel"], runs["plain"]
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
          "compute_dtype": trainer.config.model.compute_dtype,
          "grad_rel_err": grad_rel, **out,
          "tol": {"loss_rel": TOL_STEP_LOSS, "grad_rel": TOL_STEP_GRAD,
                  "param_over_lr": TOL_STEP_PARAM_LR}})
    check(loss_rel <= TOL_STEP_LOSS, f"train step loss: {lk} vs {lp}")
    check(max(grad_rel.values()) <= TOL_STEP_GRAD,
          f"train step gradients disagree: {grad_rel}")
    check(param_lr <= TOL_STEP_PARAM_LR,
          f"parameters after Adam disagree by {param_lr} x LR")
    return out


def hybrid_step(torch, trainer, config, batch, params0, route):
    """One hybrid step of ``trainer``'s model from ``params0`` and its
    optimizer state on ``batch`` (on the card) under ``config`` (its
    compute dtype), scheduled sampling off (with it on, a bf16 rounding
    flip can change an argmax and with it the decoder's later inputs; phase
    3 covers it), through the kernels or (``route`` "plain") the plain
    versions: (loss, grad norm, gradients, parameters after the update,
    (attention loss, accuracy))."""
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.training.train_step import (
        TrainState, make_train_step)

    config = copy.deepcopy(config)
    config.loss.scheduled_sampling = 0.0
    tok = trainer.tokenizer
    model = build_model(config, tok.vocab_size, train=True,
                        sos_id=tok.sos_id, eos_id=tok.eos_id)
    model.load_state_dict(params0)
    model.to(batch["audio"].device)
    state = TrainState(step=trainer.state.step,
                       opt_state=copy.deepcopy(trainer.state.opt_state),
                       generator=torch.Generator().manual_seed(SEED))
    step = make_train_step(model, config, trainer.optimizer,
                           trainer.cmvn_stats)
    with plain_route() if route == "plain" else contextlib.nullcontext():
        m = step(state, batch)
    torch.cuda.synchronize()
    return (float(m["loss"]), float(m["grad_norm"]),
            {k: p.grad.detach().clone() for k, p in model.named_parameters()},
            {k: v.detach().clone() for k, v in model.state_dict().items()},
            (float(m["loss_att"]), float(m["att_acc"])))


def step_spread(torch, trainer, dev, card):
    """The trained bf16 model's step on the batch batch_kernel_checks last
    took, in f32: through the kernels against the plain versions at phase
    7's tolerances (train_reference: the kernels' arithmetic without bf16's
    roundings); and the plain step in bf16 against the plain step in f32,
    how far the roundings alone move the loss, gradients and update at
    this shape (no tolerance: the floor the bf16 comparison is read
    against)."""
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device

    f32 = copy.deepcopy(trainer.config)
    f32.model.compute_dtype = "float32"
    _BATCH[f32.fingerprint()] = _BATCH[trainer.config.fingerprint()]
    as_f32 = types.SimpleNamespace(**{k: getattr(trainer, k) for k in (
        "model", "tokenizer", "state", "optimizer", "cmvn_stats")},
        config=f32)
    kernel_f32 = train_reference(torch, as_f32, dev)
    batch = batch_to_device(_BATCH[f32.fingerprint()][0], dev)
    params0 = {k: v.detach().clone()
               for k, v in trainer.model.state_dict().items()}
    (lb, nb, gb, pb, _), (l32, n32, g32, p32, _) = (
        hybrid_step(torch, trainer, c, batch, params0, "plain")
        for c in (trainer.config, f32))
    lr = trainer.optimizer.lr(trainer.state.opt_state["count"])
    spread = {"loss_rel_err": abs(lb - l32) / abs(l32),
              "grad_norm": [nb, n32],
              "grad_max_rel_err": max(rel_err(gb[k], g32[k]) for k in gb),
              "param_max_abs_err_over_lr": max(
                  float((pb[k] - p32[k]).abs().max()) for k in pb) / lr}
    emit({"phase": "step_rounding_spread", "T_frames": int(batch["audio"]
                                                           .shape[1]),
          "plain_bf16_vs_plain_f32": spread,
          "kernel_vs_plain_f32": {k: kernel_f32[k] for k in (
              "loss_rel_err", "grad_max_rel_err",
              "param_max_abs_err_over_lr")}, "card": card})
    return spread


def k1_bwd_timing(torch, trainer, shapes, dev, card):
    """Phase 8: K1-bwd at the flagship's 3 layer shapes in f32 and bf16,
    the whole call, its recurrence alone and the plain versions; returns
    the bf16 sums for the kernels line."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

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
    return out


def train_timing(torch, trainer, dev, card, ctc_traces):
    """Phase 8: CUDA-event timings of the training kernels and steps, and
    a torch.profiler breakdown of the step at bench.py's shape (K1-bwd's
    timings: ``k1_bwd_timing``; K2's and K3's traces: ``ctc_traces``, from
    ``profiler_traces``)."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD

    config = trainer.config
    out = ctc_timing(torch, config, dev, card, ctc_traces)

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


def ctc_timing(torch, config, dev, card, traces):
    """Phase 8 for K2 and K3 at the 4.0 s batch and at bench.py's shape:
    the call (CUDA events, the wrapper's host work included), the
    kernel's device time (torch.profiler, from ``traces``: the
    ``--traces`` process) and the plain version; and a trace of five
    calls of each at the 4.0 s batch (``traces`` too), which must hold its
    warp kernel and no other device operation. Returns {name: (ms, plain
    ms)} at the 4.0 s batch and, under "ctc_detail", each kernel's device
    time and its numbers at bench.py's shape."""
    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    out = {"ctc_detail": {"ctc_alpha": {}, "ctc_beta_post": {}}}
    for shape, batch in (("4.0 s bucket", real_ctc_batch(torch, config, dev)),
                         ("bench.py", bench_ctc_batch(torch, config, dev))):
        emit_, tmask, skip, svalid, label_lens = batch
        alpha = C.ctc_alpha_kernel(emit_, tmask, skip, svalid)
        ll = C._log_likelihood(alpha, label_lens)
        last = 2 * label_lens
        fns = {"ctc_alpha": (
                   lambda: C.ctc_alpha_kernel(emit_, tmask, skip, svalid),
                   lambda: C._alpha_plain(emit_, tmask, skip, svalid)),
               "ctc_beta_post": (
                   lambda: C.ctc_beta_post_kernel(emit_, tmask, skip, svalid,
                                                  last, alpha, ll),
                   lambda: C._beta_post_plain(emit_, tmask, skip, svalid,
                                              last, alpha, ll))}
        T, Bc, S = emit_.shape
        for name, (kernel, plain) in fns.items():
            rec = {"ms": time_ms(torch, kernel),
                   "device_ms": traces[shape][name]["device_ms"],
                   "plain_ms": time_ms(torch, plain)}
            detail = out["ctc_detail"][name]
            line = {"phase": "timing", "what": name, "shape": shape, "T": T,
                    "B": Bc, "S": S, "kernel_ms": rec["ms"],
                    "device_ms": rec["device_ms"], "plain_ms": rec["plain_ms"],
                    "plan_k_W_smem": C.warp_plan(T, S), "card": card}
            if shape == "bench.py":
                detail["bench_shape"] = dict(rec, T=T, B=Bc, S=S)
            else:
                out[name] = (rec["ms"], rec["plain_ms"])
                detail["device_ms"] = rec["device_ms"]
                events = traces[shape][name]["events"]
                line["device_ops_of_5_calls"] = events
                check(len(events) == 1 and f"{name}_warp_kernel" in events[0][0],
                      f"a {name} call ran more than its kernel: {events}")
            emit(line)
    return out


def stepper(torch, trainer, dev, route="kernel", world=None):
    """A train step function on a copy of the trained model and its
    optimizer state: the kernels, or (``route`` "plain") the plain
    versions; with ``world``, the data-parallel step over its ranks."""
    from gluon_e2e_asr_tpu_torch.models.asr import build_model
    from gluon_e2e_asr_tpu_torch.parallel.mesh import SINGLE
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
    fn = make_train_step(model, config, trainer.optimizer, trainer.cmvn_stats,
                         world=world or SINGLE)
    if route == "plain":
        def run(batch):
            with plain_route():
                return fn(state, batch)
        return run
    return lambda batch: fn(state, batch)


def step_timing(torch, trainer, dev, card):
    """The hybrid train step of ``trainer``'s config at the 4.0 s bucket
    (kernels and plain versions) and at bench.py's shape (kernels), and a
    torch.profiler breakdown of the latter. Where ``trainer`` ran
    ``train.dp`` (the flagships as shipped: world size 1 over NCCL), the
    kernels' step is also timed as it ships, at ``trainer.world``.
    Returns ((4 s kernel ms, 4 s plain ms), bench-shape kernel ms)."""
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device
    from gluon_e2e_asr_tpu_torch.utils.flops import bench_mfu

    config = trainer.config
    B = config.data.batch_size
    att = config.model.att_type
    b4 = bucket_batch(torch, trainer.config)[0]
    batch4 = batch_to_device(b4, dev)
    step_k = stepper(torch, trainer, dev)
    step_p = stepper(torch, trainer, dev, "plain")
    k4 = time_ms(torch, lambda: step_k(batch4))
    p4 = time_ms(torch, lambda: step_p(batch4), n=N_TIMED_PLAIN_STEP, warm=1)
    shipped = trainer.world.group is not None

    def dp_ms(batch):
        """The step as shipped, at the trainer's world; None without dp."""
        if not shipped:
            return None
        step = stepper(torch, trainer, dev, world=trainer.world)
        return time_ms(torch, lambda: step(batch))

    dp4 = dp_ms(batch4)
    emit({"phase": "timing", "what": "train_step", "shape": "4.0 s bucket",
          "objective": "hybrid", "att_type": att,
          "mtl_alpha": config.loss.mtl_alpha,
          "B": int(b4.audio.shape[0]), "samples": int(b4.audio.shape[1]),
          "max_labels": int(b4.labels.shape[1]), "kernel_ms": k4,
          "plain_ms": p4, "plain_runs": N_TIMED_PLAIN_STEP,
          "kernel_dp_world1_ms": dp4,
          "utt_per_s": b4.num_real / (k4 / 1e3), "card": card})
    del step_k, step_p

    bench = synth_batch(B, BENCH_SEC, BENCH_LABELS, SEED)
    batch12 = {k: torch.from_numpy(v).to(dev) for k, v in bench.items()}
    step12 = stepper(torch, trainer, dev)
    torch.cuda.reset_peak_memory_stats()
    k12 = time_ms(torch, lambda: step12(batch12))
    peak = torch.cuda.max_memory_allocated() / 2 ** 30
    dp12 = dp_ms(batch12)
    emit({"phase": "timing", "what": "train_step", "shape": "bench.py",
          "objective": "hybrid", "att_type": att,
          "mtl_alpha": config.loss.mtl_alpha,
          "B": B, "seconds": BENCH_SEC, "max_labels": BENCH_LABELS,
          "dtype": config.model.compute_dtype, "kernel_ms": k12,
          "kernel_dp_world1_ms": dp12,
          "utt_per_s": B / (k12 / 1e3), "peak_mem_gib": round(peak, 2),
          "card": card,
          "sm_clock_power_limit_temp": nvidia_smi(
              "clocks.sm,power.draw,power.limit,temperature.gpu")})
    # the model's TFLOP/s and MFU at that step (utils/flops.py: bench.py's
    # count and convention over the H100's dense peak for the dtype)
    mfu = bench_mfu(B / (k12 / 1e3), config, trainer.tokenizer.vocab_size, B,
                    int(bench["audio"].shape[1]), BENCH_LABELS)
    emit({"phase": "mfu", "what": "train_step at bench.py's shape",
          "att_type": att, "dtype": config.model.compute_dtype, "B": B,
          "seconds": BENCH_SEC, "max_labels": BENCH_LABELS, "step_ms": k12,
          **mfu, "card": card})
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
    total = host_ms(torch, lambda: decoder(b.audio, b.audio_len))
    texts, scores = decoder(b.audio, b.audio_len)
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


def frontend_timing(torch, m2_trainer, config, dev, card, traces):
    """Phase 8 for the frontend: at each shape of frontend_cases (cmvn
    utterance, eval), K5 and K6 (CUDA events, the wrapper's host work
    included, and the device time of their kernels by torch.profiler,
    from ``traces``: the ``--traces`` process) against their plain
    versions, which are the ``impl: jnp`` path (cuBLAS f32 products), and
    torch.stft (cuFFT) for the STFT alone; no one PyTorch call computes
    log-mel. At milestone 2's 4.0 s bucket a trace of five calls of each
    (``traces`` too) must hold ``fft_kernel`` and no other device
    operation. Then the milestone 2 train step at its 4.0 s
    bucket, through K5, and the frontend's share of it. Returns (name ->
    (kernel ms, plain ms) at milestone 2's 4.0 s bucket, name -> library
    note, name -> (device ms, route) there)."""
    from gluon_e2e_asr_tpu_torch.frontend import fused as FE
    from gluon_e2e_asr_tpu_torch.frontend.features import (
        draw_spec_augment, frontend_apply, num_frames)
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device

    m2_config = m2_trainer.config
    out, notes, detail = {}, {}, {}
    for case, fc, B, sec in frontend_cases(m2_config, config):
        audio, alen = frontend_audio(torch, B, sec, dev)
        calls = {"frontend_k5": lambda: FE.compute_features_pallas_kernel(
                     fc, audio, alen),
                 "frontend_k6": lambda: FE.compute_features_pallas_regrid_kernel(
                     fc, audio, alen)}
        k5, k6 = (time_ms(torch, c) for c in calls.values())
        dev_ms = traces[case]["device_ms"]
        p5 = time_ms(torch, lambda: FE.compute_features_pallas_plain(fc, audio, alen))
        p6 = time_ms(torch, lambda: FE.compute_features_pallas_regrid_plain(
            fc, audio, alen))
        window = torch.hann_window(fc.win_length, periodic=True, device=dev)
        stft = time_ms(torch, lambda: torch.stft(
            audio, fc.n_fft, fc.hop_length, fc.win_length, window,
            center=False, return_complex=True))
        F = num_frames(audio.shape[1], fc.win_length, fc.hop_length)
        route = FE.route(fc, F)
        line = {"phase": "timing", "what": "frontend", "shape": case, "B": B,
                "samples": int(audio.shape[1]), "F": F, "cmvn": fc.cmvn,
                "route": route, "k5_kernel_ms": k5, "k6_kernel_ms": k6,
                "k5_device_ms": dev_ms["frontend_k5"],
                "k6_device_ms": dev_ms["frontend_k6"], "k5_plain_ms": p5,
                "k6_plain_ms": p6, "plain_is": "the impl: jnp path",
                "torch_stft_ms": stft, "card": card}
        if case == "milestone2 4.0 s":
            out["frontend_k5"], out["frontend_k6"] = (k5, p5), (k6, p6)
            for name in calls:
                ops = traces[case]["ops"][name]
                line[f"{name}_device_ops_of_5_calls"] = ops
                check(len(ops) == 1 and "fft_kernel" in ops[0][0]
                      and ops[0][1] <= 5,
                      f"a {name} call ran more than fft_kernel: {ops}")
                detail[name] = (dev_ms[name], f"{route}_kernel")
                notes[name] = (f"no single PyTorch call computes log-mel; the "
                               f"jnp path (cuBLAS f32) {p5 if name == 'frontend_k5' else p6} ms, "
                               f"torch.stft (cuFFT, the STFT alone) {stft} ms")
        emit(line)

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
    return out, notes, detail


def v1_timing(torch, config, shape, dev, card):
    """Phase 8 for K7 at the flagship's layer-0 shape in each of V1_PAIRS:
    the forward's training form and the backward against their plain
    versions. Returns the bf16 (kernel ms, plain ms) of each, and under
    "bilstm_v1_bf16_f32" those of bf16 streams with f32 compute (the
    backward's with its gate recompute)."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    out = {}
    for sd_name, cd_name in V1_PAIRS:
        args, dy, cd = v1_case(torch, config, shape, dev, cd_name, sd_name)
        sd = args[0].dtype
        y, c, acts = K.bilstm_pallas_kernel(*args, cd, with_cell=True)
        yp, cp = K.bilstm_pallas_plain(*args, cd, with_cell=True)
        f = (time_ms(torch, lambda: K.bilstm_pallas_kernel(*args, cd,
                                                           with_cell=True)),
             time_ms(torch, lambda: K.bilstm_pallas_plain(*args, cd,
                                                          with_cell=True),
                     n=5, warm=1))
        b = (time_ms(torch, lambda: K.bilstm_pallas_bwd_kernel(
                args[2], args[3], args[4], y, c, acts, dy, cd, sd, args[:2])),
             time_ms(torch, lambda: K.bilstm_pallas_bwd_plain(
                *args, yp, cp, dy, cd), n=5, warm=1))
        for d, (k_ms, p_ms) in (("fwd", f), ("bwd", b)):
            emit({"phase": "timing", "what": f"bilstm_v1_{d}",
                  "B": int(y.shape[0]), "T": int(y.shape[1]),
                  "H": int(y.shape[2] // 2), "dtype": sd_name,
                  "compute_dtype": cd_name, "kernel_ms": k_ms,
                  "plain_ms": p_ms, "plain_runs": 5, "card": card})
            if (sd_name, cd_name) == ("bfloat16", "bfloat16"):
                out[f"bilstm_v1_{d}"] = (k_ms, p_ms)
            elif sd_name != cd_name:
                out.setdefault("bilstm_v1_bf16_f32", {})[d] = (k_ms, p_ms)
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


def write_wav(path, audio, sample_rate=16000):
    """16-bit mono PCM of float audio in [-1, 1]."""
    import wave

    pcm = np.clip(audio * 32767.0, -32768, 32767).astype(np.int16)
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def lm_phase(torch, dev, card):
    """Phase 11: the external LM and forced alignment on english_m5.yaml as
    shipped (256 units, loc, hybrid; beam K=10, ctc_weight 0.3,
    length_norm): M5_EPOCHS epochs through the train CLI; the LM corpus
    (``tools/make_lm_corpus.py``) and ``train_lm.py`` at LMConfig's width
    for LM_EPOCHS epochs (dev perplexity falling, below V), a train step
    timed; the LM's step loop and batched log-probabilities on the card;
    MILESTONE_BEAM_UTTS dev utterances decoded by the beam through the
    decode CLI without and with the LM (``decode.lm_ckpt``,
    ``lm_weight`` LM_WEIGHT, ``nbest`` LM_NBEST), both WERs printed; on
    one dev batch the fused beam at weight 0 against the unfused one (bit
    for bit), through the kernels against plain_route(), and both timed;
    ``tools/rescore_nbest.py`` on both decodes' records; ``transcribe.py
    --timestamps`` on wav files (one past the largest bucket) with
    monotone spans inside each file; ``tools/align.py --ctm``;
    ``ctc_viterbi_align`` on the card against the CPU; an alignment batch
    timed. Returns {path: launches} for the kernels line."""
    from gluon_e2e_asr_tpu_torch import train_lm, transcribe
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.decode import make_eval_loader
    from gluon_e2e_asr_tpu_torch.decoding.beam import make_beam_decoder
    from gluon_e2e_asr_tpu_torch.models import lm as LM
    from gluon_e2e_asr_tpu_torch.ops.ctc import ctc_viterbi_align
    from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply
    from gluon_e2e_asr_tpu_torch.tools import align, make_lm_corpus, rescore_nbest

    t_phase = time.perf_counter()
    config = load_config(M5_CONFIG)
    name = "english_m5"
    workdir = os.path.join(OUT_DIR, name)
    counts = {}
    trainer, counts["english_m5_train"] = train_slice(
        torch, M5_CONFIG, name, epoch_steps(config, M5_EPOCHS), shipped=True)
    ckpt = os.path.join(workdir, config.train.ckpt_dir,
                        f"ckpt_{trainer.state.step}.pt")
    tok, V = trainer.tokenizer, trainer.tokenizer.vocab_size

    # the LM: its corpus, then train_lm at LMConfig's width
    corpus = os.path.join(workdir, "lm_corpus.txt")
    made = make_lm_corpus.main(["--config", M5_CONFIG, "--out", corpus])
    lm_dir = os.path.join(workdir, "lm")
    shutil.rmtree(lm_dir, ignore_errors=True)
    t0 = time.perf_counter()
    done = train_lm.main(["--config", M5_CONFIG, "--workdir", lm_dir,
                          "--set", f"lm.extra_text={corpus}",
                          "--set", f"lm.num_epochs={LM_EPOCHS}",
                          "--device", "cuda"])
    lm_wall = time.perf_counter() - t0
    with open(os.path.join(lm_dir, "lm_metrics.jsonl")) as f:
        lm_lines = [json.loads(line) for line in f]
    ppl = [r["dev_ppl"] for r in lm_lines]
    lc = config.lm
    lm_ckpt = done["ckpt"]
    lm, lm_meta = LM.load_lm(lm_ckpt, dev)
    # one train step at full width, on a fresh LM
    texts = train_lm.gather_texts(config)[1] + [
        ln.strip() for ln in open(corpus) if ln.strip()]
    fresh = LM.build_lm(config, V)
    fresh.reset_parameters(torch.Generator().manual_seed(lc.seed))
    fresh.to(dev).train()
    opt, step, _ = train_lm.make_lm_step(fresh, lc)
    state = opt.init(dict(fresh.named_parameters()))
    batch = tuple(torch.from_numpy(a).to(dev) for a in next(train_lm.make_batches(
        texts, tok, lc.max_len, lc.batch_size, np.random.default_rng(lc.seed))))
    step_ms = time_ms(torch, lambda: step(state, *batch))
    tokens = int(batch[2].sum())
    emit({"phase": "lm_train", "config": os.path.relpath(M5_CONFIG, REPO),
          "corpus": made, "texts": len(texts), "V": V,
          "E": lc.embed_dim, "H": lc.hidden, "layers": lc.layers,
          "B": lc.batch_size, "max_len": lc.max_len,
          "epochs": LM_EPOCHS, "epochs_shipped": lc.num_epochs,
          "epoch_lines": lm_lines, "wall_s": round(lm_wall, 2),
          "lm_done": done, "train_step_ms": step_ms,
          "train_step_tokens": tokens,
          "tokens_per_s": tokens / (step_ms / 1e3),
          "step_basis": "CUDA events, median of 10: forward, backward, "
                        "clip and AdamW of one batch", "card": card})
    check(len(ppl) == LM_EPOCHS and ppl[-1] < ppl[0] and ppl[-1] < V,
          f"the LM's dev perplexity did not fall below V={V}: {ppl}")
    check(lm_meta["vocab"] == tok.to_json(), "the LM's vocab is not the ASR's")
    del fresh, opt, state

    # the LM on the card: the step loop against the forward, the batched
    # log-probabilities against the per-row ones
    dev_texts = [u.text for u in trainer.dev_utts]
    tin, _, lens = (torch.from_numpy(a).to(dev) for a in next(
        train_lm.make_batches(dev_texts, tok, lc.max_len, 16, None)))
    with torch.no_grad():
        full = lm(tin, lens)
        st = lm.init_state(tin.shape[0])
        step_err = 0.0
        for i in range(int(lens.max())):
            st, logits = lm.step(st, tin[:, i])
            live = i < lens
            step_err = max(step_err, float(
                (logits[live] - full[live, i]).abs().max()))
    rows = [tok.encode(t) for t in dev_texts[:16]]
    batch_lp = LM.lm_logprob_batch(lm, rows, tok.eos_id, tok.sos_id)
    row_lp = np.array([LM.lm_logprob(lm, r, tok.eos_id, tok.sos_id)
                       for r in rows])
    lp_err = float(np.abs(batch_lp - row_lp).max())
    emit({"phase": "lm_check", "step_vs_forward_max_abs_err": step_err,
          "logprob_batch_vs_row_max_abs_err": lp_err, "tol": TOL_LM,
          "rows": len(rows)})
    check(step_err <= TOL_LM and lp_err <= TOL_LM,
          f"the LM on the card: step {step_err}, log-probs {lp_err}")

    # the beam over MILESTONE_BEAM_UTTS dev utterances, without and with
    # the LM, through the decode CLI
    nb = ["--set", f"decode.nbest={LM_NBEST}"]
    fused_set = nb + ["--set", f"decode.lm_weight={LM_WEIGHT}",
                      "--set", f"decode.lm_ckpt={lm_ckpt}"]
    counts["unfused_beam"], plain_res = decode_slice(
        torch, trainer, M5_CONFIG, name, MILESTONE_BEAM_UTTS, extra=nb,
        tag="_nolm")
    counts["fused_beam"], fused_res = decode_slice(
        torch, trainer, M5_CONFIG, name, MILESTONE_BEAM_UTTS, extra=fused_set,
        tag="_lm")
    # one dev batch: weight 0 against no LM, the kernels against the
    # plain versions, both timed
    b = next(iter(make_eval_loader(config, trainer.dev_utts, tok).epoch(0)))
    model = trainer.model.eval()
    c0 = copy.deepcopy(config)
    c0.decode.nbest = LM_NBEST
    unfused = make_beam_decoder(model, c0, tok, trainer.cmvn_stats, device=dev)
    c0.decode.lm_weight = 0.0
    weight0 = make_beam_decoder(model, c0, tok, trainer.cmvn_stats, device=dev,
                                lm_bundle=lm)
    c1 = copy.deepcopy(c0)
    c1.decode.lm_weight = LM_WEIGHT
    fused = make_beam_decoder(model, c1, tok, trainer.cmvn_stats, device=dev,
                              lm_bundle=lm)
    base = unfused.nbest(b.audio, b.audio_len)
    same0 = weight0.nbest(b.audio, b.audio_len) == base
    got = fused.nbest(b.audio, b.audio_len)
    with plain_route():
        ref = fused.nbest(b.audio, b.audio_len)
    texts_equal = [[t for t, _ in r] for r in got] == [[t for t, _ in r]
                                                      for r in ref]
    dscore = max(abs(s - rs) for r, rr in zip(got, ref)
                 for (_, s), (_, rs) in zip(r, rr) if rs > -1e29)
    unfused_ms = host_ms(torch, lambda: unfused(b.audio, b.audio_len))
    fused_ms = host_ms(torch, lambda: fused(b.audio, b.audio_len))
    emit({"phase": "lm_fusion", "utts": MILESTONE_BEAM_UTTS,
          "lm_weight": LM_WEIGHT, "nbest": LM_NBEST,
          "wer_without_lm": plain_res["wer"], "wer_with_lm": fused_res["wer"],
          "cer_without_lm": plain_res["cer"], "cer_with_lm": fused_res["cer"],
          "oracle_wer_without_lm": plain_res.get("oracle_wer"),
          "oracle_wer_with_lm": fused_res.get("oracle_wer"),
          "note": "WERs of a model trained 2 of 60 epochs: not a check",
          "batch": int(b.audio.shape[0]), "samples": int(b.audio.shape[1]),
          "weight0_bit_identical": same0,
          "kernels_vs_plain_texts_equal": texts_equal,
          "kernels_vs_plain_max_abs_score_diff": dscore,
          "tol_score": TOL_FUSED_SCORE,
          "unfused_beam_ms": unfused_ms, "fused_beam_ms": fused_ms,
          "fused_over_unfused": fused_ms / unfused_ms,
          "timing_basis": "host clock, median of 3 after a warm run, host "
                          "audio in, hypotheses on the host",
          "card": card})
    check(same0, "the beam at lm_weight 0 is not the unfused beam bit for bit")
    check(texts_equal and dscore <= TOL_FUSED_SCORE,
          f"the fused beam through the kernels against plain_route(): texts "
          f"equal {texts_equal}, scores {dscore}")

    # n-best rescoring of both decodes' records
    for tag in ("_nolm", "_lm"):
        records = os.path.join(workdir, f"decode_beam{tag}.jsonl")
        summary = rescore_nbest.main([
            records, "--lm", lm_ckpt, "--weight", str(LM_WEIGHT),
            "--lm-length-norm", "--device", "cuda",
            "--output", os.path.join(workdir, f"rescored{tag}.jsonl")])
        emit({"phase": "rescore", "records": os.path.relpath(records, REPO),
              "summary": summary})
        check(summary["num_utts"] == MILESTONE_BEAM_UTTS,
              f"rescored {summary['num_utts']} utterances")

    # transcribe --timestamps: wav files of synth_batch audio, one past the
    # largest bucket (the catch-all bucket)
    wav_dir = os.path.join(workdir, "wavs")
    os.makedirs(wav_dir, exist_ok=True)
    sb = synth_batch(N_WAVS, 3.0, 8, SEED)
    clips = [sb["audio"][i, :sb["audio_len"][i]] for i in range(N_WAVS)]
    clips.append(synth_batch(1, LONG_WAV_SEC, 8, SEED + 1)["audio"][0])
    wavs = []
    for i, clip in enumerate(clips):
        wavs.append(os.path.join(wav_dir, f"clip{i}.wav"))
        write_wav(wavs[-1], clip)
    out = os.path.join(workdir, "transcribe.jsonl")
    reset_counts()
    results = transcribe.main(["--config", M5_CONFIG, "--ckpt", ckpt,
                               "--output", out, "--timestamps",
                               "--device", "cuda", *wavs])
    counts["transcribe"], plain = read_counts()
    spf = transcribe.sec_per_frame(config)
    with open(out) as f:
        recs = [json.loads(line) for line in f]
    bad = []
    for r in recs:
        dur = len(clips[int(r["utt_id"][:4])]) / 16000
        last = 0.0
        for sp in r["tokens"]:
            if sp["start_s"] is None:
                continue
            # within one encoder frame past the end: the subsampling rounds
            # the last frames up
            if not last - 1e-9 <= sp["start_s"] < sp["end_s"] <= dur + spf:
                bad.append((r["utt_id"], sp))
            last = sp["end_s"]
    emit({"phase": "transcribe", "files": len(wavs),
          "seconds": [len(c) / 16000 for c in clips],
          "records": len(recs), "spans": sum(len(r["tokens"]) for r in recs),
          "sec_per_frame": spf, "bad_spans": bad[:5],
          "launches": counts["transcribe"], "plain_calls": plain})
    check(len(results) == len(recs) == len(wavs) and not bad,
          f"transcribe: {len(recs)} records of {len(wavs)} files, bad spans "
          f"{bad[:3]}")
    check(counts["transcribe"]["bilstm_fwd"] > 0 and not any(plain.values()),
          f"transcribe's launches {counts['transcribe']}, plain {plain}")

    # tools/align.py --ctm over MILESTONE_BEAM_UTTS dev utterances
    reset_counts()
    rc = align.main(["--config", M5_CONFIG, "--ckpt", ckpt,
                     "--num", str(MILESTONE_BEAM_UTTS),
                     "--output", os.path.join(workdir, "align.jsonl"),
                     "--ctm", os.path.join(workdir, "align.ctm"),
                     "--device", "cuda"])
    counts["align"], plain = read_counts()
    with open(os.path.join(workdir, "align.jsonl")) as f:
        arecs = [json.loads(line) for line in f]
    with open(os.path.join(workdir, "align.ctm")) as f:
        ctm = f.read().splitlines()
    emit({"phase": "align", "records": len(arecs), "ctm_lines": len(ctm),
          "feasible": sum(r["score"] > -1e20 for r in arecs),
          "launches": counts["align"], "plain_calls": plain})
    check(rc == 0 and len(arecs) == MILESTONE_BEAM_UTTS and ctm,
          f"align: {len(arecs)} records, {len(ctm)} CTM lines")
    check(counts["align"]["bilstm_fwd"] > 0 and not any(plain.values()),
          f"align's launches {counts['align']}, plain {plain}")

    # Viterbi on the card against the CPU on the same log-probabilities,
    # and an alignment batch timed
    with torch.inference_mode():
        feats, flen = frontend_apply(config.frontend,
                                     torch.from_numpy(b.audio).to(dev),
                                     torch.from_numpy(b.audio_len).to(dev))
        _, enc_len, logits = model.encode(feats, flen)
        logp = torch.log_softmax(logits.float(), dim=-1)
    args = (logp, enc_len, torch.from_numpy(b.labels).to(dev),
            torch.from_numpy(b.label_len).to(dev))
    states, score = ctc_viterbi_align(*args)
    cpu_states, cpu_score = ctc_viterbi_align(*(a.cpu() for a in args))
    same_states = torch.equal(states.cpu(), cpu_states)
    score_err = float((score.cpu() - cpu_score).abs().max())
    align_fn = transcribe.make_align_fn(model, config, trainer.cmvn_stats, dev)
    align_ms = host_ms(torch, lambda: align_fn(b.audio, b.audio_len, b.labels,
                                               b.label_len))
    viterbi_ms = host_ms(torch, lambda: ctc_viterbi_align(*args))
    emit({"phase": "viterbi", "B": int(logp.shape[0]), "T": int(logp.shape[1]),
          "S": 2 * int(b.labels.shape[1]) + 1,
          "states_identical": same_states, "score_max_abs_err": score_err,
          "tol_score": TOL_VITERBI_SCORE, "align_batch_ms": align_ms,
          "viterbi_ms": viterbi_ms,
          "timing_basis": "host clock, median of 3 after a warm run; the "
                          "batch: frontend, encoder, log-softmax and Viterbi, "
                          "host arrays in, states on the host",
          "card": card})
    check(same_states and score_err <= TOL_VITERBI_SCORE,
          f"Viterbi on the card against the CPU: states identical "
          f"{same_states}, scores {score_err}")
    emit({"phase": "lm_phase_done",
          "seconds": round(time.perf_counter() - t_phase, 1)})
    del trainer, model, lm, unfused, weight0, fused
    return counts


@contextlib.contextmanager
def native_batch_counts():
    """Count the batches the loader's fused native route builds: the
    port's ``utils/native.py`` batch loaders (float32 and int16) wrapped
    for the block, as ``DataLoader`` looks them up when it is built.
    Yields {"batches": successful calls, "failed": calls that raised}."""
    from gluon_e2e_asr_tpu_torch.utils import native

    n = {"batches": 0, "failed": 0}
    saved = {k: getattr(native, k) for k in ("load_pack_audio_batch",
                                             "load_pack_audio_batch_i16")}

    def counted(fn):
        def call(*a, **k):
            try:
                out = fn(*a, **k)
            except Exception:
                n["failed"] += 1
                raise
            n["batches"] += 1
            return out
        return call

    for k, fn in saved.items():
        setattr(native, k, counted(fn))
    try:
        yield n
    finally:
        for k, fn in saved.items():
            setattr(native, k, fn)


def ls100_render(torch, corpus, card, train=LS100_TRAIN, dev=LS100_DEV):
    """The corpus of phases 12 and 16: ``tools/make_synth_corpus.py`` with
    ls100_full.yaml's flags (``train`` + ``dev`` utterances: phase 12 cuts
    them to LS100_TRAIN + LS100_DEV), on every core of the host; three
    files decoded to exactly the PCM the encoder was given; the train
    manifest walked."""
    from gluon_e2e_asr_tpu_torch.data.manifest import build_librispeech_manifest
    from gluon_e2e_asr_tpu_torch.tools import make_synth_corpus as MS
    from gluon_e2e_asr_tpu_torch.utils.native import decode_flac

    flags = [f for k, v in LS100_RENDER.items()
             for f in (f"--{k.replace('_', '-')}", str(v))]
    shutil.rmtree(corpus, ignore_errors=True)
    t0 = time.perf_counter()
    made = MS.main(["--out", corpus, "--num-train", str(train),
                    "--num-dev", str(dev), *flags])
    render_s = time.perf_counter() - t0
    r = LS100_RENDER
    utts = MS._ls_duration_utts("train-clean-100", train, r["seed"],
                                r["text_mode"], r["noise"], r["jitter"],
                                pool_split=r["pool_split"])
    exact = {}
    for i in (0, 1, train - 1):
        _, utt_id, path = MS.utt_location(corpus, "train-clean-100", i, 100,
                                          "flac")
        got = np.round(decode_flac(path).astype(np.float64) * 32768.0)
        pcm = MS.utt_pcm(utts[i])
        exact[utt_id] = bool(len(got) == len(pcm)
                             and np.array_equal(got.astype(np.int64), pcm))
    t0 = time.perf_counter()
    walked = build_librispeech_manifest(corpus, "train-clean-100")
    walk_s = time.perf_counter() - t0
    emit({"phase": "ls100_render", "config": os.path.relpath(LS100_CONFIG, REPO),
          "flags": flags, "train": train, "dev": dev,
          "cut_from": (None if (train, dev) == LS100_FULL
                       else "28,500 train + 2,700 dev"),
          "hours": made["hours"], "seconds": render_s,
          "workers": os.cpu_count(), "decoded_exactly": exact,
          "manifest_walk_s": walk_s, "manifest_utts": len(walked),
          "card": card})
    check(all(exact.values()), f"FLAC files decode to other PCM: {exact}")
    check(len(walked) == train and all(
        u.audio_path.endswith(".flac") for u in walked),
        f"the manifest walk found {len(walked)} of {train} .flac files")


def ls100_cmvn(torch, sets, workdir, card, dtypes=("int16", "float32")):
    """Global CMVN of the train split through ``tools/compute_cmvn.py`` on
    the card, at ls100_full.yaml's transfer_dtype int16 and (phase 12) at
    float32: the two within TOL_CMVN, finite, std > 0, every batch through
    the native route. Returns the int16 stats' path."""
    from gluon_e2e_asr_tpu_torch.tools import compute_cmvn

    os.makedirs(workdir, exist_ok=True)
    paths, stats, secs, batches = {}, {}, {}, {}
    for td in dtypes:
        paths[td] = os.path.join(workdir, f"cmvn_{td}.npz")
        with native_batch_counts() as n:
            t0 = time.perf_counter()
            stats[td] = compute_cmvn.main([
                "--config", LS100_CONFIG, "--output", paths[td], *sets,
                "--set", f"data.transfer_dtype={td}", "--device", "cuda"])
            secs[td] = time.perf_counter() - t0
        batches[td] = dict(n)
    diff = (max(float(np.abs(stats["int16"][k] - stats["float32"][k]).max())
                for k in ("mean", "std")) if "float32" in stats else None)
    ok = all(np.isfinite(st[k]).all() for st in stats.values()
             for k in ("mean", "std")) and all(
        (st["std"] > 0).all() for st in stats.values())
    emit({"phase": "ls100_cmvn", "frames": stats["int16"]["frames"],
          "seconds": secs, "native_batches": batches,
          "int16_vs_float32_max_abs_diff": diff, "tol": TOL_CMVN,
          "mean_range": [float(stats["int16"]["mean"].min()),
                         float(stats["int16"]["mean"].max())],
          "std_range": [float(stats["int16"]["std"].min()),
                        float(stats["int16"]["std"].max())],
          "finite_and_positive_std": ok,
          "basis": "host clock: the native loader's decode and pack, the "
                   "plain log-mel on the card, the moments", "card": card})
    check(ok and (diff is None or diff <= TOL_CMVN),
          f"CMVN stats: int16 against float32 {diff}, finite/std>0 {ok}")
    check(all(b["batches"] > 0 and not b["failed"] for b in batches.values()),
          f"compute_cmvn's batches missed the native route: {batches}")
    return paths["int16"]


def ls100_kernels(torch, config, stats_path, dev, card):
    """K1-fwd and K1-bwd at layer 0 (T = 1836), K2/K3 (T' = 459, S = 641)
    and K4-fwd/K4-bwd loc in bf16 (coins off and on) against their plain
    versions on the first training batch of the largest bucket (18.38 s,
    from the native loader), the routes fwd_route/bwd_route predict for
    every ls100 bucket, then each timed (CUDA events) with its bound.
    Returns {kernel row: numbers at this shape} for the kernels line."""
    from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.ops import ctc as C
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD

    mc, fc = config.model, config.frontend
    b, tok, _, Tp = bucket_batch(torch, config)
    last = len(config.data.bucket_bounds_sec) - 1
    check(b.bucket == last and b.audio.dtype == np.int16,
          f"the ls100 batch: bucket {b.bucket}, {b.audio.dtype}")
    blob = np.load(stats_path)
    cmvn = tuple(torch.from_numpy(blob[k]).to(dev) for k in ("mean", "std"))
    with torch.no_grad():
        feats, flen = frontend_apply(fc, torch.from_numpy(b.audio).to(dev),
                                     torch.from_numpy(b.audio_len).to(dev),
                                     cmvn_stats=cmvn)
    B, T0, D0 = feats.shape
    H = mc.enc_hidden
    w = layer_inputs(torch, B, T0, D0, H, 0, dev)[2:]
    args = (feats.contiguous(), flen.int(), *w)
    dy = layer_cotangent(torch, B, T0, H, 0, dev)
    name = f"ls100 {config.data.bucket_bounds_sec[-1]} s"
    k1f_err, rec = check_k1_case(torch, name, 0, args, dy, "bfloat16",
                                 recurrence=True)
    lattice = real_ctc_batch(torch, config, dev)
    a_err, p_err = check_ctc_case(torch, name, lattice)
    # every ls100 bucket's K4 route, by shape alone
    routes = {}
    for sec in config.data.bucket_bounds_sec:
        T = num_frames_of(config, sec)
        dims = (T, 2 * H, mc.att_dim, mc.dec_embed, mc.dec_hidden,
                tok.vocab_size, mc.loc_conv_channels, mc.loc_conv_width)
        routes[T] = (LD.fwd_route("loc", torch.bfloat16, *dims),
                     LD.bwd_route("loc", torch.bfloat16, *dims))
    emit({"phase": "ls100_routes", "k4_loc_bf16_by_T": routes,
          "ctc_plan_k_W_smem": C.warp_plan(Tp, lattice[0].shape[2])})
    check(all(r == ("cluster", "cluster") for r in routes.values()),
          f"K4 loc routes at ls100's buckets: {routes}")
    dec_errs = check_decoder_kernels(
        torch, config, dev, "loc",
        cases=[("bfloat16", 0.0, False),
               ("bfloat16", config.loss.scheduled_sampling, False)])

    # timing at this shape, beside the bounds
    bf = torch.bfloat16
    x, lens, w_x, b_x, w_hf, w_hb = args
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=bf, with_cell=True)
    ms = {"bilstm_fwd": (
        time_ms(torch, lambda: K.bilstm_fused_kernel(*args, compute_dtype=bf)),
        time_ms(torch, lambda: K.bilstm_fused_plain(*args, compute_dtype=bf),
                n=LS100_PLAIN_RUNS, warm=0))}
    ms["bilstm_bwd"] = (
        time_ms(torch, lambda: K.bilstm_fused_bwd_kernel(
            x, lens, w_x, w_hf, w_hb, y, c, acts, dy, compute_dtype=bf)),
        time_ms(torch, lambda: K.bilstm_fused_bwd_plain(
            x, lens, w_x, b_x, w_hf, w_hb, y, c, dy, compute_dtype=bf),
            n=LS100_PLAIN_RUNS, warm=0))
    del y, c, acts
    emit_, tmask, skip, svalid, label_lens = lattice
    alpha = C.ctc_alpha_kernel(emit_, tmask, skip, svalid)
    ll = C._log_likelihood(alpha, label_lens)
    ms["ctc_alpha"] = (
        time_ms(torch, lambda: C.ctc_alpha_kernel(emit_, tmask, skip, svalid)),
        time_ms(torch, lambda: C._alpha_plain(emit_, tmask, skip, svalid),
                n=LS100_PLAIN_RUNS, warm=0))
    ms["ctc_beta_post"] = (
        time_ms(torch, lambda: C.ctc_beta_post_kernel(
            emit_, tmask, skip, svalid, 2 * label_lens, alpha, ll)),
        time_ms(torch, lambda: C._beta_post_plain(
            emit_, tmask, skip, svalid, 2 * label_lens, alpha, ll),
            n=LS100_PLAIN_RUNS, warm=0))
    dargs, filt, _ = decoder_case(torch, config, dev, 0.0)
    tokens, _, enc, enc_proj, enc_len, dw = dargs
    band = LD.build_loc_band_cmajor(filt, enc.shape[1])
    _, resid, extras = LD.las_decoder_fwd_kernel(*dargs, bf, "loc", filt)
    dl = torch.from_numpy(np.random.RandomState(SEED + 7).randn(
        *tokens.shape, dw.embed.shape[0]).astype(np.float32) * 0.05).to(dev)
    bwd = (enc, enc_proj, enc_len, dw, bf, "loc")
    ms["las_decoder_fwd_loc"] = (
        time_ms(torch, lambda: LD.las_decoder_fwd_kernel(*dargs, bf, "loc",
                                                         filt)),
        time_ms(torch, lambda: LD.las_decoder_fwd_plain(*dargs, bf, "loc",
                                                        band),
                n=LS100_PLAIN_RUNS, warm=0))
    ms["las_decoder_bwd_loc"] = (
        time_ms(torch, lambda: LD.las_decoder_bwd_kernel(
            dl, resid, extras, *bwd, filt)),
        time_ms(torch, lambda: LD.las_decoder_bwd_plain(dl, resid, *bwd, band),
                n=LS100_PLAIN_RUNS, warm=0))
    del resid, extras
    bounds = k1_layer_bounds(torch, B, T0, D0, H, 0, lens=flen.cpu())
    bounds["ctc_alpha"], bounds["ctc_beta_post"] = ctc_bounds(
        real_ctc_batch(torch, config, "cpu"))
    bounds["las_decoder_fwd_loc"], bounds["las_decoder_bwd_loc"] = k4_bounds(
        torch, config, "loc")
    errs = {"bilstm_fwd": k1f_err,
            "bilstm_bwd": max(rec[o]["max_abs_err"] for o in
                              ("dx", "dw_x", "db", "dw_hf", "dw_hb")),
            "ctc_alpha": a_err, "ctc_beta_post": p_err,
            "las_decoder_fwd_loc": dec_errs["las_decoder_fwd"],
            "las_decoder_bwd_loc": dec_errs["las_decoder_bwd"]}
    at = {"bilstm_fwd": f"layer 0, B={B}, T={T0}, D={D0}, H={H}, bf16, the "
                        "batch's CMVN'd features (serving form)",
          "bilstm_bwd": f"layer 0, B={B}, T={T0}, D={D0}, H={H}, bf16",
          "ctc_alpha": f"B={B}, T'={Tp}, S={emit_.shape[2]}, V={tok.vocab_size}"
                       ", the batch's BPE labels, seeded logits",
          "ctc_beta_post": f"B={B}, T'={Tp}, S={emit_.shape[2]}",
          "las_decoder_fwd_loc": f"B={B}, L={tokens.shape[1]}, T'={Tp}, bf16, "
                                 "coins off",
          "las_decoder_bwd_loc": f"B={B}, L={tokens.shape[1]}, T'={Tp}, bf16"}
    out = {}
    for k, (k_ms, p_ms) in ms.items():
        out[k] = {"ms": k_ms, "plain_ms": p_ms, "plain_runs": LS100_PLAIN_RUNS,
                  "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                  "max_abs_err": errs[k], "at": at[k]}
    emit({"phase": "timing", "what": "ls100 largest bucket", "kernels": out,
          "card": card})
    return out


def num_frames_of(config, seconds: float) -> int:
    """Encoder frames of a bucket of ``seconds`` (the pyramid's
    subsampling)."""
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames

    fc = config.frontend
    T = num_frames(int(round(seconds * fc.sample_rate)), fc.win_length,
                   fc.hop_length)
    for f in config.model.enc_subsample:
        T = -(-T // int(f))
    return T


def ls100_loader(torch, config, card):
    """The largest bucket's first batch of a training epoch through the
    fused native route and the Python route (``use_native=False``), int16
    and float32, with and without speed perturbation: bit-equal. Then an
    epoch of the training loader (int16, perturbed) on the host, both
    routes: utterances and hours of audio a second."""
    from gluon_e2e_asr_tpu_torch.data.loader import DataLoader
    from gluon_e2e_asr_tpu_torch.data.sampler import BucketSampler, make_bucket_specs
    from gluon_e2e_asr_tpu_torch.training.trainer import (
        build_datasets, build_tokenizer)

    dc, tc = config.data, config.train
    utts = build_datasets(config)[0]
    tok = build_tokenizer(config, (u.text for u in utts))
    sp = tuple(dc.speed_perturb)
    specs = make_bucket_specs(dc.bucket_bounds_sec, dc.sample_rate,
                              dc.batch_size, dc.max_label_len,
                              config.frontend.hop_length, dc.dynamic_batch)

    def loader(td, native):
        sampler = BucketSampler(utts, specs, dc.sample_rate, seed=tc.seed,
                                shuffle=dc.shuffle, drop_last=dc.drop_last,
                                sortagrad_epochs=dc.sortagrad_epochs,
                                speed_perturb=sp, perturb_seed=tc.seed)
        return DataLoader(utts, sampler, tok, dc.sample_rate,
                          speed_perturb=sp, perturb_seed=tc.seed,
                          transfer_dtype=td, use_native=native)

    last = len(specs) - 1
    bucket, idxs = next(x for x in loader("int16", True).sampler
                        .epoch_batches(1) if x[0] == last)
    equal = {}
    with native_batch_counts() as n:
        for td in ("int16", "float32"):
            for epoch in (None, 1):
                a = loader(td, True).make_batch(bucket, idxs, epoch=epoch)
                p = loader(td, False).make_batch(bucket, idxs, epoch=epoch)
                equal[f"{td}, {'perturbed' if epoch else 'plain'}"] = all(
                    np.array_equal(getattr(a, k), getattr(p, k))
                    and getattr(a, k).dtype == getattr(p, k).dtype
                    for k in ("audio", "audio_len", "labels", "label_len"))
    fused = dict(n)
    rates = {}
    for route, native in (("native", True), ("python", False)):
        ld = loader("int16", native)
        t0 = time.perf_counter()
        nb = n_utt = samples = 0
        for b in ld.epoch(1):
            nb += 1
            n_utt += b.num_real
            samples += int(b.audio_len.sum())
        dt = time.perf_counter() - t0
        rates[route] = {"batches": nb, "utts": n_utt, "seconds": dt,
                        "utt_per_s": n_utt / dt,
                        "audio_hours_per_s": samples / dc.sample_rate / 3600 / dt}
    emit({"phase": "ls100_loader", "batch": {"bucket": bucket, "B": len(idxs)},
          "native_vs_python_bit_equal": equal, "native_calls": fused,
          "epoch_throughput": rates,
          "basis": "host clock, one training epoch (int16, speed "
                   "perturbation, shuffled), files in the page cache "
                   "(warm: just written)", "card": card})
    check(all(equal.values()), f"the native and Python routes differ: {equal}")
    check(fused == {"batches": 4, "failed": 0},
          f"the fused route built {fused} of 4 batches")


def ls100_phase(torch, dev, card):
    """Phase 12: configs/ls100_full.yaml, the LibriSpeech-100h recipe, from
    a FLAC corpus on disk: the render (ls100_render), global CMVN
    (ls100_cmvn), K1, K2/K3 and K4 loc at the largest bucket's shapes
    (ls100_kernels), the loader's two routes (ls100_loader); LS100_EPOCHS
    of training through the train CLI as shipped but for the corpus, the
    stats file and the epoch count (every batch through the native route,
    the launch counts, the per-token loss falling, data_skipped, each
    bucket's step timed, the epoch-end beam timed); then the tools:
    average_ckpts over the two epoch checkpoints (each parameter their
    mean), the decode CLI's beam on the average and the last, tune_decode's
    2x2 grid, plot_attention --no-png (shapes [n_tokens+1, T'], rows
    summing to 1) and transcribe on two .flac files of the corpus (the
    decode CLI's texts). Returns {path: launches} for the kernels line and
    the kernels' numbers at the largest bucket."""
    from gluon_e2e_asr_tpu_torch import decode, transcribe
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
    from gluon_e2e_asr_tpu_torch.data.manifest import build_librispeech_manifest
    from gluon_e2e_asr_tpu_torch.tools import average_ckpts, plot_attention, tune_decode
    from gluon_e2e_asr_tpu_torch.training import trainer as TR
    from gluon_e2e_asr_tpu_torch.training.checkpoint import restore_params
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device
    from gluon_e2e_asr_tpu_torch.utils import native

    t_phase = time.perf_counter()
    name = "ls100"
    workdir = os.path.join(OUT_DIR, name)
    corpus = os.path.join(OUT_DIR, "ls100_corpus")
    ls100_render(torch, corpus, card)
    sets = ["--set", f"data.data_dir={corpus}"]
    os.makedirs(OUT_DIR, exist_ok=True)
    stats = ls100_cmvn(torch, sets, OUT_DIR, card)
    sets += ["--set", f"frontend.cmvn_stats_path={stats}"]
    config = load_config(LS100_CONFIG)
    apply_overrides(config, sets[1::2])
    at_shape = ls100_kernels(torch, config, stats, dev, card)
    ls100_loader(torch, config, card)

    # training: two epochs through the train CLI, every batch counted
    counts = {}
    evals = []
    evaluate = TR.Trainer.evaluate

    def timed_evaluate(self):
        t0 = time.perf_counter()
        out = evaluate(self)
        torch.cuda.synchronize()
        evals.append(time.perf_counter() - t0)
        return out

    losses = []
    TR.Trainer.evaluate = timed_evaluate
    try:
        with native_batch_counts() as n:
            trainer, counts["ls100_train"] = train_slice(
                torch, LS100_CONFIG, name, epoch_steps(config, LS100_EPOCHS),
                extra=[*sets, "--set", f"train.num_epochs={LS100_EPOCHS}"],
                shipped=True, falls=False, losses_out=losses)
        fused = dict(n)
    finally:
        TR.Trainer.evaluate = evaluate
    tok = trainer.tokenizer
    steps = trainer.state.step
    dev_batches = len(list(trainer.dev_loader.sampler.epoch_batches(0)))
    # the loss per label token, epoch by epoch (the same utterances; each
    # step's loss is its batch's mean of per-utterance sums)
    per_token, i = [], 0
    for e in range(LS100_EPOCHS):
        loss_sum = tokens = 0.0
        for bucket, idxs in trainer.sampler.epoch_batches(e):
            ml = trainer.sampler.specs[bucket].max_labels
            tokens += sum(len(tok.encode(trainer.train_utts[j].text)[:ml])
                          for j in idxs)
            loss_sum += losses[i] * len(idxs)
            i += 1
        per_token.append(loss_sum / tokens)
    # a step at each bucket (epoch 1's first batch of it), CUDA events
    step = stepper(torch, trainer, dev)
    bucket_ms = {}
    for bucket, idxs in trainer.sampler.epoch_batches(1):
        if bucket in bucket_ms:
            continue
        b = trainer.loader.make_batch(bucket, idxs, epoch=1)
        batch = batch_to_device(b, dev)
        k = time_ms(torch, lambda: step(batch), n=5, warm=1)
        bucket_ms[bucket] = {"seconds": config.data.bucket_bounds_sec[bucket],
                             "B": int(b.audio.shape[0]), "real": b.num_real,
                             "samples": int(b.audio.shape[1]),
                             "max_labels": int(b.labels.shape[1]),
                             "step_ms": k, "utt_per_s": b.num_real / k * 1e3}
    del step
    skipped = {"train": len(trainer.sampler.skipped),
               "dev": len(trainer.dev_loader.sampler.skipped)}
    expect_batches = steps + dev_batches * LS100_EPOCHS
    emit({"phase": "ls100_train", "steps": steps, "epochs": LS100_EPOCHS,
          "epochs_shipped": 5, "dev_batches_per_eval": dev_batches,
          "native_batches": fused, "expected_native_batches": expect_batches,
          "loss_per_token_by_epoch": per_token, "data_skipped": skipped,
          "step_ms_by_bucket": bucket_ms, "epoch_end_beam_s": evals,
          "beam": {"beam_size": config.decode.beam_size,
                   "ctc_weight": config.decode.ctc_weight,
                   "ctc_score_candidates": config.decode.ctc_score_candidates},
          "step_basis": "CUDA events, median of 5 after a warm step, a copy "
                        "of the trained model at world size 1",
          "card": card})
    check(fused == {"batches": expect_batches, "failed": 0},
          f"the training run's batches through the native route: {fused}, "
          f"expected {expect_batches}")
    check(per_token[-1] < per_token[0],
          f"the loss per token did not fall: {per_token}")

    # the tools on the two epoch checkpoints
    ckpt_dir = os.path.join(workdir, config.train.ckpt_dir)
    inputs = average_ckpts.ordered_last_ckpts(ckpt_dir, LS100_EPOCHS)
    avg = os.path.join(workdir, "avg.pt")
    summary = average_ckpts.main(["--out", avg, "--last", str(LS100_EPOCHS),
                                  "--ckpt-dir", ckpt_dir])
    got = restore_params(avg)[0]
    ins = [restore_params(p)[0] for p in inputs]
    mean_ok = all(torch.equal(got[k], (sum(p[k].double() for p in ins)
                                       / len(ins)).to(got[k].dtype))
                  for k in got if got[k].is_floating_point())
    emit({"phase": "ls100_average", "summary": summary,
          "each_parameter_the_mean": mean_ok})
    check(mean_ok and len(inputs) == LS100_EPOCHS,
          f"average_ckpts over {inputs}: parameters the mean {mean_ok}")
    last_ckpt = inputs[-1]
    decoded = {}
    for tag, ck in (("avg", avg), ("last", last_ckpt)):
        out = os.path.join(workdir, f"decode_{tag}.jsonl")
        reset_counts()
        t0 = time.perf_counter()
        res = decode.main(["--config", LS100_CONFIG, *sets, "--ckpt", ck,
                           "--output", out, "--device", "cuda"])
        wall = time.perf_counter() - t0
        counts[f"decode_{tag}"], plain = read_counts()
        with open(out) as f:
            decoded[tag] = {r["utt_id"]: r["hyp"] for r in map(json.loads, f)}
        emit({"phase": "ls100_decode", "ckpt": tag, "method": res["method"],
              "utts": res["num_utts"], "wer": res["wer"], "cer": res["cer"],
              "wall_s": wall, "launches": counts[f"decode_{tag}"],
              "note": f"{LS100_EPOCHS} of 5 epochs on {LS100_TRAIN} "
                      "utterances: not a check"})
        check(res["num_utts"] == LS100_DEV and not any(plain.values()),
              f"decode {tag}: {res['num_utts']} utterances, plain {plain}")
    reset_counts()
    t0 = time.perf_counter()
    tuned = tune_decode.main([
        "--config", LS100_CONFIG, *sets, "--ckpt", last_ckpt,
        *[a for g in LS100_GRID for a in ("--grid", g)],
        "--output", os.path.join(workdir, "tune.jsonl"), "--device", "cuda"])
    counts["tune_decode"], plain = read_counts()
    emit({"phase": "ls100_tune_decode", "summary": tuned,
          "wall_s": time.perf_counter() - t0})
    check(tuned["event"] == "tune_decode_done" and not any(plain.values()),
          f"tune_decode: {tuned}, plain {plain}")
    dev_utts = {u.utt_id: u for u in build_librispeech_manifest(corpus,
                                                                "dev-clean")}
    plots = os.path.join(workdir, "attention")
    shutil.rmtree(plots, ignore_errors=True)
    reset_counts()
    shown = plot_attention.main(["--config", LS100_CONFIG, *sets, "--ckpt",
                                 last_ckpt, "--out", plots, "--num", "4",
                                 "--no-png", "--device", "cuda"])
    counts["plot_attention"], plain = read_counts()
    shapes, row_err = {}, 0.0
    for u in shown["utts"]:
        a = np.load(os.path.join(plots, f"{u}.npy"))
        n_tok = len(tok.encode(dev_utts[u].text)[:config.data.max_label_len])
        T = num_frames_of(config, native.probe_flac(
            dev_utts[u].audio_path)[1] / config.data.sample_rate)
        shapes[u] = (list(a.shape), [n_tok + 1, T])
        row_err = max(row_err, float(np.abs(a.sum(-1) - 1.0).max()))
    emit({"phase": "ls100_plot_attention", "shapes_got_want": shapes,
          "row_sum_max_abs_err": row_err, "tol": TOL_ATT_ROW,
          "png": shown["png"]})
    check(len(shapes) == 4 and all(g == w_ for g, w_ in shapes.values())
          and row_err <= TOL_ATT_ROW and not any(plain.values()),
          f"plot_attention: shapes {shapes}, rows {row_err}, plain {plain}")
    # transcribe: the two shortest dev utterances, in the first bucket, as
    # .flac files
    pick = sorted((u for u in decoded["last"] if dev_utts[u].duration
                   <= config.data.bucket_bounds_sec[0]),
                  key=lambda u: dev_utts[u].duration)[:2]
    reset_counts()
    results = transcribe.main(["--config", LS100_CONFIG, *sets, "--ckpt",
                               last_ckpt, "--device", "cuda",
                               *[dev_utts[u].audio_path for u in pick]])
    counts["transcribe"], plain = read_counts()
    texts = dict(zip(pick, [results[k] for k in sorted(results)]))
    same = {u: texts[u] == decoded["last"][u] for u in pick}
    emit({"phase": "ls100_transcribe", "files": pick, "texts": texts,
          "decode_cli_texts": {u: decoded["last"][u] for u in pick},
          "equal": same, "launches": counts["transcribe"]})
    check(len(pick) == 2 and all(same.values()) and not any(plain.values()),
          f"transcribe's texts against the decode CLI's: {same}")
    emit({"phase": "ls100_phase_done",
          "seconds": round(time.perf_counter() - t_phase, 1)})
    del trainer
    return counts, at_shape


def batch_kernel_checks(torch, config, trainer, b, name, dev):
    """One training batch ``b`` of ``trainer``'s run (its config
    ``config``) against the plain versions: K1-fwd and K1-bwd at each
    layer's shape (layer 0 on the batch's features, the others on seeded
    inputs of every row live), K2/K3 on the batch's lattice and
    K4-fwd/K4-bwd in the config's attention mode (coins off and at the
    config's rate) at phase 3's tolerances, in the config's compute dtype;
    then one train step of the trained model through the kernels against
    it through the plain versions at phase 7's. Returns (errors, the
    step's, (B, T, T'))."""
    from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply, num_frames

    mc, fc = config.model, config.frontend
    lens = num_frames(torch.from_numpy(b.audio_len), fc.win_length,
                      fc.hop_length)
    T = num_frames(b.audio.shape[1], fc.win_length, fc.hop_length)
    for f in mc.enc_subsample:
        lens, T = (lens + int(f) - 1) // int(f), -(-T // int(f))
    for c in (config, trainer.config):
        _BATCH[c.fingerprint()] = (b, trainer.tokenizer, lens.int(), T)
    with torch.no_grad():
        feats, flen = frontend_apply(fc, torch.from_numpy(b.audio).to(dev),
                                     torch.from_numpy(b.audio_len).to(dev),
                                     cmvn_stats=trainer.cmvn_stats)
    B, T0, _ = feats.shape
    H, cd = mc.enc_hidden, mc.compute_dtype
    errs = {}
    for layer, Tl, D in layer_shapes(config, T0):
        args = layer_inputs(torch, B, Tl, D, H, layer, dev)
        if layer == 0:
            args = (feats.contiguous(), flen.int(), *args[2:])
        dy = layer_cotangent(torch, B, Tl, H, layer, dev)
        errs[f"k1_layer{layer}"] = check_k1_case(torch, name, layer, args, dy,
                                                 cd)[0]
    if config.loss.mtl_alpha > 0:
        errs["ctc"] = check_ctc_case(torch, name,
                                     real_ctc_batch(torch, config, dev))
    if trainer.model.use_decoder and mc.dec_layers == 1:
        errs["k4"] = check_decoder_kernels(
            torch, config, dev, mc.att_type,
            cases=[(cd, 0.0, False), (cd, config.loss.scheduled_sampling,
                                      False)])
    return errs, train_reference(torch, trainer, dev), (B, T0, T)


def disk_check(phase: str, need: float, **what) -> bool:
    """The bytes free where OUT_DIR's corpora go, printed with ``what``;
    a failed check where they are not above ``need``. Returns whether
    every check so far passed."""
    os.makedirs(OUT_DIR, exist_ok=True)
    free = shutil.disk_usage(OUT_DIR).free
    emit({"phase": phase, "path": os.path.relpath(OUT_DIR, REPO),
          "free_bytes": free, "need_bytes": need, **what})
    check(free > need, f"{free} bytes free for {need}: {what}")
    return not FAILED


def ls_shape_phase(torch, dev, card):
    """Phase 13 (``--only 13``): configs/ls100_shape.yaml on the card. The
    disk free where the corpus goes; the corpus rendered by the port's
    ``tools/make_synth_corpus.py`` with the config's header flags, cut to
    LS_SHAPE_TRAIN + LS_SHAPE_DEV utterances; ``tools/compute_cmvn.py``;
    LS_SHAPE_EPOCHS epoch through the train CLI as shipped but for the
    corpus, the stats file and the epoch count (dynamic batches, speed
    perturbation, SortaGrad; phase 6's launch counts: every K1, K2, K3
    and K4 launch through its cluster or warp kernel, no plain call). For
    each bucket the B, T (frames), T' (encoder frames) and L (decoder
    steps) it stepped at, K1's cluster plan in each direction and K4's at
    that B, and a step timed. At the 4 s bucket's batch (B = 148, rows
    past the bucket's utterances padding): K1-fwd and K1-bwd at each
    layer's shape (layer 0 on the batch's features, the others on seeded
    inputs of every row live), K2/K3 and K4-fwd/K4-bwd loc (coins off and
    on) against their plain versions at phase 3's tolerances, and one
    train step through the kernels against it through the plain versions
    at phase 7's. Returns {path: launches}."""
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
    from gluon_e2e_asr_tpu_torch.frontend.features import num_frames
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as LD
    from gluon_e2e_asr_tpu_torch.tools import compute_cmvn
    from gluon_e2e_asr_tpu_torch.tools import make_synth_corpus as MS
    from gluon_e2e_asr_tpu_torch.training import trainer as TR
    from gluon_e2e_asr_tpu_torch.training.train_step import batch_to_device

    t_phase = time.perf_counter()
    corpus = os.path.join(OUT_DIR, "ls_shape_corpus")
    shutil.rmtree(corpus, ignore_errors=True)
    need = (LS_SHAPE_TRAIN + LS_SHAPE_DEV) * LS_SHAPE_BYTES
    if not disk_check("ls_shape_disk", 4 * need, render_bound_bytes=need):
        return {}
    flags = [f for k, v in LS_SHAPE_RENDER.items()
             for f in (f"--{k.replace('_', '-')}", str(v))]
    t0 = time.perf_counter()
    made = MS.main(["--out", corpus, "--num-train", str(LS_SHAPE_TRAIN),
                    "--num-dev", str(LS_SHAPE_DEV), *flags])
    render_s = time.perf_counter() - t0
    sets = ["--set", f"data.data_dir={corpus}"]
    stats = os.path.join(OUT_DIR, "cmvn_ls_shape.npz")
    t0 = time.perf_counter()
    compute_cmvn.main(["--config", LS_SHAPE_CONFIG, "--output", stats, *sets,
                       "--device", "cuda"])
    cmvn_s = time.perf_counter() - t0
    sets += ["--set", f"frontend.cmvn_stats_path={stats}"]
    config = load_config(LS_SHAPE_CONFIG)
    apply_overrides(config, sets[1::2])
    dc, mc = config.data, config.model
    emit({"phase": "ls_shape_render", "flags": flags, "train": LS_SHAPE_TRAIN,
          "dev": LS_SHAPE_DEV, "epochs": LS_SHAPE_EPOCHS,
          "cuts": {"train": [5000, LS_SHAPE_TRAIN], "dev": [512, LS_SHAPE_DEV],
                   "epochs": [config.train.num_epochs, LS_SHAPE_EPOCHS]},
          "hours": made["hours"], "render_s": render_s, "cmvn_s": cmvn_s,
          "free_bytes_after": shutil.disk_usage(OUT_DIR).free, "card": card})

    # one epoch through the train CLI, each step's batch shape recorded
    shapes = []
    make_step = TR.make_train_step

    def recorded(*a, **k):
        fn = make_step(*a, **k)

        def step(state, batch):
            shapes.append((tuple(batch["audio"].shape),
                           tuple(batch["labels"].shape)))
            return fn(state, batch)
        return step

    steps = epoch_steps(config, LS_SHAPE_EPOCHS)
    TR.make_train_step = recorded
    try:
        trainer, counts = train_slice(
            torch, LS_SHAPE_CONFIG, "ls_shape", steps,
            extra=[*sets, "--set", f"train.num_epochs={LS_SHAPE_EPOCHS}"],
            shipped=True, falls=False)
    finally:
        TR.make_train_step = make_step
    check(len(shapes) == steps, f"{len(shapes)} steps recorded of {steps}")
    specs = trainer.sampler.specs
    by_samples = {s.max_samples: i for i, s in enumerate(specs)}
    fc = config.frontend
    step = stepper(torch, trainer, dev)
    buckets = {}
    for (B, n), (_, L) in shapes:
        i = by_samples[n]
        if i in buckets:
            buckets[i]["steps"] += 1
            continue
        T = num_frames(n, fc.win_length, fc.hop_length)
        Tp = num_frames_of(config, n / dc.sample_rate)
        dims = (Tp, 2 * mc.enc_hidden, mc.att_dim, mc.dec_embed,
                mc.dec_hidden, trainer.tokenizer.vocab_size,
                mc.loc_conv_channels, mc.loc_conv_width)
        bf = torch.bfloat16
        buckets[i] = {
            "seconds": dc.bucket_bounds_sec[i], "B": B, "T": T, "T_enc": Tp,
            "L": L + 1, "steps": 1,
            "k1_fwd_plan": K.cluster_plan("fwd", B, mc.enc_hidden, bf, dev),
            "k1_bwd_plan": K.cluster_plan("bwd", B, mc.enc_hidden, bf, dev),
            "k4_plan": {"fwd_route": LD.fwd_route("loc", bf, *dims),
                        "bwd_route": LD.bwd_route("loc", bf, *dims),
                        "clusters": -(-B // LD.CLUSTER_ROWS),
                        "ctas": -(-B // LD.CLUSTER_ROWS) * LD.CLUSTER_ROWS}}
    for bucket, idxs in trainer.sampler.epoch_batches(0):
        if "step_ms" in buckets[bucket]:
            continue
        b = trainer.loader.make_batch(bucket, idxs, epoch=0)
        batch = batch_to_device(b, dev)
        buckets[bucket].update(real=b.num_real, step_ms=time_ms(
            torch, lambda: step(batch), n=3, warm=1))
    del step
    for i in sorted(buckets):
        emit({"phase": "ls_shape_bucket", "bucket": i, **buckets[i],
              "card": card})
    check(sorted(buckets) == list(range(len(specs)))
          and all(buckets[i]["B"] == specs[i].batch_size for i in buckets),
          f"the epoch's buckets and batch sizes: {buckets}")
    check(all(r["k4_plan"]["fwd_route"] == r["k4_plan"]["bwd_route"]
              == "cluster" for r in buckets.values()),
          "K4 loc left its cluster kernels at an ls100_shape bucket")

    # the 4 s bucket's batch (B = 148) against the plain versions
    bucket, idxs = next(x for x in trainer.sampler.epoch_batches(0)
                        if x[0] == 0)
    b = trainer.loader.make_batch(bucket, idxs, epoch=0)
    name = f"ls100_shape {dc.bucket_bounds_sec[0]} s, B={b.audio.shape[0]}"
    errs, step_errs, (B, T0, T) = batch_kernel_checks(torch, config, trainer,
                                                      b, name, dev)
    emit({"phase": "ls_shape_largest_b", "bucket": 0, "B": B,
          "real": b.num_real, "T": T0, "T_enc": T, "errors": errs,
          "train_step": step_errs, "card": card})
    emit({"phase": "ls_shape_done",
          "seconds": round(time.perf_counter() - t_phase, 1)})
    del trainer
    return {"ls_shape_train": counts}


def convergence_phase(torch, dev, card, pid, overrides=()):
    """Phase 14 (``--only 14a`` .. ``14d``, one config an id): the config
    of CONVERGENCE[pid] through the train CLI as shipped (the ``--set``
    ``overrides`` alone, for a second seed), every epoch with its dev
    evaluation picking best.pt: the launch counts of phase 6 (every K1, K2,
    K3 and K4 launch through its cluster or warp kernel, every bf16 K1-fwd
    launch through the wgmma projection), no plain call, a finite loss,
    one line an epoch (steps, mean loss, dev WER, seconds); best.pt
    through the decode CLI by the config's decode block over all 192 dev
    utterances (K1-fwd's launches counted around it); the records' refs
    equal to the TPU record's, 192/192 (else the comparison is void and the
    phase fails), then the port's WER and CER with 95% bootstrap intervals
    and the paired difference port - TPU with its interval and p(diff >=
    0) (tools/wer_ci.py, 10,000 resamples, seed 0, paired by utt_id). The
    records go to OUT_DIR/<config>_h100_dev192[_seed<n>].jsonl and, one a
    line, to stdout."""
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
    from gluon_e2e_asr_tpu_torch.tools import convergence as CV

    t_phase = time.perf_counter()
    cfg_name, rec_name = CONVERGENCE[pid]
    path = os.path.join(REPO, "configs", f"{cfg_name}.yaml")
    tpu = os.path.join(REPO, "docs", "evidence", f"{rec_name}.jsonl")
    extra = [a for o in overrides for a in ("--set", o)]
    config = load_config(path)
    apply_overrides(config, list(overrides))
    refs = CV.dev_refs(config)
    tpu_records = CV.read_records(tpu)
    n_match = CV.refs_match(refs, tpu_records)
    emit({"phase": "convergence_refs", "id": pid,
          "config": os.path.relpath(path, REPO),
          "tpu_record": os.path.relpath(tpu, REPO), "dev_utts": len(refs),
          "refs_equal": n_match, "overrides": list(overrides)})
    check(n_match == len(refs) == len(tpu_records) == 192,
          f"{pid}: {n_match} of {len(tpu_records)} TPU refs equal the dev "
          f"set's {len(refs)}: the comparison is void")
    if FAILED:
        return
    seed = config.train.seed
    sfx = f"_seed{seed}" if seed else ""
    name = f"{cfg_name}_h100_dev192{sfx}"
    epochs = config.train.num_epochs
    steps = epoch_steps(config, epochs)
    record = []
    reset_counts()
    t0 = time.perf_counter()
    trainer, lines = _run_cli(torch, path, f"conv_{pid}{sfx}", extra, record)
    train_s = time.perf_counter() - t0
    launches, plain = read_counts()
    losses = [loss for loss, _ in record]
    ends = CV.epoch_records(lines)
    dev_batches = len(list(trainer.dev_loader.sampler.epoch_batches(0)))
    expect = expected_launches(config, steps, dev_batches * len(ends),
                               trainer.model.use_decoder)
    first = 0
    for r in ends:
        r["loss"] = float(np.mean(losses[first:r["step"]]))
        emit({"phase": "convergence_epoch", "id": pid, "epoch": r["epoch"],
              "steps": r["step"], "loss": r["loss"],
              "loss_logged": r["loss_logged"],
              "dev_wer": r["dev_wer"], "dev_cer": r["dev_cer"],
              "seconds": r["epoch_time_s"]})
        first = r["step"]
    CV.write_lines(os.path.join(OUT_DIR, f"{name}_epochs.jsonl"), ends)
    ckpt, best_epoch = CV.best_checkpoint(trainer)
    emit({"phase": "convergence_train", "id": pid, "epochs": len(ends),
          "epochs_shipped": epochs, "steps": trainer.state.step,
          "expected_steps": steps, "train_s": round(train_s, 1),
          "launches": launches, "expected_launches": expect,
          "plain_calls": plain, "best_epoch": best_epoch,
          "best_dev_wer": trainer.best_wer,
          "world_size": trainer.world.size, "card": card})
    check(trainer.state.step == steps == len(losses) and len(ends) == epochs,
          f"{pid}: {trainer.state.step} steps of {steps}, {len(ends)} epochs "
          f"of {epochs}")
    check(launches == expect, f"{pid}: training launches {launches}, "
                              f"expected {expect}")
    check(not any(plain.values()), f"{pid}: plain versions ran: {plain}")
    check(all(np.isfinite(losses)), f"{pid}: a non-finite loss")
    # the trained model's kernels at the config's own shapes: the first
    # batch of the longest bucket that has one
    bucket, idxs = max(trainer.sampler.epoch_batches(0), key=lambda x: x[0])
    b = trainer.loader.make_batch(bucket, idxs, epoch=0)
    sec = config.data.bucket_bounds_sec[bucket]
    errs, step_errs, _ = batch_kernel_checks(torch, config, trainer, b,
                                             f"{cfg_name} {sec} s", dev)
    emit({"phase": "convergence_kernels", "id": pid, "bucket": bucket,
          "B": int(b.audio.shape[0]), "errors": errs, "train_step": step_errs})
    del trainer

    out = os.path.join(OUT_DIR, f"{name}.jsonl")
    reset_counts()
    t0 = time.perf_counter()
    res = CV.decode_best(path, ckpt, out, overrides, "cuda")
    decode_s = time.perf_counter() - t0
    dec_launches, plain = read_counts()
    records = CV.read_records(out)
    layers = config.model.enc_layers
    fwd = layers * (res["num_batches"] + res["warm_passes"])
    bf16 = config.model.compute_dtype == "bfloat16"
    check(dec_launches["bilstm_fwd"] == dec_launches["bilstm_fwd_cluster"]
          == fwd and dec_launches["bilstm_fwd_projection"] == fwd * bf16
          and not any(plain.values()),
          f"{pid}: the decode of best.pt launched {dec_launches}, plain "
          f"{plain}, expected {fwd} K1-fwd launches")
    n_match = CV.refs_match(refs, records)
    check(n_match == len(records) == len(refs),
          f"{pid}: {n_match} of {len(records)} decoded refs equal the dev set")
    stats = CV.compare(out, tpu)
    for r in records:
        emit({"phase": "convergence_record", "id": pid, **r})
    emit({"phase": "convergence", "id": pid,
          "config": os.path.relpath(path, REPO),
          "overrides": list(overrides), "train_seed": seed,
          "epochs": len(ends),
          "steps": steps, "best_epoch": best_epoch,
          "decode": {k: res[k] for k in ("method", "num_utts", "wer", "cer")},
          "beam": {k: getattr(config.decode, k) for k in (
              "beam_size", "ctc_weight", "length_norm", "maxlen_ratio",
              "ctc_score_candidates")},
          "decode_s": round(decode_s, 1), "k1_fwd_decode_launches": fwd,
          "tpu_record": os.path.relpath(tpu, REPO),
          "records": os.path.relpath(out, REPO), **stats,
          "seconds": round(time.perf_counter() - t_phase, 1), "card": card})
    check(res["num_utts"] == 192 == stats["utts"],
          f"{pid}: decoded {res['num_utts']} utterances")
    if config.decode.method == "beam" and 0.0 < config.decode.ctc_weight < 1.0:
        convergence_branches(pid, path, ckpt, name, overrides, refs, out,
                             tpu, card)


def convergence_branches(pid, path, ckpt, name, overrides, refs, joint, tpu,
                         card):
    """Phase 14's joint beam taken apart: ``best.pt`` decoded over the same
    192 dev utterances by each branch alone, CTC (``ctc_beam``, the CTC
    prefix beam with the config's partial scoring) and attention (``beam``
    with ``decode.ctc_weight=0``), no plain call; each record's WER and CER
    with 95% intervals, paired against the joint beam's record and the
    TPU record. The records go to OUT_DIR/<name>_{ctc,att}.jsonl."""
    from gluon_e2e_asr_tpu_torch.tools import convergence as CV

    for branch, method, sets in (("ctc", "ctc_beam", ()),
                                 ("att", "beam", ("decode.ctc_weight=0",))):
        out = os.path.join(OUT_DIR, f"{name}_{branch}.jsonl")
        reset_counts()
        t0 = time.perf_counter()
        res = CV.decode_best(path, ckpt, out, [*overrides, *sets], "cuda",
                             method)
        seconds = time.perf_counter() - t0
        _, plain = read_counts()
        records = CV.read_records(out)
        check(CV.refs_match(refs, records) == len(records) == 192
              and not any(plain.values()),
              f"{pid} {branch}: {len(records)} records, plain {plain}")
        vs_joint, vs_tpu = CV.compare(out, joint), CV.compare(out, tpu)
        emit({"phase": "convergence_branch", "id": pid, "branch": branch,
              "method": res["method"], "sets": list(sets),
              "records": os.path.relpath(out, REPO),
              **CV.intervals(out), "diff_vs_joint": vs_joint["wer_diff"],
              "diff_vs_joint_ci95": vs_joint["wer_diff_ci95"],
              "diff_vs_tpu": vs_tpu["wer_diff"],
              "diff_vs_tpu_ci95": vs_tpu["wer_diff_ci95"],
              "seconds": round(seconds, 1), "card": card})


def milestones_phase(torch, dev, card):
    """Phase 15 (``--only 15``): ``tools/run_milestones.py --device cuda``
    as a user runs it, the five milestone configs as shipped, every epoch
    (40, 40, 60, 60, 60), each ``best.pt`` decoded over the 192 dev
    utterances by its config's method; no plain call, every K1-fwd launch
    through the cluster recurrence. Each milestone's steps, train seconds,
    best epoch and dev WER and CER with 95% bootstrap intervals
    (tools/wer_ci.py, 10,000 resamples, seed 0), and for m5 the paired
    difference against the TPU run's record of the same utterances
    (MILESTONE_RECORDS; m1-m4 have no per-utterance TPU record). The
    records go to OUT_DIR/milestones_<m>_h100_dev192.jsonl."""
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.tools import convergence as CV
    from gluon_e2e_asr_tpu_torch.tools import run_milestones as RM

    wd = os.path.join(OUT_DIR, "milestones")
    shutil.rmtree(wd, ignore_errors=True)
    reset_counts()
    t0 = time.perf_counter()
    rows = RM.main(["--workdir", wd, "--device", "cuda"])
    seconds = time.perf_counter() - t0
    launches, plain = read_counts()
    emit({"phase": "milestones_run", "milestones": [r["milestone"] for r in rows],
          "seconds": round(seconds, 1), "launches": launches,
          "plain_calls": plain, "card": card})
    check(len(rows) == len(RM.CONFIGS) and not any(plain.values())
          and launches["bilstm_fwd"] == launches["bilstm_fwd_cluster"] > 0,
          f"15: {len(rows)} milestones, launches {launches}, plain {plain}")
    paths = dict(RM.CONFIGS)
    for row in rows:
        m = row["milestone"]
        config = load_config(os.path.join(REPO, paths[m]))
        out = os.path.join(OUT_DIR, f"milestones_{m}_h100_dev192.jsonl")
        records = CV.read_records(os.path.join(wd, m, "decode.jsonl"))
        CV.write_records(out, records)
        n_match = CV.refs_match(CV.dev_refs(config), records)
        check(n_match == len(records) == 192,
              f"15 {m}: {n_match} of {len(records)} refs equal the dev set")
        with open(os.path.join(wd, m, config.train.ckpt_dir,
                               "best.pt.json")) as f:
            best_epoch = int(json.load(f)["epoch"])
        stats = CV.intervals(out)
        if m in MILESTONE_RECORDS:
            tpu = os.path.join(REPO, "docs", "evidence",
                               f"{MILESTONE_RECORDS[m]}.jsonl")
            stats = dict(CV.compare(out, tpu),
                         tpu_record=os.path.relpath(tpu, REPO))
        emit({"phase": "milestone", **row, "config": paths[m],
              "epochs": config.train.num_epochs, "best_epoch": best_epoch,
              "records": os.path.relpath(out, REPO), **stats, "card": card})


def ls100_full_manifest(split: str) -> list:
    """The utterances (utt_id, text, duration) that walking ls100_full's
    corpus at its own scale (LS100_RENDER's flags, LS100_FULL) gives for
    ``split``, from the texts alone: ``tools/make_synth_corpus.py``'s draws
    and file layout (the train split from the seed, speakers from 100; the
    dev split from the seed + 1, speakers from 900), each duration the
    synthesizer's sample count (a gap, then a tone and a gap a character)
    over the rate."""
    from gluon_e2e_asr_tpu_torch.data import manifest as M
    from gluon_e2e_asr_tpu_torch.tools import make_synth_corpus as MS

    r, sr = LS100_RENDER, 16000
    num, seed, spk = ((LS100_FULL[0], r["seed"], 100) if split.startswith("train")
                      else (LS100_FULL[1], r["seed"] + 1, 900))
    seg, gap = int(M._SEG_SEC * sr), int(M._GAP_SEC * sr)
    # the text as the walk reads it: the transcript's upper case, lowered
    utts = [M.Utterance(utt_id=MS.utt_location("", split, i, spk, "flac")[1],
                        text=u.text.upper().lower(),
                        duration=(gap + len(u.text) * (seg + gap)) / sr)
            for i, u in enumerate(MS._ls_duration_utts(
                split, num, seed, r["text_mode"], r["noise"], r["jitter"],
                pool_split=r["pool_split"]))]
    return sorted(utts, key=lambda u: u.utt_id)


def peak_rss() -> tuple:
    """(bytes, source) of this process's peak resident set: ``VmHWM`` of
    /proc/self/status where the kernel reports it, else getrusage's
    ``ru_maxrss`` (the same peak, in KiB on Linux); (None, None) where
    neither does (some kernels report neither)."""
    import resource

    with open("/proc/self/status") as f:
        hwm = [line.split()[1] for line in f if line.startswith("VmHWM:")]
    if hwm:
        return int(hwm[0]) * 1024, "VmHWM"
    kb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    return (kb * 1024, "ru_maxrss") if kb > 0 else (None, None)


def ls100_full_eval_cost(torch, config, workdir, card):
    """Phase 16a: the per-epoch dev evaluation (``Trainer.evaluate`` over
    the 2,700 dev utterances) of the untrained model (train.seed's
    initialisation), timed by the config's beam and greedily, each beam
    batch's seconds and output steps by bucket. An untrained model ends
    no hypothesis early, so its beam runs to the length limit: a bound on
    a trained model's."""
    from gluon_e2e_asr_tpu_torch.decoding.greedy import make_greedy_decoder
    from gluon_e2e_asr_tpu_torch.training.trainer import Trainer

    os.makedirs(workdir, exist_ok=True)
    trainer = Trainer(config, workdir, torch.device("cuda"))
    beam, batches = trainer._beam, []

    def timed(audio, audio_len):
        t0 = time.perf_counter()
        out = beam(audio, audio_len)
        torch.cuda.synchronize()
        batches.append((int(audio.shape[1]), int(audio.shape[0]),
                        time.perf_counter() - t0, int(beam.last_steps)))
        return out

    evals = {}
    trainer._beam = timed
    for method in ("beam", "greedy"):
        if method == "greedy":
            trainer._beam = None
            trainer.greedy = make_greedy_decoder(
                trainer.model, trainer.config, trainer.cmvn_stats,
                trainer.device)
        reset_counts()
        t0 = time.perf_counter()
        dev_scores = trainer.evaluate()
        torch.cuda.synchronize()
        evals[method] = {"seconds": time.perf_counter() - t0, **dev_scores}
        launches, plain = read_counts()
        check(not any(plain.values()) and launches["bilstm_fwd"]
              == launches["bilstm_fwd_cluster"] > 0,
              f"16a {method}: launches {launches}, plain {plain}")
    specs = trainer.dev_loader.sampler.specs
    by_bucket = {}
    for samples, B, sec, steps in batches:
        i = next(j for j, s in enumerate(specs) if s.max_samples == samples)
        r = by_bucket.setdefault(i, {"seconds": config.data.bucket_bounds_sec[i],
                                     "B": B, "batches": 0, "beam_s": 0.0,
                                     "steps": 0})
        r["batches"] += 1
        r["beam_s"] += sec
        r["steps"] += steps
    emit({"phase": "ls100_full_eval_cost", "evaluations": evals,
          "beam_by_bucket": by_bucket,
          "beam": {k: getattr(config.decode, k) for k in (
              "beam_size", "ctc_weight", "length_norm", "maxlen_ratio",
              "ctc_score_candidates")},
          "basis": "host clock around Trainer.evaluate and each beam batch "
                   "(synchronized), the untrained model", "card": card})
    del trainer


def ls100_full_phase(torch, dev, card, measure_only=False):
    """Phase 16 (``--only 16``): configs/ls100_full.yaml as shipped at its
    own scale, 28,500 train + 2,700 dev utterances for its 5 epochs. The
    disk free where the corpus goes, against the corpus's 16-bit PCM and
    LS100_FULL_SPARE_BYTES; the corpus rendered with the config's header
    flags on every core (ls100_render: three files decoded to exactly the
    encoder's PCM, the manifest walk timed), its walk equal to
    ls100_full_manifest's utterances; the dev refs equal to the TPU
    record's, 2,700/2,700 (else the comparison is void and the phase
    stops); ``tools/compute_cmvn.py`` at the config's int16 transfer. With
    ``measure_only`` (``--only 16a``) it stops there after
    ls100_full_eval_cost. Otherwise the train CLI as shipped but for the
    corpus, the stats path and LS100_FULL_EVAL (every epoch): phase 6's
    launch counts, no plain call, a finite loss, one line an epoch (steps
    and pad waste beside the TPU table's, which they must equal; the
    prefetch occupancy; the training part's seconds, the epoch line's less
    the dev evaluation's, and its utt/s; the evaluation's seconds; dev WER
    and CER; the checkpoint's save seconds; the process's peak RSS; the
    disk free); on the first batch of each bucket the trained model's
    kernels against their plain versions (batch_kernel_checks: phase 3's
    and 7's tolerances); best.pt decoded by the config's beam over the
    2,700 dev utterances (and, where the evaluation was cut and picked an
    earlier epoch, the last checkpoint too), the p50 latency, and the
    records paired with the TPU record (tools/convergence.py: 95%
    bootstrap intervals, port - TPU by utt_id, p(diff >= 0), 10,000
    resamples, seed 0): a tie, a gap, or a fault (the paired interval
    wholly above LS100_FULL_FAULT). The records go to
    OUT_DIR/LS100_FULL_NAME.jsonl, the epoch lines beside them."""
    from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config
    from gluon_e2e_asr_tpu_torch.tools import convergence as CV
    from gluon_e2e_asr_tpu_torch.training import trainer as TR

    t_phase = time.perf_counter()
    corpus = os.path.join(OUT_DIR, "ls100_full_corpus")
    plan = {s: ls100_full_manifest(s) for s in ("train-clean-100", "dev-clean")}
    sr = 16000
    pcm = 2 * sum(round(u.duration * sr) for us in plan.values() for u in us)
    shutil.rmtree(corpus, ignore_errors=True)
    if not disk_check("ls100_full_disk", pcm + LS100_FULL_SPARE_BYTES,
                      pcm_bytes=pcm, spare_bytes=LS100_FULL_SPARE_BYTES):
        return
    ls100_render(torch, corpus, card, *LS100_FULL)
    sets = [f"data.data_dir={corpus}"]
    config = load_config(LS100_CONFIG)
    apply_overrides(config, sets)
    walked = dict(zip(plan, TR.build_datasets(config)))
    same = {s: [(u.utt_id, u.text, round(u.duration * sr)) for u in us]
            == [(u.utt_id, u.text, round(u.duration * sr)) for u in plan[s]]
            for s, us in walked.items()}
    refs = {u.utt_id: u.text for u in walked["dev-clean"]}
    tpu = os.path.join(REPO, "docs", "evidence", f"{LS100_FULL_RECORD}.jsonl")
    n_match = CV.refs_match(refs, CV.read_records(tpu))
    emit({"phase": "ls100_full_refs", "tpu_record": os.path.relpath(tpu, REPO),
          "dev_utts": len(refs), "refs_equal": n_match,
          "walk_equals_the_texts_plan": same,
          "hours": {s: sum(u.duration for u in us) / 3600
                    for s, us in walked.items()}})
    check(all(same.values()), f"the walked corpus differs from the plan: {same}")
    check(n_match == len(refs) == LS100_FULL[1],
          f"16: {n_match} of the TPU record's refs equal the dev set's "
          f"{len(refs)}: the comparison is void")
    if FAILED:
        return
    stats = ls100_cmvn(torch, ["--set", sets[0]],
                       os.path.join(OUT_DIR, "ls100_full_cmvn"), card,
                       dtypes=("int16",))
    sets.append(f"frontend.cmvn_stats_path={stats}")
    apply_overrides(config, sets[1:])
    if measure_only:
        ls100_full_eval_cost(torch, config, os.path.join(OUT_DIR, "ls100_full_16a"),
                             card)
        emit({"phase": "ls100_full_done", "measure_only": True,
              "seconds": round(time.perf_counter() - t_phase, 1)})
        return

    # training: the train CLI, every epoch, one line an epoch
    extra = [a for o in (*sets, *LS100_FULL_EVAL) for a in ("--set", o)]
    metrics = os.path.join(OUT_DIR, "ls100_full", config.train.metrics_path)
    evals, rows = [], []
    evaluate, checkpoint = TR.Trainer.evaluate, TR.Trainer._checkpoint

    def timed_evaluate(self):
        t0 = time.perf_counter()
        out = evaluate(self)
        torch.cuda.synchronize()
        evals.append(time.perf_counter() - t0)
        return out

    def epoch_line(self, epoch, is_best, batches_done=-1, dev_wer=None):
        path = checkpoint(self, epoch, is_best, batches_done, dev_wer)
        if is_best is None:
            return path
        with open(metrics) as f:
            lines = [json.loads(line) for line in f]
        rec = CV.epoch_records(lines)[-1]
        io = [r for r in lines if r["event"] == "ckpt_io"][-1]
        first = rows[-1]["step"] if rows else 0
        train_s = rec["epoch_time_s"] - evals[-1]
        utts = len(self.train_utts) - len(self.sampler.skipped)
        tpu_e = {k: v[epoch] for k, v in LS100_FULL_TPU.items()}
        rows.append({
            "epoch": epoch, "step": rec["step"], "steps": rec["step"] - first,
            "pad_waste": rec["pad_waste"],
            "prefetch_occupancy": rec["prefetch_occupancy"],
            "train_s": train_s, "train_utt_per_s": utts / train_s,
            "eval_s": evals[-1], "eval_method": self.config.decode.method,
            "dev_wer": rec["dev_wer"], "dev_cer": rec["dev_cer"],
            "ckpt_save_s": io["save_s"],
            **dict(zip(("peak_rss_bytes", "peak_rss_source"), peak_rss())),
            "free_disk_bytes": shutil.disk_usage(OUT_DIR).free,
            "epoch_time_s": rec["epoch_time_s"],
            "utt_per_sec_per_chip": rec["utt_per_sec_per_chip"],
            "loss_logged": rec["loss_logged"], "tpu": tpu_e})
        emit({"phase": "ls100_full_epoch", **rows[-1], "card": card})
        return path

    epochs = config.train.num_epochs
    steps = sum(LS100_FULL_TPU["steps"])
    reset_counts()
    TR.Trainer.evaluate, TR.Trainer._checkpoint = timed_evaluate, epoch_line
    t0 = time.perf_counter()
    try:
        trainer, _ = _run_cli(torch, LS100_CONFIG, "ls100_full", extra)
    finally:
        TR.Trainer.evaluate, TR.Trainer._checkpoint = evaluate, checkpoint
    train_s = time.perf_counter() - t0
    launches, plain = read_counts()
    dev_batches = len(list(trainer.dev_loader.sampler.epoch_batches(0)))
    expect = expected_launches(trainer.config, trainer.state.step,
                               dev_batches * len(rows),
                               trainer.model.use_decoder)
    CV.write_lines(os.path.join(OUT_DIR, f"{LS100_FULL_NAME}_epochs.jsonl"),
                   rows)
    ckpt, best_epoch = CV.best_checkpoint(trainer)
    ckpt_dir = os.path.join(trainer.workdir, config.train.ckpt_dir)
    last = os.path.join(ckpt_dir, f"ckpt_{trainer.state.step}.pt")
    emit({"phase": "ls100_full_train", "epochs": len(rows),
          "epochs_shipped": epochs, "steps": trainer.state.step,
          "tpu_steps": steps, "train_s": round(train_s, 1),
          "evaluation": list(LS100_FULL_EVAL) or "as shipped",
          "launches": launches, "expected_launches": expect,
          "plain_calls": plain, "best_epoch": best_epoch,
          "best_dev_wer": trainer.best_wer, "world_size": trainer.world.size,
          "data_skipped": {"train": len(trainer.sampler.skipped),
                           "dev": len(trainer.dev_loader.sampler.skipped)},
          "card": card})
    check(trainer.state.step == steps and len(rows) == epochs,
          f"16: {trainer.state.step} steps of {steps}, {len(rows)} epochs of "
          f"{epochs}")
    check([(r["steps"], r["pad_waste"]) for r in rows]
          == list(zip(LS100_FULL_TPU["steps"], LS100_FULL_TPU["pad_waste"])),
          f"16: steps and pad waste by epoch differ from the TPU run's: "
          f"{[(r['steps'], r['pad_waste']) for r in rows]}")
    check(launches == expect, f"16: training launches {launches}, expected "
                              f"{expect}")
    check(not any(plain.values()), f"16: plain versions ran: {plain}")
    check(all(np.isfinite(r["loss_logged"]) for r in rows),
          "16: a non-finite loss")

    # the trained model's kernels on the first batch of each bucket
    firsts = {}
    for bucket, idxs in trainer.sampler.epoch_batches(0):
        firsts.setdefault(bucket, idxs)
    for bucket in sorted(firsts):
        b = trainer.loader.make_batch(bucket, firsts[bucket], epoch=0)
        sec = config.data.bucket_bounds_sec[bucket]
        errs, step_errs, (B, T0, T) = batch_kernel_checks(
            torch, trainer.config, trainer, b, f"ls100_full {sec} s", dev)
        emit({"phase": "ls100_full_kernels", "bucket": bucket, "seconds": sec,
              "B": B, "real": b.num_real, "T": T0, "T_enc": T,
              "errors": errs, "train_step": step_errs,
              "rounding_spread": step_spread(torch, trainer, dev, card),
              "card": card})
    del trainer

    # best.pt (and the last checkpoint where the cut evaluation picked
    # another epoch) by the config's beam over the 2,700, paired
    decoded = [("best", ckpt, best_epoch)]
    if LS100_FULL_EVAL and best_epoch != epochs - 1:
        decoded.append(("last", last, epochs - 1))
    for tag, path, epoch in decoded:
        out = os.path.join(OUT_DIR, LS100_FULL_NAME + (
            "" if tag == "best" else "_last") + ".jsonl")
        reset_counts()
        t0 = time.perf_counter()
        res = CV.decode_best(LS100_CONFIG, path, out, sets, "cuda")
        decode_s = time.perf_counter() - t0
        dec_launches, plain = read_counts()
        fwd = config.model.enc_layers * (res["num_batches"] + res["warm_passes"])
        check(dec_launches["bilstm_fwd"] == dec_launches["bilstm_fwd_cluster"]
              == dec_launches["bilstm_fwd_projection"] == fwd
              and not any(plain.values()),
              f"16 {tag}: the decode launched {dec_launches}, plain {plain}, "
              f"expected {fwd} K1-fwd launches")
        n_match = CV.refs_match(refs, CV.read_records(out))
        check(n_match == res["num_utts"] == LS100_FULL[1],
              f"16 {tag}: {n_match} of {res['num_utts']} decoded refs equal "
              "the dev set")
        stats = CV.compare(out, tpu)
        lo, hi = stats["wer_diff_ci95"]
        emit({"phase": "ls100_full", "ckpt": tag, "epoch": epoch,
              "decode": {k: res[k] for k in (
                  "method", "num_utts", "num_batches", "warm_passes", "wer",
                  "cer", "p50_latency_s", "beam_steps_total",
                  "beam_steps_max")},
              "beam": {k: getattr(config.decode, k) for k in (
                  "beam_size", "ctc_weight", "length_norm", "maxlen_ratio",
                  "ctc_score_candidates")},
              "decode_s": round(decode_s, 1), "k1_fwd_decode_launches": fwd,
              "tpu_record": os.path.relpath(tpu, REPO),
              "records": os.path.relpath(out, REPO), **stats,
              "verdict": ("tie" if lo <= 0.0 <= hi else "fault"
                          if lo > LS100_FULL_FAULT else "gap"),
              "fault_above": LS100_FULL_FAULT, "card": card})
    emit({"phase": "ls100_full_done", "measure_only": False,
          "seconds": round(time.perf_counter() - t_phase, 1)})


def library_timing(torch, config, shapes, dev, card):
    """The one PyTorch call that computes each kernel's function, timed on
    the same inputs beside it and never called by the port: cuDNN's
    bidirectional LSTM (packed by lengths; the forget bias +1 in b_ih) for
    K1-fwd (forward, summed over the 3 layer shapes) and K1-bwd (its
    backward alone); torch.addmm on bf16 operands for K1-fwd's projection
    (``bilstm_fwd_projection``); F.ctc_loss for K2 (forward) and K3
    (backward alone), on K2/K3's lattice, at the 4.0 s batch and (keys
    ``<name>_bench``) at bench.py's shape. K4 has none; K1-bwd's products
    are timed beside cuBLAS in products_timing."""
    import torch.nn.functional as F

    from gluon_e2e_asr_tpu_torch.tools.k1f_probe import proj_library

    H, B = config.model.enc_hidden, config.data.batch_size
    out = {"bilstm_fwd": 0.0, "bilstm_bwd": 0.0, "bilstm_fwd_projection": 0.0}
    for layer, T, D in shapes:
        x, lens, w_x, b_x, w_hf, w_hb = layer_inputs(torch, B, T, D, H, layer, dev)
        # K1-fwd's projection: x . W_x + b on bf16 operands, one addmm
        p_ms = time_ms(torch, proj_library(x, w_x, b_x))
        emit({"phase": "library_timing", "what": "addmm (K1-fwd projection)",
              "layer": layer, "B": B, "T": T, "D": D, "H": H,
              "dtype": "bfloat16", "ms": p_ms, "card": card})
        out["bilstm_fwd_projection"] += p_ms
        f_ms, b_ms = cudnn_lstm_ms(torch, x, lens, w_x, b_x, w_hf, w_hb, dev)
        emit({"phase": "library_timing", "what": "cudnn_lstm", "layer": layer,
              "B": B, "T": T, "D": D, "H": H, "dtype": "bfloat16",
              "fwd_ms": f_ms, "bwd_ms": b_ms, "card": card})
        out["bilstm_fwd"] += f_ms
        out["bilstm_bwd"] += b_ms

    b, tok, lens, T = bucket_batch(torch, config)
    rng = np.random.RandomState(SEED)
    logits = torch.from_numpy(
        rng.randn(b.audio.shape[0], T, tok.vocab_size).astype(np.float32) * 3)
    cases = {"": (logits, lens, torch.from_numpy(b.labels),
                  torch.from_numpy(b.label_len)),
             "_bench": bench_ctc_inputs(torch, config)}
    for sfx, (logits, lens, labels, label_lens) in cases.items():
        lp = torch.log_softmax(logits.to(dev), -1).transpose(0, 1).detach() \
            .requires_grad_(True)
        ctc = dict(targets=labels.to(dev).long(),
                   input_lengths=lens.to(dev).long(),
                   target_lengths=label_lens.to(dev).long(),
                   blank=0, reduction="none", zero_infinity=True)
        with torch.no_grad():
            out["ctc_alpha" + sfx] = time_ms(torch, lambda: F.ctc_loss(lp, **ctc))
        loss = F.ctc_loss(lp, **ctc).sum()
        out["ctc_beta_post" + sfx] = time_ms(
            torch, lambda: loss.backward(retain_graph=True))
        emit({"phase": "library_timing", "what": "F.ctc_loss",
              "shape": "bench.py" if sfx else "4.0 s bucket",
              "T": int(logits.shape[1]), "B": int(logits.shape[0]),
              "V": int(logits.shape[2]), "fwd_ms": out["ctc_alpha" + sfx],
              "bwd_ms": out["ctc_beta_post" + sfx], "card": card})
    return out


def cudnn_lstm_ms(torch, x, lens, w_x, b_x, w_hf, w_hb, dev):
    """cuDNN's bidirectional LSTM (``torch.nn.LSTM``, bf16, packed by
    lengths; K1's weights, the forget bias +1 in b_ih) on K1's layer
    inputs: (forward ms, backward ms alone), CUDA events."""
    from torch.nn.utils.rnn import pack_padded_sequence

    D, H = w_x.shape[0], w_hf.shape[0]
    bf = torch.bfloat16
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
    return f_ms, b_ms


# H100 SXM peaks (NVIDIA's data sheet, dense, at the 700 W limit).
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def fft_bound(torch, fc, shape, audio_len):
    """K5's and K6's bound on the FFT route's basis
    (``tools/fe_probe.py::fft_work``): its f32 operations on the CUDA
    cores against its bytes, the larger."""
    from gluon_e2e_asr_tpu_torch.tools.fe_probe import fft_work

    ops, nbytes = fft_work(fc, shape, audio_len)
    return _bound(0.0, PEAK_BF16, nbytes, ops)


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


def k1_layer_bounds(torch, B, T, D, H, layer, lens=None):
    """K1-fwd's (serving form) and K1-bwd's bounds at one layer shape, with
    ``lens`` (by default the lengths of ``layer_inputs``): see
    kernel_bounds."""
    f4, cd = 4, 2
    if lens is None:
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
    return {"bilstm_fwd": _bound(f_ops, PEAK_BF16, f_bytes),
            "bilstm_bwd": _bound(b_ops, PEAK_BF16, b_bytes)}


def ctc_bounds(lattice):
    """(K2's bound, K3's bound) on one lattice (real_ctc_batch's tuple):
    see kernel_bounds."""
    emit_, tmask, skip, svalid, label_lens = lattice
    T, Bc, S = emit_.shape
    live = float((tmask.T[:, :, None] & svalid[:, None, :]).sum())
    table = 4 * T * Bc * S
    masks = T * Bc + Bc * S * 2  # time_mask, allow_skip, state_valid
    return (_bound(10 * live, PEAK_F32, 2 * table + masks),
            _bound(12 * live, PEAK_F32, 3 * table + masks + 2 * 4 * Bc))


def kernel_bounds(config, shapes, dev, loc_config, m2_config):
    """name -> (bound_ms, bound_by): the least time the card could take
    for each timed call, from this run's inputs: the operations over the
    peak rate of their type (bf16 products for K1 and K4; f32 for the CTC
    recursions, about 10 operations a live lattice cell: 3 exp, 1 log, the
    max and the adds; K3 12), or each input read once and each output
    written once over the memory rate, whichever is larger. K2 and K3 at
    the 4.0 s batch and (``<name>_bench``) at bench.py's shape: the
    emission table in and alpha out (K3: emission and alpha in, post
    out), the time mask, allow_skip and state_valid (bytes), K3 also
    last_state and ll.

    Only what the TPU function reads and writes is counted, not the
    buffers the port saves for its own backward (K1's and K4's gate
    activations, K4's query, K4-bwd's score-gradient scratch). Inputs and
    products count the frames each row really has (padding is never
    needed); outputs count their whole size. Products take bf16 operands
    (2 bytes), as the timed calls do; states, residuals and gradients are
    f32. K1 sums its 3 layer shapes (K1-fwd in its serving form, as
    timed: y only; ``k1_layer_bounds``, which also bounds K1 at
    vgg_blstm's layer 0, D = 2560, in phase 6d). K1-fwd's recurrence alone (its own row, as timed):
    the bf16 products h . W_h of both directions over the live frames,
    against xg of the live frames (f32) and W_h in and y out. K1-fwd's
    projection (its own row, timed through its own entry):
    ``tools/k1f_probe.py::proj_work``, x . W_x, its forward half over
    every frame (the output holds it there) and its backward half over
    the live ones, against x (f32, as the entry takes it), W_x, b_x and
    lens in, xg [B,T,8H] (f32, every row) out; the xg write makes it
    bound by bytes in bf16. The f32 rows (K1's f32 projection and
    products at the milestones' layers) come from ``f32_timing``, with
    the operations at 67 TFLOP/s.
    K1-bwd's recurrence alone (its own row, as timed): the
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
    from gluon_e2e_asr_tpu_torch.tools.k1f_probe import proj_bound

    H, B = config.model.enc_hidden, config.data.batch_size
    f4, cd = 4, 2
    out = {}
    k1f = k1b = k1r = k1p = k1fr = k1fp = (0.0, "")
    for layer, T, D in shapes:
        lens = layer_inputs(torch, B, T, D, H, layer, "cpu")[1]
        frames = float(lens.sum())
        one = k1_layer_bounds(torch, B, T, D, H, layer)
        fb, bb = one["bilstm_fwd"], one["bilstm_bwd"]
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
        frb = _bound(fr_ops, PEAK_BF16, fr_bytes)
        fpb = proj_bound(lens.tolist(), T, D, H)
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

    for sfx, batch in (("", real_ctc_batch(torch, config, "cpu")),
                       ("_bench", bench_ctc_batch(torch, config, "cpu"))):
        out["ctc_alpha" + sfx], out["ctc_beta_post" + sfx] = ctc_bounds(batch)

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
    out["frontend_dft"] = _bound(0.0, PEAK_BF16, fe_bytes, fe_ops)
    out["frontend_k5"] = out["frontend_k6"] = fft_bound(
        torch, fc, sb["audio"].shape, sb["audio_len"])

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
    and the device's idle share of the window's wall time. The step's CTC
    kernels must be K2's and K3's warp kernels, one launch each a step."""
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
          # K2 and K3, wherever they rank
          "ctc": [{"kernel": k[:120], "ms_per_step": ms,
                   "launches_per_step": n, "share": ms / busy,
                   "share_of_wall": ms / wall}
                  for k, ms, n in rows if "ctc_" in k],
          "card": card})
    check(busy > 0, "the profiler saw no device time")
    ctc = sorted((k, n) for k, _, n in rows if "ctc_" in k)
    check(len(ctc) == 2 and all(n == 1 for _, n in ctc)
          and "ctc_alpha_warp_kernel" in ctc[0][0]
          and "ctc_beta_post_warp_kernel" in ctc[1][0],
          f"the step's CTC kernels are not one launch each of the warp "
          f"kernels: {ctc}")


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:
        dp_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--traces"]:
        trace_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--deterministic"]:
        deterministic_worker(sys.argv[2])
    elif sys.argv[1:2] == ["--only"]:
        sets = sys.argv[3:]
        if sets[::2] != ["--set"] * (len(sets) // 2) or len(sets) % 2:
            fail(f"usage: chip_smoke.py --only <ids> [--set key=value ...], "
                 f"got {sys.argv[1:]}")
        main(tuple(sys.argv[2].split(",")), tuple(sets[1::2]))
    else:
        main()
