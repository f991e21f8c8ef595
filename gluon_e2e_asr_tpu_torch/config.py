"""Typed configuration system.

The port's own copy of ``gluon_e2e_asr_tpu/config.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_data.py`` holds the
two to the same results. A config file means the same model in
both packages.

Reference-side realization: argparse + yaml scripts [SURVEY.md §2.1 #20,
INFERRED-med]. New-repo realization: typed dataclasses loaded from yaml,
one checked-in yaml per milestone config [BASELINE.json:L6-L12].
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple


@dataclass
class DataConfig:
    """L0 data pipeline [BASELINE.json:L2,L5,L10]."""

    dataset: str = "synthetic"  # "synthetic" | "librispeech"
    data_dir: str = "testdata"
    train_manifest: str = ""
    dev_manifest: str = ""
    sample_rate: int = 16000
    # Label units [SURVEY.md §2.1 #2]: "char" (fixed alphabet) or "bpe"
    # (subword merges learned from the train transcripts at startup,
    # serialized into the checkpoint meta; decode restores them from
    # there). BPE shortens label sequences and is the customary unit for
    # LibriSpeech recipes in this model family; beam decode at BPE vocab
    # sizes requires decode.ctc_score_candidates > 0 (partial CTC scoring).
    tokenizer: str = "char"
    bpe_vocab_size: int = 256  # total ids incl. specials + single chars
    # Host->device audio dtype: "float32" (default) or "int16" (PCM16
    # device-transfer mode). Audio is 16-bit on disk; int16 ships those
    # samples verbatim and the frontend reconstructs f32 on device
    # (* 2^-15 — bitwise-identical to the float32 pipeline for 16-bit
    # sources when speed_perturb is off; perturbed train rows re-quantize
    # with error <= 0.5/32768). Halves H2D bytes per step — and on hosts
    # whose device plugin retains transfer staging buffers (measured on
    # this box: ~1:1 with payload), halves the resident-host-memory
    # growth that OOM'd the first 100 h rehearsal run at epoch 4.
    transfer_dtype: str = "float32"
    # Synthetic dataset knobs (no LibriSpeech on this machine; SURVEY §0).
    synth_num_train: int = 64
    synth_num_dev: int = 16
    synth_min_tokens: int = 3
    synth_max_tokens: int = 12
    synth_seed: int = 1234
    # Transcript language for the synthetic fixture: "random" (uniform
    # character draws — linguistically null) or "english" (word windows
    # from the checked-in English pool, data/english_pool.txt), which is
    # what LM-fusion/BPE/rescoring experiments need to show signal
    # [VERDICT.md round-2 item 1]. Both modes bound the transcript's
    # CHARACTER length by synth_min_tokens/synth_max_tokens.
    synth_text: str = "random"
    # Train/dev text disjointness for the english fixture: "none" draws
    # both splits from the full sentence pool (round-3 behavior — dev
    # windows could appear verbatim in train text, inflating quality
    # numbers by an unquantified amount [VERDICT.md round-3 weak #1]);
    # "sentence" hash-partitions the pool into disjoint train/dev
    # sentence sets (manifest.english_pool_split) and additionally
    # rejects dev windows occurring anywhere in the train-side text —
    # measured-zero leakage. Normative quality configs use "sentence".
    synth_split: str = "none"
    # Additive white-noise std in the synthetic waveforms (tone amplitude
    # ~0.6). The 0.003 default is near-clean (~46 dB SNR); quality
    # experiments raise it so the base WER has headroom for LM fusion /
    # rescoring to show signal (ceiling-effect guard).
    synth_noise: float = 0.003
    # Per-character frequency jitter std (multiplicative). Adjacent
    # character tones are ~6% apart mid-range; ~0.03+ makes neighbors
    # acoustically confusable — the substitution-error model a language
    # model can fix. White noise alone is integrated away by the
    # mel+LSTM processing gain (measured: dev WER ~2% even at
    # synth_noise=0.30), so THIS is the knob that sets the error floor.
    synth_jitter: float = 0.01
    # Bucketed batching: static bucket shapes so each bucket hits a cached
    # XLA compilation [BASELINE.json:L5 "bucketed padding"].
    bucket_bounds_sec: Tuple[float, ...] = (2.0, 4.0, 8.0, 16.0)
    batch_size: int = 16
    # If >0, scale per-bucket batch size so batch_size*max_len is ~constant
    # (bounds padding-FLOP waste across buckets).
    dynamic_batch: bool = False
    max_label_len: int = 320
    shuffle: bool = True
    drop_last: bool = False
    # Speed perturbation (the reference family's standard LibriSpeech
    # augmentation, classically offline 0.9/1.0/1.1 copies): per utterance
    # and per epoch, one factor is drawn and the waveform is resampled by
    # it ON THE FLY on the host (train split only; linear interpolation,
    # factor f scales pitch/tempo by f and duration by 1/f). Deterministic
    # in (train.seed, epoch, utterance) so mid-epoch resume replays the
    # same draws. Bucket placement reserves room for the slowest factor,
    # keeping bucket shapes static. Empty tuple = off.
    speed_perturb: Tuple[float, ...] = ()
    # Bucket placement when speed_perturb is on. Default (False): the
    # sampler re-places each utterance per epoch by the duration its
    # deterministic factor draw actually produces ("realized" placement —
    # no worst-case headroom, measured pad-waste 0.232 -> 0.118 at the
    # 100 h scale). True restores the pre-round-5 static placement
    # (assign once by duration/min(factor) worst case) — the control arm
    # of the BASELINE.md bucket-retune A/B, and an escape hatch if a
    # corpus interacts badly with per-epoch re-bucketing.
    static_placement: bool = False
    # SortaGrad (the reference family's curriculum knob): run the first N
    # epochs shortest-utterance-first with no shuffle, then switch to the
    # normal per-epoch shuffle. Stabilizes early CTC training on real
    # corpora; 0 = off.
    sortagrad_epochs: int = 0
    # Host/device overlap: batches ahead to assemble in a background
    # thread while the device steps (0 = synchronous). On an on-disk
    # corpus the C++ read+decode+pack otherwise serializes with the step
    # [VERDICT.md round-1 item 4 "host/device overlap"].
    prefetch_depth: int = 2


@dataclass
class FrontendConfig:
    """L1 acoustic frontend [BASELINE.json:L5,L8]."""

    sample_rate: int = 16000
    win_length: int = 400  # 25 ms @ 16 kHz
    hop_length: int = 160  # 10 ms @ 16 kHz
    n_fft: int = 512
    n_mels: int = 80
    fmin: float = 0.0
    fmax: Optional[float] = None  # default sample_rate / 2
    log_floor: float = 1e-10
    # CMVN [BASELINE.json:L5]: "global" stats file or "utterance" level.
    cmvn: str = "utterance"  # "global" | "utterance" | "none"
    # npz with arrays {mean, std}, produced by tools/compute_cmvn.py;
    # required when cmvn == "global".
    cmvn_stats_path: str = ""
    # SpecAugment (train only) [BASELINE.json:L5,L8].
    specaug_freq_masks: int = 2
    specaug_freq_width: int = 27
    specaug_time_masks: int = 2
    specaug_time_width: int = 40
    # Delta features (the Kaldi-era add-deltas stage): 0 = static
    # log-mel only, 1 = +Δ, 2 = +Δ+ΔΔ. Output dim = n_mels*(1+deltas).
    # Computed on device from the CMVN-normalized statics with the
    # standard regression formula over ``delta_window`` neighbors,
    # edge-replicated within each utterance's valid frames (Kaldi
    # semantics). Shared post-stage of both frontend impls.
    deltas: int = 0
    delta_window: int = 2
    # Implementation selector: "jnp" (composed XLA) | "pallas" (fused
    # kernel, grid over batch) | "pallas_regrid" (fused kernel, grid
    # over frame chunks — DESIGN.md TODO 1). frontend_apply validates
    # this and raises on unknown values [ADVICE.md round-4 #2].
    impl: str = "jnp"


@dataclass
class ModelConfig:
    """L3 models [BASELINE.json:L7,L9]."""

    # Encoder type: "blstm" (stacked pyramidal BiLSTM, the default) or
    # "vggblstm" (VGG2L conv front + BiLSTM stack — the hybrid
    # CTC/attention family's other standard encoder [SURVEY.md §2.1 #8,
    # INFERRED-med for the conv variant]). The VGG front is two stages
    # of (3x3 conv + ReLU) x2 followed by 2x2 max-pool, i.e. a fixed 4x
    # time reduction; vggblstm recipes therefore usually set
    # enc_subsample to all 1s. Convs are plain MXU-tiled XLA convolutions
    # (NHWC, compute_dtype) — no custom kernel needed.
    enc_type: str = "blstm"
    # VGG2L stage output channels (two pool stages).
    vgg_channels: Tuple[int, ...] = (64, 128)
    # Input channels for the conv front: 1 for static log-mel; set to
    # 1 + frontend.deltas when delta features are enabled (the deltas
    # post-stage concatenates [static | d | dd] along the feature axis,
    # which the VGG front unstacks into channels).
    vgg_in_channels: int = 1
    # Encoder: stacked BiLSTM with pyramidal time subsampling.
    enc_hidden: int = 320
    enc_layers: int = 3
    # Per-layer time-subsampling factors (frame-pair concat), e.g. (1, 2, 2)
    # gives 4x total reduction.
    enc_subsample: Tuple[int, ...] = (1, 2, 2)
    enc_dropout: float = 0.0
    # Decoder (LAS-style attention encoder-decoder) [BASELINE.json:L9].
    dec_hidden: int = 320
    dec_layers: int = 1
    dec_embed: int = 256
    att_dim: int = 320
    att_type: str = "loc"  # "dot" | "add" | "loc" (location-aware)
    loc_conv_channels: int = 10
    loc_conv_width: int = 100
    # Compute dtype for matmuls ("bfloat16" rides the MXU; params stay fp32).
    compute_dtype: str = "float32"
    # Rematerialize encoder LSTM scans in the backward pass: trades FLOPs
    # for activation memory on long buckets [SURVEY.md §5 long-context].
    remat: bool = False
    # Recurrent loop implementation: "scan" (lax.scan baseline) or
    # "pallas" (VMEM-resident-weight kernel, ops/pallas_lstm.py).
    lstm_impl: str = "scan"
    # Pallas-kernel time chunk. Rounded DOWN to a multiple of 8 with a
    # floor of 8 (Mosaic second-minor tiling), and clamped further down
    # when the backward kernel would exceed the VMEM budget; values < 8
    # are raised with a one-time warning (ops/pallas_lstm.py).
    lstm_time_chunk: int = 16
    # Teacher-forced decoder implementation: "scan" (lax.scan baseline)
    # or "pallas" (fused per-step kernel + mirrored backward,
    # ops/pallas_decoder.py). "pallas" silently falls back to scan when
    # the shape is unsupported (dec_layers > 1, att_type "dot", or over
    # the VMEM budget).
    dec_impl: str = "scan"


def encoder_time_reduction(model: "ModelConfig") -> int:
    """Total frontend-frame -> encoder-frame time reduction factor.

    prod(enc_subsample) times the VGG front's fixed 2x-per-pool-stage
    reduction when enc_type == "vggblstm". Timestamp consumers
    (transcribe --timestamps, tools/align.py) use this to convert
    encoder-frame indices to seconds.
    """
    # Only the first enc_layers factors are applied by the layer loop in
    # BiLSTMEncoder (extra entries are never consumed) — slice to match,
    # so timestamp math agrees with the model for over-long subsample
    # lists [ADVICE.md round-2 #1].
    r = 1
    for f in model.enc_subsample[: model.enc_layers]:
        r *= int(f)
    if model.enc_type == "vggblstm":
        r *= 2 ** len(model.vgg_channels)
    return r


@dataclass
class LossConfig:
    """L2 losses [BASELINE.json:L5,L9,L10]."""

    # Joint hybrid objective: L = mtl_alpha * L_ctc + (1 - mtl_alpha) * L_att
    # [SURVEY.md §2.1 #13, INFERRED-high for form].
    mtl_alpha: float = 0.3
    label_smoothing: float = 0.1
    # Scheduled sampling probability of feeding model's own argmax
    # prediction instead of the gold token [BASELINE.json:L9]. This is
    # the FINAL (target) probability; with a warmup it is reached by a
    # linear per-optimizer-step ramp from 0 (the ESPnet-v0-era family
    # ramps the sampling ratio rather than fixing it, SURVEY.md §2.1 #12).
    scheduled_sampling: float = 0.0
    # Ramp length in optimizer steps: effective prob at step s is
    # scheduled_sampling * min(s / warmup, 1). 0 = constant (no ramp).
    scheduled_sampling_warmup_steps: int = 0


@dataclass
class TrainConfig:
    """L4 training engine [BASELINE.json:L5,L10]."""

    seed: int = 0
    num_epochs: int = 10
    max_steps: int = -1  # if >0, stop after this many optimizer steps
    # "adam"/"adamw" (optax.adamw + warmup->inv-sqrt LR; both names take
    # the same path — with the default weight_decay=0.0 it is exactly
    # plain Adam, and any weight_decay > 0 is applied DECOUPLED
    # (AdamW-style), which deviates from the reference family's L2-coupled
    # "adam" [VERDICT.md round-2 weak 7]), "sgd" (momentum 0.9), or
    # "adadelta" — the reference family's classic RNN-ASR optimizer
    # (run it ESPnet-style: learning_rate 1.0, warmup_steps 0, with the
    # plateau eps decay below).
    optimizer: str = "adam"
    learning_rate: float = 1e-3
    warmup_steps: int = 100
    weight_decay: float = 0.0
    grad_clip_norm: float = 5.0
    # Adadelta hyperparameters (optimizer == "adadelta" only).
    adadelta_rho: float = 0.95
    adadelta_eps: float = 1e-8
    # Plateau eps decay (the family's criterion-based annealing): after
    # an epoch with NO new best dev WER, multiply adadelta's eps by this
    # factor (classically 0.01 — smaller eps = smaller steps). The
    # decayed value lives in the optimizer state, so checkpoints carry
    # it and resume continues at the annealed setting. 0 = off.
    eps_decay: float = 0.0
    # Anneal only after this many CONSECUTIVE no-best epochs (and again
    # after each further full window). 1 = every plateau epoch — the
    # classic behavior, appropriate when an epoch is many thousands of
    # steps; on small corpora/epochs use a larger patience so one noisy
    # eval can't cascade the 100x decays (a measured every-epoch cascade
    # froze then NaN'd a 32-step-epoch run; see BASELINE.md).
    eps_decay_patience: int = 1
    # On annealing epochs, additionally reload model params from the
    # best checkpoint before continuing (the family's
    # restore-then-anneal recipe); optimizer accumulators are kept.
    plateau_restore_best: bool = False
    # Gradient accumulation (the reference family's accum_grad knob):
    # sum num_real-weighted gradients over this many consecutive batches
    # and apply ONE optimizer update with their global mean — numerically
    # the update a single batch of the combined size would take (exact up
    # to float summation order; tests/test_accum.py). step / max_steps /
    # LR schedule / checkpoints all count OPTIMIZER steps, and
    # checkpoints only land on accumulation boundaries so mid-epoch
    # resume stays bitwise-exact. 1 = off.
    accum_grad_steps: int = 1
    # Early stopping (the reference family's `patience` knob): stop
    # training after this many consecutive epochs without a new best
    # dev WER. 0 = off (run all num_epochs). The best checkpoint is
    # tracked either way (best.msgpack symlink).
    early_stop_patience: int = 0
    # Data parallelism over ICI [BASELINE.json:L5,L10].
    dp: bool = False
    # DP mechanism: "shard_map" (explicit per-shard program + psum(grads);
    # keeps Pallas kernels shard-local on real multi-chip meshes) or
    # "pjit" (sharding annotations; XLA chooses the partitioning around
    # custom calls) [SURVEY.md §2.3; docs/ROADMAP.md #2].
    dp_impl: str = "shard_map"
    # Checkpointing / metrics.
    ckpt_dir: str = "ckpts"
    keep_ckpts: int = 3
    # Retention policy: "last" keeps the most recent keep_ckpts (+ best
    # symlink target); "best" keeps the keep_ckpts LOWEST-dev-WER epochs
    # (+ the newest, which resume needs) — use with
    # tools/average_ckpts.py, whose pool last-K retention late-biases
    # [VERDICT.md round-2 item 7].
    keep_policy: str = "last"
    ckpt_every_steps: int = 0  # 0 = epoch boundary only
    metrics_path: str = "metrics.jsonl"
    log_every_steps: int = 10
    # Profiling [SURVEY.md §5 tracing]: trace steps [start, stop) to dir.
    profile_dir: str = ""
    profile_start_step: int = 10
    profile_num_steps: int = 5
    remat_encoder: bool = False
    # CI/test mode: fail fast on NaNs anywhere in the jitted step
    # [SURVEY.md §5 race-detection analogue].
    debug_nans: bool = False


@dataclass
class DecodeConfig:
    """L5 decoding [BASELINE.json:L7,L11]."""

    # "greedy" (framewise CTC argmax+collapse), "beam" (joint
    # CTC/attention beam — needs the attention decoder), or "ctc_beam"
    # (decoder-free label-synchronous CTC prefix beam: every extension
    # ranked by its EXACT prefix probability, finalization scored by the
    # full CTC likelihood; serves CTC-only models and composes with
    # decode.lm_weight fusion and the shared beam knobs below).
    method: str = "greedy"
    beam_size: int = 10
    # Joint score weight: score = ctc_weight * ctc_prefix + (1-w) * att.
    ctc_weight: float = 0.3
    # Max output length as a ratio of encoder frames.
    maxlen_ratio: float = 0.5
    minlen_ratio: float = 0.0
    # Length normalization at finalization [BASELINE.json:L11].
    length_norm: bool = True
    # Token insertion penalty (the reference family's beam knob): every
    # emitted token adds `penalty` to the hypothesis score, i.e.
    # score(h) += penalty * |h|. Positive favors longer hypotheses
    # (counteracting the short-hypothesis bias of pure log-prob sums);
    # 0 = off. Applied before length normalization — which makes it
    # nearly a no-op when length_norm is true (the /|h| turns the term
    # into an almost-constant offset): penalty and length_norm are two
    # remedies for the SAME bias, so pick one (the decoder warns if
    # both are set).
    penalty: float = 0.0
    # CTC prefix scores are maintained per (beam, extension-token) over
    # encoder time — [T, B, K, V, 2] floats with full-vocab scoring, which
    # is fine at char vocab but blows up at BPE sizes. With
    # ctc_score_candidates = N > 0, only the top-N tokens by attention
    # log-prob per beam are CTC-scored ([T, B, K, N, 2]) and continuations
    # are restricted to them (ESPnet-style partial scoring; pre-beam
    # N ≈ 1.5–2× beam_size is customary). 0 = full-vocab scoring, which
    # refuses vocabs > 512 (set N instead).
    ctc_score_candidates: int = 0
    # Data-parallel decode: shard the batch axis over all devices
    # (shard_map, params replicated, no collectives). Requires
    # data.batch_size divisible by the device count.
    dp: bool = False
    # Beam only: emit the top-N finished hypotheses per utterance
    # (clamped to beam_size). 1 = classic 1-best records; >1 adds an
    # "nbest" list to each decode JSONL record.
    nbest: int = 1
    # End detection (Watanabe-style heuristic early stop, OFF by
    # default = exact search): a sample stops expanding once
    # `end_detect_m` consecutive output lengths produced no finalized
    # hypothesis within `end_detect_d` RAW log-prob of its best
    # finished one. Shaves beam latency on confident models; the
    # margin is on unnormalized scores (length_norm plays no role).
    end_detect: bool = False
    end_detect_m: int = 3
    end_detect_d: float = 10.0
    # External-LM shallow fusion (beam only): adds
    # lm_weight * log p_lm(token) to the joint score — the third term
    # of the Watanabe-style hybrid decoding objective [SURVEY.md §2.1
    # #17]. 0.0 = off (the default decode is bit-identical without an
    # LM). lm_ckpt points at a train_lm.py checkpoint; its vocab
    # fingerprint is checked against the decode tokenizer.
    lm_weight: float = 0.0
    lm_ckpt: str = ""
    output_path: str = "decode.jsonl"


@dataclass
class LMConfig:
    """External LSTM LM for shallow fusion (``train_lm.py``). Trains on
    the transcript text of the configured dataset's train manifest —
    text-only, no audio touched [SURVEY.md §2.1 #17; INFERRED-med:
    fusion ships off by default, see DecodeConfig.lm_weight]."""

    embed_dim: int = 256
    hidden: int = 512
    layers: int = 2
    # Optional extra text corpus: one sentence per line, appended to the
    # manifest transcripts (the reference family trains char LMs on much
    # more text than the paired audio has).
    extra_text: str = ""
    # Token buffer: sentences are padded/truncated to this many input
    # positions (incl. sos) so every batch hits one compiled shape.
    max_len: int = 128
    batch_size: int = 64
    num_epochs: int = 20
    learning_rate: float = 1e-3
    warmup_steps: int = 50
    grad_clip_norm: float = 5.0
    seed: int = 0
    ckpt_path: str = "lm/lm.msgpack"


@dataclass
class Config:
    data: DataConfig = field(default_factory=DataConfig)
    frontend: FrontendConfig = field(default_factory=FrontendConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    decode: DecodeConfig = field(default_factory=DecodeConfig)
    lm: LMConfig = field(default_factory=LMConfig)
    name: str = "default"

    def to_dict(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    def fingerprint(self) -> str:
        """Stable hash of the config, stored in checkpoints."""
        import hashlib

        blob = json.dumps(self.to_dict(), sort_keys=True, default=str)
        return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _coerce_typed(fld: dataclasses.Field, v):
    """Coerce a parsed yaml scalar toward the field's default type.

    YAML 1.1 parses ``1e-10`` as a STRING (the spec wants ``1.0e-10``),
    so a hand-written ``log_floor: 1e-10`` would otherwise flow into
    jnp ops as a str and fail deep inside a trace. Also normalizes
    yaml ints into float fields (``0`` for ``0.0``)."""
    d = fld.default
    if d is dataclasses.MISSING:
        return v
    if isinstance(d, bool):
        if isinstance(v, str) and v.lower() in ("true", "false"):
            return v.lower() == "true"
        return v
    try:
        if isinstance(d, float) and isinstance(v, (str, int)):
            return float(v)
        if isinstance(d, int) and isinstance(v, str):
            return int(v)
        if isinstance(d, tuple) and isinstance(v, tuple) and d:
            elem = d[0]
            if isinstance(elem, float):
                return tuple(float(x) for x in v)
            if isinstance(elem, int) and not isinstance(elem, bool):
                return tuple(int(x) for x in v)
    except (ValueError, TypeError):
        pass
    return v


def _coerce(dc_type, value):
    """Build a dataclass from a plain dict, recursing into nested fields."""
    if value is None:
        return dc_type()
    if not isinstance(value, dict):
        raise TypeError(f"expected dict for {dc_type.__name__}, got {type(value)}")
    kwargs = {}
    fields = {f.name: f for f in dataclasses.fields(dc_type)}
    for k, v in value.items():
        if k not in fields:
            raise KeyError(f"unknown config key {dc_type.__name__}.{k}")
        if isinstance(v, list):
            v = tuple(v)
        kwargs[k] = _coerce_typed(fields[k], v)
    return dc_type(**kwargs)


def load_config(path: str) -> Config:
    """Load a yaml (or json) config file into a typed Config."""
    with open(path) as f:
        text = f.read()
    raw = _parse_yaml(text)
    return config_from_dict(raw)


def apply_overrides(config: Config, overrides) -> Config:
    """Apply dotted CLI overrides, e.g. ``model.att_type=dot``,
    ``data.batch_size=96``, ``train.dp=true``,
    ``data.bucket_bounds_sec=[2.0,4.0]`` — values parse with the same
    scalar rules as the yaml loader. Mutates and returns ``config``.
    Unknown keys raise (same strictness as the yaml path)."""
    for item in overrides or ():
        key, sep, val = item.partition("=")
        if not sep:
            raise ValueError(f"--set expects key=value, got {item!r}")
        parts = key.strip().split(".")
        obj = config
        for part in parts[:-1]:
            if not hasattr(obj, part):
                raise KeyError(f"unknown config section {part!r} in {key!r}")
            obj = getattr(obj, part)
        leaf = parts[-1]
        if not hasattr(obj, leaf):
            raise KeyError(f"unknown config key {key!r}")
        parsed = _parse_scalar(val.strip())
        if isinstance(parsed, list):
            parsed = tuple(parsed)
        setattr(obj, leaf, parsed)
    return config


def config_from_dict(raw: Dict[str, Any]) -> Config:
    sub = {
        "data": DataConfig,
        "frontend": FrontendConfig,
        "model": ModelConfig,
        "loss": LossConfig,
        "train": TrainConfig,
        "decode": DecodeConfig,
        "lm": LMConfig,
    }
    kwargs: Dict[str, Any] = {}
    for k, v in (raw or {}).items():
        if k in sub:
            kwargs[k] = _coerce(sub[k], v)
        elif k == "name":
            kwargs[k] = v
        else:
            raise KeyError(f"unknown top-level config key: {k}")
    return Config(**kwargs)


def _parse_yaml(text: str) -> Dict[str, Any]:
    """Parse config yaml. Uses PyYAML when available, else a minimal parser
    sufficient for our two-level key: value config files (no external deps)."""
    try:
        import yaml  # type: ignore

        return yaml.safe_load(text) or {}
    except ImportError:
        pass
    root: Dict[str, Any] = {}
    stack: List[Tuple[int, Dict[str, Any]]] = [(0, root)]
    for line in text.splitlines():
        stripped = line.split("#", 1)[0].rstrip()
        if not stripped.strip():
            continue
        indent = len(stripped) - len(stripped.lstrip())
        key, _, val = stripped.strip().partition(":")
        while stack and indent < stack[-1][0]:
            stack.pop()
        cur = stack[-1][1]
        val = val.strip()
        if not val:
            child: Dict[str, Any] = {}
            cur[key] = child
            stack.append((indent + 1, child))
        else:
            cur[key] = _parse_scalar(val)
    return root


def _parse_scalar(val: str) -> Any:
    if val.startswith("[") and val.endswith("]"):
        inner = val[1:-1].strip()
        if not inner:
            return []
        return [_parse_scalar(x.strip()) for x in inner.split(",")]
    low = val.lower()
    if low in ("true", "yes"):
        return True
    if low in ("false", "no"):
        return False
    if low in ("null", "none", "~"):
        return None
    for cast in (int, float):
        try:
            return cast(val)
        except ValueError:
            continue
    return val.strip("'\"")
