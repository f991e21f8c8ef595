"""PyTorch port: the train CLI on the CPU (plain versions of every
kernel), its checkpoints, and the options that are not ported yet.

A CTC-only run of the tiny golden config (``loss.mtl_alpha=1.0``)
trains past one epoch end (dev evaluation, ``epoch`` line, best
checkpoint) and stops mid-epoch at ``--max-steps``; its checkpoint
decodes through the port's decode CLI. A hybrid run of the same config
as shipped (``mtl_alpha`` 0.5, an add-attention decoder) with
scheduled sampling takes a few steps and logs the attention loss and
accuracy; so do a dot- and a location-aware run, and a location-aware run
past an epoch end evaluates with the config's beam. (The CTC-only runs
evaluate greedily: a model without a decoder has no beam.) One CTC-only and one hybrid run
happen in a process where importing jax, flax or the JAX package fails.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from gluon_e2e_asr_tpu_torch import decode, train
from gluon_e2e_asr_tpu_torch.training.checkpoint import _prune

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = os.path.join(REPO, "tests", "goldens", "tiny_golden.yaml")
# The keys of the JAX trainer's "train" lines (training/trainer.py there).
TRAIN_KEYS = {"event", "step", "epoch", "bucket", "loss", "loss_ctc",
              "loss_att", "att_acc", "grad_norm", "utt_per_sec_per_chip",
              "tokens_per_sec", "ts"}


def _train_args(workdir, steps, *extra, ctc_only=True):
    """The CLI's arguments. A CTC-only model has no decoder for the
    config's beam, so its dev evaluation decodes greedily (the JAX trainer
    refuses a CTC-only model with decode.method beam, as the port does)."""
    args = ["--config", CONFIG, "--workdir", str(workdir), "--max-steps",
            str(steps), "--device", "cpu", "--set", "train.log_every_steps=1"]
    if ctc_only:
        args += ["--set", "loss.mtl_alpha=1.0", "--set", "decode.method=greedy"]
    return args + list(extra)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("train")
    trainer = train.main(_train_args(workdir, 5))
    with open(workdir / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    return workdir, trainer, lines


def test_metrics_lines(run):
    _, trainer, lines = run
    steps = [r for r in lines if r["event"] == "train"]
    assert [r["step"] for r in steps] == [1, 2, 3, 4, 5]
    for r in steps:
        assert set(r) == TRAIN_KEYS
        assert r["loss"] > 0 and r["loss_att"] == 0.0
    epochs = [r for r in lines if r["event"] == "epoch"]
    assert len(epochs) == 1 and epochs[0]["step"] == 4  # 32 utts / batch 8
    assert 0.0 <= epochs[0]["dev_cer"] and "dev_wer" in epochs[0]
    assert trainer.state.step == 5


def test_checkpoints_hold_the_optimizer_state(run):
    workdir, trainer, _ = run
    ckpts = workdir / trainer.config.train.ckpt_dir
    assert sorted(p.name for p in ckpts.iterdir()) == [
        "best.pt", "best.pt.json", "ckpt_4.pt", "ckpt_4.pt.json", "ckpt_5.pt",
        "ckpt_5.pt.json"]
    assert os.readlink(ckpts / "best.pt") == "ckpt_4.pt"
    payload = torch.load(ckpts / "ckpt_5.pt", weights_only=True)
    assert payload["step"] == 5 and payload["opt_state"]["count"] == 5
    params = payload["params"]
    assert set(payload["opt_state"]["mu"]) == set(params)
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(params[k], v)
    with open(ckpts / "ckpt_5.pt.json") as f:
        meta = json.load(f)
    assert meta["step"] == 5 and meta["batches_done"] == 1 and meta["vocab"]


def test_checkpoint_decodes_through_the_port(run, tmp_path):
    workdir, trainer, _ = run
    ckpt = str(workdir / trainer.config.train.ckpt_dir / "ckpt_5.pt")
    result = decode.main(["--config", CONFIG, "--ckpt", ckpt, "--method",
                          "greedy", "--output", str(tmp_path / "d.jsonl"),
                          "--device", "cpu"])
    assert result["num_utts"] == 16


@pytest.mark.parametrize("att_type", ["add", "dot", "loc"])
def test_hybrid_training_runs(tmp_path, att_type):
    trainer = train.main(_train_args(
        tmp_path, 3, "--set", f"model.att_type={att_type}", "--set",
        "loss.scheduled_sampling=0.5", ctc_only=False))
    assert trainer.model.use_decoder and trainer.state.step == 3
    with open(tmp_path / "metrics.jsonl") as f:
        steps = [json.loads(line) for line in f]
    steps = [r for r in steps if r["event"] == "train"]
    assert [r["step"] for r in steps] == [1, 2, 3]
    for r in steps:
        assert set(r) == TRAIN_KEYS
        assert r["loss_att"] > 0 and 0.0 <= r["att_acc"] <= 1.0
    payload = torch.load(tmp_path / trainer.config.train.ckpt_dir / "ckpt_3.pt",
                         weights_only=True)
    assert any(k.startswith("decoder.") for k in payload["params"])


def test_hybrid_training_evaluates_with_the_beam(tmp_path):
    """A location-aware run past one epoch end: the dev evaluation follows
    the config's decode.method (beam, K=4) and logs WER and CER."""
    trainer = train.main(_train_args(
        tmp_path, 4, "--set", "model.att_type=loc", ctc_only=False))
    assert trainer._beam is not None and trainer.greedy is None
    with open(tmp_path / "metrics.jsonl") as f:
        epochs = [r for r in map(json.loads, f) if r["event"] == "epoch"]
    assert len(epochs) == 1 and epochs[0]["step"] == 4
    assert 0.0 <= epochs[0]["dev_cer"] and 0.0 <= epochs[0]["dev_wer"]


def _train_without_jax(tmp_path, ctc_only, args=None, check=""):
    """Three steps through the CLI (``args``, or the tiny config's) in a
    process where importing jax, flax or the JAX package fails; ``check``
    runs after them."""
    args = args or _train_args(tmp_path, 3, ctc_only=ctc_only)
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'gluon_e2e_asr_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from gluon_e2e_asr_tpu_torch import train\n"
        f"t = train.main({args!r})\n"
        "assert t.state.step == 3\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        + check
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert (tmp_path / "metrics.jsonl").exists()


def test_train_runs_without_jax(tmp_path):
    _train_without_jax(tmp_path, ctc_only=True)


def test_hybrid_train_runs_without_jax(tmp_path):
    _train_without_jax(tmp_path, ctc_only=False)


@pytest.mark.parametrize("impl", ["pallas", "pallas_regrid"])
def test_milestone2_trains_without_jax(tmp_path, impl):
    """configs/milestone2_fused_frontend.yaml as shipped (the fused
    frontend, utterance CMVN, CTC only, greedy), on a small synthetic
    split and a narrow encoder: three steps past an epoch end, every
    frontend call through the fused impl's plain version on the CPU."""
    args = ["--config", os.path.join(REPO, "configs",
                                     "milestone2_fused_frontend.yaml"),
            "--workdir", str(tmp_path), "--max-steps", "3", "--device", "cpu",
            "--set", f"frontend.impl={impl}", "--set", "data.synth_num_train=16",
            "--set", "data.synth_num_dev=8", "--set", "data.batch_size=8",
            "--set", "model.enc_hidden=16", "--set", "train.log_every_steps=1"]
    check = (
        "from gluon_e2e_asr_tpu_torch.frontend import fused\n"
        f"plain = fused.compute_features_{impl}_plain.calls\n"
        f"assert t.config.frontend.impl == {impl!r} and plain >= 3, plain\n"
    )
    _train_without_jax(tmp_path, True, args, check)
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert [r["step"] for r in lines if r["event"] == "train"] == [1, 2, 3]
    assert any(r["event"] == "epoch" for r in lines)


@pytest.mark.parametrize("override,match", [
    ("train.dp=true", "Data parallelism"),
    ("train.accum_grad_steps=2", "accumulation"),
    ("train.eps_decay=0.01", "plateau"),
    ("train.plateau_restore_best=true", "plateau"),
    ("train.early_stop_patience=2", "early stopping"),
    ("train.ckpt_every_steps=10", "ckpt_every_steps"),
    ("train.profile_dir=prof", "profiling"),
    ("train.optimizer=adadelta", "adadelta"),
    # Hybrid training is ported in every attention mode; K4 takes one
    # decoder layer.
    pytest.param("loss.mtl_alpha=0.5,model.dec_layers=2", "K4",
                 id="loss.mtl_alpha=0.5-K4"),
])
def test_unported_options_raise(tmp_path, override, match):
    sets = [a for o in override.split(",") for a in ("--set", o)]
    with pytest.raises(NotImplementedError, match=match):
        train.main(_train_args(tmp_path, 1, *sets))


def test_resume_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        train.main(_train_args(tmp_path, 1, "--resume"))


def _fake_ckpts(d, wers):
    for step, w in wers.items():
        (d / f"ckpt_{step}.pt").write_bytes(b"x")
        meta = {} if w is None else {"dev_wer": w}
        (d / f"ckpt_{step}.pt.json").write_text(json.dumps(meta))


def test_prune_last_keeps_the_newest_and_the_best(tmp_path):
    _fake_ckpts(tmp_path, {1: 0.5, 2: 0.4, 3: 0.6, 4: 0.7})
    os.symlink("ckpt_1.pt", tmp_path / "best.pt")
    _prune(str(tmp_path), 2, "last")
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pt")) == [
        "ckpt_1.pt", "ckpt_3.pt", "ckpt_4.pt"]


def test_prune_best_keeps_the_lowest_wer_and_the_newest(tmp_path):
    _fake_ckpts(tmp_path, {1: 0.5, 2: 0.4, 3: 0.6, 4: None})
    _prune(str(tmp_path), 2, "best")
    assert sorted(p.name for p in tmp_path.glob("ckpt_*.pt")) == [
        "ckpt_1.pt", "ckpt_2.pt", "ckpt_4.pt"]
    with pytest.raises(ValueError, match="keep_policy"):
        _prune(str(tmp_path), 2, "oldest")
