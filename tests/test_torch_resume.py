"""PyTorch port: resume on the CPU, the counterpart of
``tests/test_resume_fault.py``.

A run stopped mid-epoch by ``max_steps`` and resumed by a fresh trainer
from its checkpoint (``Trainer.maybe_resume``) reproduces the
uninterrupted run bit for bit: the parameters, the optimizer state, the
step's generator state and the step. The runs are hybrid (add attention)
with SpecAugment, scheduled sampling and encoder dropout on, so every
draw of the generator matters; once with ``ckpt_every_steps`` and once
at ``accum_grad_steps=2``, whose checkpoints fall on update boundaries.
A checkpoint of another vocabulary raises.
"""

import json
import os

import pytest
import torch

from gluon_e2e_asr_tpu_torch.config import (
    Config, DataConfig, DecodeConfig, LossConfig, ModelConfig, TrainConfig)
from gluon_e2e_asr_tpu_torch.training.checkpoint import (
    latest_checkpoint, restore_train_checkpoint)
from gluon_e2e_asr_tpu_torch.training.trainer import Trainer

torch.set_num_threads(1)


def _cfg(workdir, max_steps=-1, **train):
    """32 utterances, batches of 8: 4 batches an epoch, 2 epochs."""
    return Config(
        data=DataConfig(dataset="synthetic", synth_num_train=32,
                        synth_num_dev=8, synth_max_tokens=5, batch_size=8,
                        bucket_bounds_sec=(1.5,)),
        model=ModelConfig(enc_hidden=16, enc_layers=2, enc_subsample=(1, 2),
                          enc_dropout=0.1, dec_hidden=16, dec_embed=8,
                          att_dim=8, att_type="add"),
        loss=LossConfig(mtl_alpha=0.5, scheduled_sampling=0.3),
        decode=DecodeConfig(method="greedy"),
        train=TrainConfig(seed=3, num_epochs=2, learning_rate=1e-3,
                          warmup_steps=4, max_steps=max_steps,
                          ckpt_dir="ckpts", log_every_steps=100, **train))


def _assert_same(a: Trainer, b: Trainer):
    assert a.state.step == b.state.step
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.state.opt_state, b.state.opt_state
    assert sa.keys() == sb.keys() and sa["count"] == sb["count"]
    for slot in ("mu", "nu"):
        for k, v in sa[slot].items():
            assert torch.equal(v, sb[slot][k]), (slot, k)
    assert torch.equal(a.state.generator.get_state(),
                       b.state.generator.get_state())


@pytest.mark.parametrize("train,total,stop,skip", [
    # 8 steps; stopped 2 batches into epoch 1 (step 6)
    (dict(ckpt_every_steps=3), 8, 6, 2),
    # 2 updates an epoch, 4 in all; stopped after epoch 1's first update
    (dict(accum_grad_steps=2, ckpt_every_steps=1), 4, 3, 2),
])
def test_midepoch_resume_reproduces_the_run(tmp_path, train, total, stop, skip):
    ref = Trainer(_cfg(str(tmp_path / "ref"), **train),
                  workdir=str(tmp_path / "ref"))
    ref.train()
    assert ref.state.step == total

    work = str(tmp_path / "cut")
    cut = Trainer(_cfg(work, max_steps=stop, **train), workdir=work)
    cut.train()
    assert cut.state.step == stop
    path = latest_checkpoint(os.path.join(work, "ckpts"))
    assert path.endswith(f"ckpt_{stop}.pt")
    with open(path + ".json") as f:
        meta = json.load(f)
    assert (meta["epoch"], meta["batches_done"]) == (1, skip)

    resumed = Trainer(_cfg(work, **train), workdir=work)
    resumed.maybe_resume()
    assert (resumed.state.step, resumed.epoch0, resumed.skip_batches) == (
        stop, 1, skip)
    assert resumed.best_wer == cut.best_wer < float("inf")
    _assert_same(resumed, cut)  # the checkpoint holds the whole state
    resumed.train()
    _assert_same(resumed, ref)
    with open(os.path.join(work, "metrics.jsonl")) as f:
        lines = [json.loads(line) for line in f]
    res = [r for r in lines if r["event"] == "resume"]
    assert res == [dict(res[0], ckpt=path, epoch=1, skip_batches=skip)]


def test_periodic_checkpoints_sit_on_update_boundaries(tmp_path):
    """ckpt_every_steps counts updates: at accum_grad_steps=2 every
    checkpoint's batches_done is even within its epoch."""
    work = str(tmp_path)
    Trainer(_cfg(work, accum_grad_steps=2, ckpt_every_steps=1, keep_ckpts=0),
            workdir=work).train()
    metas = {}
    for fn in os.listdir(os.path.join(work, "ckpts")):
        if fn.startswith("ckpt_") and fn.endswith(".pt"):
            with open(os.path.join(work, "ckpts", fn + ".json")) as f:
                metas[int(fn[5:-3])] = json.load(f)
    assert sorted(metas) == [1, 2, 3, 4]
    mid = {s: (m["epoch"], m["batches_done"]) for s, m in metas.items()
           if m["batches_done"] >= 0}
    # steps 2 and 4 end their epochs and are overwritten by the epoch's
    # checkpoint (batches_done -1)
    assert mid == {1: (0, 2), 3: (1, 2)}


def test_resume_without_a_checkpoint_starts_fresh(tmp_path):
    t = Trainer(_cfg(str(tmp_path)), workdir=str(tmp_path))
    t.maybe_resume()
    assert (t.state.step, t.epoch0, t.skip_batches) == (0, 0, 0)


def test_resume_of_another_vocab_raises(tmp_path):
    work = str(tmp_path)
    Trainer(_cfg(work, max_steps=2), workdir=work).train()
    path = latest_checkpoint(os.path.join(work, "ckpts"))
    with open(path + ".json") as f:
        meta = json.load(f)
    meta["vocab_hash"] = "0" * 16
    with open(path + ".json", "w") as f:
        json.dump(meta, f)
    with pytest.raises(ValueError, match="vocab mismatch"):
        Trainer(_cfg(work), workdir=work).maybe_resume()


def test_resume_into_another_optimizer_raises(tmp_path):
    work = str(tmp_path)
    Trainer(_cfg(work, max_steps=2), workdir=work).train()
    other = Trainer(_cfg(work, optimizer="sgd"), workdir=work)
    with pytest.raises(ValueError, match="params_only"):
        other.maybe_resume()
    ck = restore_train_checkpoint(latest_checkpoint(
        os.path.join(work, "ckpts")), params_only=True)
    assert ck.step == 2 and ck.opt_state is None
