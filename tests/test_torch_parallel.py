"""PyTorch port: data parallelism over ``torch.distributed`` on the CPU.

Two gloo processes (``tests/torch_dp_worker.py``, launched once for the
module with the environment torchrun gives its ranks) run the port's
train step and decoders at world size 2 on the tiny config of
``tests/test_parallel.py::_setup`` (add attention, 2 layers of 32 units,
8 rows, f32); this process runs the same at world size 1 and the JAX
``shard_map`` step on 2 of the 8 virtual devices.

- With SpecAugment and the scheduled-sampling coins on (every rank draws
  for the global batch and keeps its rows), world size 2 against world
  size 1: the loss rtol 1e-6, every gradient rtol 1e-5 / atol 1e-7 (the
  order of the sums over the rows differs), the parameters after two
  Adam steps; also with rank 1's rows all padding.
- Deterministic (no SpecAugment, no coins), world size 2 against the
  JAX ``shard_map`` step: the loss rtol 1e-5, gradients rtol 1e-4 /
  atol 1e-5 (``tests/test_torch_train_step.py``), the parameters after
  Adam within 1% of the LR where the gradient is firm (above that atol).
- Gradient accumulation (two micro-batches an update, encoder dropout
  on) at world size 2 against world size 1: the metrics rtol 1e-5, the
  parameters after the second update as above.
- Resume at world size 2 (trainers on both ranks, rank 0 writing the
  checkpoint): the resumed run equals the uninterrupted one bit for bit.
- Greedy and beam decoding at world size 2 return what world size 1
  returns, on both ranks; the beam with LM shallow fusion too.
"""

import dataclasses
import json
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu import config as JC
from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model
from gluon_e2e_asr_tpu.parallel.mesh import DATA_AXIS, make_mesh, shard_batch_arrays
from gluon_e2e_asr_tpu.training import train_step as jts
from gluon_e2e_asr_tpu_torch import config as PC
from gluon_e2e_asr_tpu_torch import train
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax
from gluon_e2e_asr_tpu_torch.data.loader import DataLoader
from gluon_e2e_asr_tpu_torch.data.manifest import build_synthetic_manifest
from gluon_e2e_asr_tpu_torch.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.models.lm import LSTMLM
from gluon_e2e_asr_tpu_torch.parallel import mesh as M
from gluon_e2e_asr_tpu_torch.training import trainer as TR

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "torch_dp_worker.py")
sys.path.insert(0, os.path.dirname(WORKER))
import torch_dp_worker  # noqa: E402

B = 8
WORLD = 2


def _config(C, deterministic):
    """``tests/test_parallel.py::_setup``'s config in the JAX (``C`` =
    its config module) or the port's classes. Stochastic: SpecAugment's
    defaults and scheduled sampling 0.5; two Adam steps, the first at LR 0."""
    frontend = (C.FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0)
                if deterministic else C.FrontendConfig())
    return C.Config(
        data=C.DataConfig(dataset="synthetic", synth_num_train=B,
                          synth_max_tokens=5, batch_size=B,
                          bucket_bounds_sec=(1.5,)),
        frontend=frontend,
        model=C.ModelConfig(enc_hidden=32, enc_layers=2, enc_subsample=(1, 2),
                            dec_hidden=32, dec_embed=16, att_dim=16,
                            att_type="add", compute_dtype="float32"),
        loss=C.LossConfig(mtl_alpha=0.3,
                          scheduled_sampling=0.0 if deterministic else 0.5),
        train=C.TrainConfig(seed=0, dp=True, learning_rate=1e-2,
                            warmup_steps=0 if deterministic else 1))


def _batch():
    tok = CharTokenizer()
    utts = build_synthetic_manifest(B, seed=0, max_tokens=5)
    specs = make_bucket_specs((1.5,), 16000, B, 16)
    loader = DataLoader(utts, BucketSampler(utts, specs, 16000, seed=0,
                                            shuffle=False), tok)
    b = next(iter(loader.epoch(0)))
    return {"audio": b.audio, "audio_len": b.audio_len, "labels": b.labels,
            "label_len": b.label_len}


def _jax_setup(config, batch):
    tok = CharTokenizer()
    model = jax_build_model(config, tok.vocab_size, tok.sos_id, tok.eos_id)
    tx = jts.make_optimizer(config)
    return model, tx, jts.create_train_state(config, model, tx, batch)


def _jax_shard_map(config, batch, model, tx, state):
    """The ``shard_map`` step's gradients (psum'd) and its step on 2
    virtual devices."""
    from jax.sharding import PartitionSpec as P

    mesh = make_mesh(jax.devices()[:WORLD])
    spec = {k: P(DATA_AXIS) for k in batch}

    def grads(params, b):
        g = jax.grad(lambda p: jts.compute_loss(
            p, b, state.rng, model=model, config=config,
            axis_name=DATA_AXIS, step=state.step)[0])(params)
        return jax.lax.psum(g, DATA_AXIS)

    grad_fn = jax.jit(jax.shard_map(grads, mesh=mesh, in_specs=(P(), spec),
                                    out_specs=P(), check_vma=False))
    g = grad_fn(state.params, shard_batch_arrays(mesh, batch))
    config.train.dp_impl = "shard_map"
    step = jts.make_train_step(model, config, tx, mesh=mesh)
    new, m = step(state, shard_batch_arrays(mesh, batch))
    return _flat(g), _flat(new.params), {k: float(v) for k, v in m.items()}


def _flat(tree):
    return {k: v.numpy() for k, v in params_from_jax(
        jax.tree_util.tree_map(np.asarray, tree)).items()}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(workdir):
    """Both ranks of the worker, as torchrun would start them; returns a
    function that waits for them and reads their results."""
    port = _free_port()
    procs = []
    for rank in range(WORLD):
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(WORLD),
                   LOCAL_RANK=str(rank), MASTER_ADDR="127.0.0.1",
                   MASTER_PORT=str(port), OMP_NUM_THREADS="1")
        procs.append(subprocess.Popen(
            [sys.executable, WORKER, str(workdir)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))

    def results():
        outs = [p.communicate(timeout=300)[0] for p in procs]
        for p, out in zip(procs, outs):
            assert p.returncode == 0, out[-4000:]
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(WORLD)]

    return results


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("dp")
    tok = CharTokenizer()
    batch = _batch()
    pad = {k: v.copy() for k, v in batch.items()}
    for k in pad:  # rank 1's rows hold no utterance
        pad[k][B // WORLD:] = 0
    config = _config(PC, deterministic=False)
    model = build_model(config, tok.vocab_size, train=True, sos_id=tok.sos_id,
                        eos_id=tok.eos_id)
    model.encoder.reset_parameters(torch.Generator().manual_seed(0))
    model.decoder.reset_parameters(torch.Generator().manual_seed(1))
    jax_config = _config(JC, deterministic=True)
    jax_model, tx, jax_state = _jax_setup(jax_config, batch)
    det_params = params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                        jax_state.params))
    decode_config = _config(PC, deterministic=True)
    decode_config.decode.method = "beam"
    decode_config.decode.beam_size = 3
    decode_config.decode.ctc_weight = 0.3
    decode_config.decode.nbest = 2
    resume_config = _config(PC, deterministic=False)
    resume_config.data.synth_num_train = 4 * B  # 4 batches an epoch
    resume_config.data.synth_num_dev = B
    resume_config.model.enc_dropout = 0.1
    resume_config.train.num_epochs = 2
    resume_config.train.ckpt_dir = "ck"
    resume_config.decode.method = "greedy"
    lm_dims = (8, 16, 1)  # E, H, layers of the fused beam's LM
    lm = LSTMLM(tok.vocab_size, *lm_dims)
    lm.reset_parameters(torch.Generator().manual_seed(2))
    inputs = {"vocab": (tok.vocab_size, tok.sos_id, tok.eos_id),
              "config": config, "params": model.state_dict(),
              "batch": batch, "pad_batch": pad,
              "det_config": _config(PC, deterministic=True),
              "det_params": det_params, "det_batch": batch,
              "decode_config": decode_config,
              "resume_config": resume_config,
              "resume_dir": str(workdir / "resume"),
              "lm_dims": lm_dims, "lm_params": lm.state_dict()}
    torch.save(inputs, workdir / "inputs.pt")
    ranks = _launch(workdir)
    jax_grads, jax_params, jax_metrics = _jax_shard_map(
        jax_config, batch, jax_model, tx, jax_state)
    single = torch_dp_worker.run(inputs, M.SINGLE)
    ranks = ranks()
    return {"ranks": ranks, "single": single, "jax_grads": jax_grads,
            "jax_params": jax_params, "jax_metrics": jax_metrics,
            "config": config}


def _assert_steps_equal(a, b, loss_rtol=1e-6, rtol=1e-5, atol=1e-7):
    for sa, sb in zip(a, b):
        np.testing.assert_allclose(sa["metrics"]["loss"], sb["metrics"]["loss"],
                                   rtol=loss_rtol)
        for k in ("loss_ctc", "loss_att", "att_acc", "grad_norm"):
            np.testing.assert_allclose(sa["metrics"][k], sb["metrics"][k],
                                       rtol=rtol, atol=atol, err_msg=k)
        assert sa["metrics"]["num_real"] == sb["metrics"]["num_real"]
        assert set(sa["grads"]) == set(sb["grads"])
        for k, g in sa["grads"].items():
            np.testing.assert_allclose(g, sb["grads"][k], rtol=rtol, atol=atol,
                                       err_msg=k)


def test_both_ranks_ran_at_world_size_two(runs):
    assert [r["world"] for r in runs["ranks"]] == [(0, 2), (1, 2)]


def test_stochastic_step_matches_world_size_one(runs):
    """SpecAugment and the coins on: the draws of the global batch on each
    rank, so world size 2 takes world size 1's step."""
    single = runs["single"]["stochastic"]
    for r in runs["ranks"]:
        _assert_steps_equal(r["stochastic"], single)
    assert single[1]["metrics"]["loss_att"] > 0


def test_parameters_after_two_adam_steps_match(runs):
    single = runs["single"]["stochastic"][1]["params"]
    first = runs["single"]["stochastic"][0]["params"]
    moved = max(np.abs(v - first[k]).max() for k, v in single.items())
    assert moved > 1e-4
    # Adam divides by sqrt(nu): an entry whose gradient is near 0 moves
    # by a fraction of the LR that its rounding decides (1% of it here, as
    # in tests/test_torch_train_step.py).
    lr = runs["config"].train.learning_rate
    for r in runs["ranks"]:
        for k, v in r["stochastic"][1]["params"].items():
            np.testing.assert_allclose(v, single[k], rtol=0,
                                       atol=0.01 * lr + 1e-7, err_msg=k)
    # The ranks hold the same parameters, bit for bit.
    for k, v in runs["ranks"][0]["stochastic"][1]["params"].items():
        np.testing.assert_array_equal(v, runs["ranks"][1]["stochastic"][1]["params"][k])


def test_accumulation_matches_world_size_one(runs):
    """accum_grad_steps=2 with encoder dropout on: each rank's micro-batch
    passes, the group summed over the ranks in one all-reduce before the
    update, against world size 1: the metrics and the parameters after the
    second update (the first runs at LR 0)."""
    single = runs["single"]["accum"]
    lr = runs["config"].train.learning_rate
    for r in runs["ranks"]:
        for got, ref in zip(r["accum"], single):
            for k in ("loss", "loss_ctc", "loss_att", "att_acc", "grad_norm"):
                np.testing.assert_allclose(got["metrics"][k], ref["metrics"][k],
                                           rtol=1e-5, err_msg=k)
            assert got["metrics"]["num_real"] == ref["metrics"]["num_real"] == B
        for k, v in r["accum"][1]["params"].items():
            np.testing.assert_allclose(v, single[1]["params"][k], rtol=0,
                                       atol=0.01 * lr + 1e-7, err_msg=k)
    moved = max(np.abs(v - single[0]["params"][k]).max()
                for k, v in single[1]["params"].items())
    assert moved > 1e-4


def test_resume_at_world_size_two(runs):
    """train.dp over 2 ranks (SpecAugment, the coins and dropout on): a
    run stopped at step 3 (mid-epoch 0, 4 batches an epoch) and resumed
    by fresh trainers on both ranks from rank 0's checkpoint equals the
    uninterrupted run bit for bit on each rank, and the ranks hold the
    same parameters."""
    r0, r1 = (r["resume"] for r in runs["ranks"])
    assert r0["resumed_at"] == r1["resumed_at"] == (3, 0, 3)
    for r in (r0, r1):
        assert r["ref"]["step"] == r["cut"]["step"] == 8
        for k, v in r["ref"]["params"].items():
            np.testing.assert_array_equal(r["cut"]["params"][k], v, err_msg=k)
    for k, v in r0["cut"]["params"].items():
        np.testing.assert_array_equal(r1["cut"]["params"][k], v, err_msg=k)


def test_a_rank_of_pad_rows_only(runs):
    """Rank 1's rows are all padding (the last batch of an epoch can shard
    so): its loss share is 0 and the sums still equal world size 1."""
    single = runs["single"]["pad_shard"]
    assert single[0]["metrics"]["num_real"] == B // WORLD
    for r in runs["ranks"]:
        _assert_steps_equal(r["pad_shard"], single)
        assert np.isfinite(r["pad_shard"][0]["metrics"]["loss"])


def test_deterministic_step_matches_jax_shard_map(runs):
    m = runs["ranks"][0]["deterministic"][0]
    jm = runs["jax_metrics"]
    np.testing.assert_allclose(m["metrics"]["loss"], jm["loss"], rtol=1e-5)
    for k in ("loss_ctc", "loss_att", "att_acc"):
        np.testing.assert_allclose(m["metrics"][k], jm[k], rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(m["metrics"]["grad_norm"], jm["grad_norm"],
                               rtol=1e-4)
    assert m["metrics"]["num_real"] == jm["num_real"] == B
    assert set(m["grads"]) == set(runs["jax_grads"])
    for k, g in m["grads"].items():
        np.testing.assert_allclose(g, runs["jax_grads"][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    # Adam's first update is lr * g / (|g| + eps): where the gradient is
    # within its atol of 0 the rounding decides the direction, and such an
    # entry is held only to the update's size.
    lr = runs["config"].train.learning_rate
    for k, v in m["params"].items():
        ref = runs["jax_params"][k]
        firm = np.abs(runs["jax_grads"][k]) > 1e-5
        np.testing.assert_allclose(v[firm], ref[firm], rtol=0,
                                   atol=0.01 * lr + 1e-7, err_msg=k)
        np.testing.assert_allclose(v, ref, rtol=0, atol=2 * lr + 1e-7,
                                   err_msg=k)


def test_dp_decode_matches_single_process(runs):
    """Greedy and beam (K=3, ctc_weight 0.3, 2-best) at world size 2 return
    world size 1's results on both ranks (the counterpart of
    tests/test_parallel.py::test_dp_decode_matches_single_device)."""
    single = runs["single"]["decode"]
    assert any(single["texts"])
    for r in runs["ranks"]:
        d = r["decode"]
        np.testing.assert_array_equal(d["ids"], single["ids"])
        np.testing.assert_array_equal(d["lens"], single["lens"])
        assert d["texts"] == single["texts"]
        np.testing.assert_allclose(d["scores"], single["scores"], rtol=1e-5,
                                   atol=1e-5)
        assert ([[t for t, _ in u] for u in d["nbest"]]
                == [[t for t, _ in u] for u in single["nbest"]])
        assert d["last_steps"] == single["last_steps"]


def test_dp_lm_fused_beam_matches_single_process(runs):
    """The beam with LM shallow fusion (lm_weight 0.5) at world size 2:
    world size 1's texts on both ranks, its scores within 1e-5, and the
    LM moved the scores."""
    single = runs["single"]["decode"]
    assert any(single["lm_texts"])
    assert not np.allclose(single["lm_scores"], single["scores"])
    for r in runs["ranks"]:
        d = r["decode"]
        assert d["lm_texts"] == single["lm_texts"]
        np.testing.assert_allclose(d["lm_scores"], single["lm_scores"],
                                   rtol=1e-5, atol=1e-5)


def test_batch_must_divide_the_world_size():
    specs = make_bucket_specs((1.5, 3.0), 16000, 8, 16)
    TR.check_divisible(specs, M.World(size=2), "train.dp")
    with pytest.raises(ValueError, match="divisible by the world size \\(3\\)"):
        TR.check_divisible(specs, M.World(size=3), "train.dp")
    with pytest.raises(ValueError, match="does not split over 3"):
        M.shard_rows(np.zeros((8, 2)), 0, 3)


def test_collectives_are_the_identity_at_one_rank_and_need_a_group_above():
    """A world of one runs no collective; a world of two without a process
    group raises instead of leaving each rank with its partial sums."""
    t = torch.arange(4.0)
    M.all_reduce_sum([t], M.World(group=object()))
    np.testing.assert_array_equal(t.numpy(), np.arange(4.0))
    rows = ["a", "b"]
    assert M.gather_rows(rows, M.World(group=object())) is rows
    M.check_replicated([t], M.World())
    for call in (lambda w: M.all_reduce_sum([t], w),
                 lambda w: M.gather_rows(rows, w),
                 lambda w: M.check_replicated([t], w)):
        with pytest.raises(RuntimeError, match="without a process group"):
            call(M.World(rank=0, size=2))


def test_dev_evaluation_falls_back_when_a_dev_bucket_does_not_divide():
    specs = make_bucket_specs((1.5, 3.0), 16000, 8, 16)
    records = []
    logger = type("L", (), {"log": lambda self, r: records.append(r)})()
    world = M.World(rank=0, size=2)
    assert TR.eval_world(specs, world, logger) is world and not records
    specs[1] = dataclasses.replace(specs[1], batch_size=3)
    assert TR.eval_world(specs, world, logger) is M.SINGLE
    assert records == [{"event": "dp_eval_fallback",
                        "reason": "dev bucket batch sizes not divisible by "
                                  "the world size",
                        "bad_batch_sizes": [3], "devices": 2}]


def test_train_cli_with_dp_and_no_torchrun_is_a_world_of_one(tmp_path):
    """``train.dp=true`` without torchrun's environment: one rank over a
    gloo group of its own, the same step, metrics and checkpoints."""
    import torch.distributed as dist

    assert "RANK" not in os.environ
    config = os.path.join(REPO, "tests", "goldens", "tiny_golden.yaml")
    try:
        trainer = train.main([
            "--config", config, "--workdir", str(tmp_path), "--max-steps", "2",
            "--device", "cpu", "--set", "train.dp=true",
            "--set", "loss.mtl_alpha=1.0", "--set", "decode.method=greedy",
            "--set", "train.log_every_steps=1"])
        assert dist.get_world_size() == 1
        assert dist.get_backend() == "gloo"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    assert trainer.world.size == 1 and trainer.world.group is not None
    with open(tmp_path / "metrics.jsonl") as f:
        lines = [json.loads(line) for line in f]
    assert {"event": "data_parallel", "world_size": 1,
            "dp_impl": "shard_map"}.items() <= next(
        r for r in lines if r["event"] == "data_parallel").items()
    assert [r["step"] for r in lines if r["event"] == "train"] == [1, 2]
    assert os.path.exists(tmp_path / trainer.config.train.ckpt_dir / "ckpt_2.pt")
