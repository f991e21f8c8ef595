"""PyTorch port: the quality comparison of ``chip_smoke.py``'s phase 14
(``gluon_e2e_asr_tpu_torch/tools/convergence.py`` over the port's copy of
``tools/wer_ci.py``) on the CPU.

- the port's ``tools/wer_ci.py`` against the root tool: the same code
  apart from the import, and bit for bit the same numbers on two of the
  TPU runs' records;
- each config of phase 14's plan builds a dev set whose refs equal its
  TPU record's, utterance for utterance (the paired comparison holds);
- a tiny config through the phase's path (train every epoch, decode
  ``best.pt`` by its decode block, compare), compared with itself: a
  difference of 0;
- ls100_full's sampler at its own scale at seeds 0-2: the steps and pad
  waste phase 16 holds each seed's run to (seed 0: the TPU table);
- phases 14dr and 16r's repeat: the state digest, where two runs part,
  the output names by seed, two tiny runs through the train CLI equal on
  the CPU, and each committed repeat's two runs identical;
- the port's train step against the JAX package's over LONG_STEPS steps
  of english_m5_bpe, milestone5_beam, ls100_full and flagship_bf16 (the
  last two in f32) at test widths (the plain versions, the same draws):
  the longest comparison of training the CPU allows in a test, where
  rounding could drift that 2 steps cannot show;
- the committed records (``gluon_e2e_asr_tpu_torch/evidence/``: the
  port's on the card, the JAX recipe's on the CPU) recomputed with the
  root ``tools/wer_ci.py`` against each reference their README names:
  the numbers ``PERF.md`` states; each run's best epoch from its epoch
  lines.
"""

import functools
import importlib.util
import json
import os
import sys
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, REPO)

import chip_smoke  # noqa: E402
import test_torch_milestone_configs as MC  # noqa: E402
from test_torch_data import _definitions  # noqa: E402

from gluon_e2e_asr_tpu.config import load_config as jax_load_config  # noqa: E402
from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model  # noqa: E402
from gluon_e2e_asr_tpu.training import train_step as jts  # noqa: E402
from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config  # noqa: E402
from gluon_e2e_asr_tpu_torch.data.tokenizer import build_tokenizer  # noqa: E402
from gluon_e2e_asr_tpu_torch.eval.metrics import cer, wer  # noqa: E402
from gluon_e2e_asr_tpu_torch.frontend.features import num_frames  # noqa: E402
from gluon_e2e_asr_tpu_torch.models.asr import build_model  # noqa: E402
from gluon_e2e_asr_tpu_torch.training import train_step as T  # noqa: E402
from gluon_e2e_asr_tpu_torch.tools import convergence as CV  # noqa: E402
from gluon_e2e_asr_tpu_torch.tools import wer_ci as port_ci  # noqa: E402

torch.set_num_threads(1)

EVIDENCE = os.path.join(REPO, "docs", "evidence")
CARD_EVIDENCE = os.path.join(REPO, "gluon_e2e_asr_tpu_torch", "evidence")
ROOT_TOOL = os.path.join(REPO, "tools", "wer_ci.py")
TINY = os.path.join(REPO, "tests", "goldens", "tiny_golden.yaml")
TINY_SETS = ["train.num_epochs=2", "data.synth_num_train=16",
             "data.synth_num_dev=8"]


def _root_ci():
    spec = importlib.util.spec_from_file_location("root_wer_ci", ROOT_TOOL)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _paired(tool, a, b):
    ca = tool.per_utt_counts(a, keyed=True)
    cb = tool.per_utt_counts(b, keyed=True)
    shared = sorted(set(ca) & set(cb))
    return (np.asarray([ca[k] for k in shared], np.float64),
            np.asarray([cb[k] for k in shared], np.float64))


def test_wer_ci_matches_the_root_tool():
    """m5_beam against m5_beam with a fused LM (weight 0.2): diff -0.6
    points, CI [-1.8, +0.6], p = 0.22, bit for bit in both tools."""
    a = os.path.join(EVIDENCE, "m5_beam_dev192.jsonl")
    b = os.path.join(EVIDENCE, "m5_beam_lm02_dev192.jsonl")
    root = _root_ci()
    ours = port_ci.paired_diff_ci(*_paired(port_ci, a, b))
    ref = root.paired_diff_ci(*_paired(root, a, b))
    assert ours == ref
    d, lo, hi, p = ours
    assert (round(d, 3), round(lo, 3), round(hi, 3), round(p, 2)) == \
        (-0.006, -0.018, 0.006, 0.22)
    counts = port_ci.per_utt_counts(a)
    np.testing.assert_array_equal(counts, root.per_utt_counts(a))
    assert port_ci.bootstrap_ci(counts) == root.bootstrap_ci(counts)
    got = CV.compare(a, b)
    assert (got["wer_diff"], *got["wer_diff_ci95"], got["p_diff_ge_0"]) == ref
    assert got["wer"] == root.bootstrap_ci(counts)[0] and got["tie"]


def test_wer_ci_definitions_equal_the_root_tool():
    """Every definition of the port's copy is the root tool's; only the
    imports differ (the port's eval/metrics.py for the JAX package's)."""
    ours = _definitions(os.path.join(REPO, "gluon_e2e_asr_tpu_torch", "tools",
                                     "wer_ci.py"), "gluon_e2e_asr_tpu_torch")
    ref = _definitions(ROOT_TOOL, "gluon_e2e_asr_tpu")
    assert set(ours) == set(ref) == {"per_utt_counts", "bootstrap_ci",
                                     "paired_diff_ci", "main"}
    assert ours == ref


@pytest.mark.parametrize("pid", [*sorted(chip_smoke.CONVERGENCE), "16"])
def test_phase14_dev_sets_pair_with_their_records(pid):
    """The port's dev set of each config of phase 14 holds the TPU
    record's refs, utterance for utterance, 192/192; phase 16's
    (ls100_full at its own scale, its texts drawn without rendering any
    audio) holds the 100 h TPU run's, 2,700/2,700, and that record
    recomputes to its WER 0.0801 and CER 0.0251 (round 5), not the 0.0671
    its summary sidecar still carries from round 4."""
    if pid == "16":
        refs = {u.utt_id: u.text
                for u in chip_smoke.ls100_full_manifest("dev-clean")}
        rec, n = chip_smoke.LS100_FULL_RECORD, chip_smoke.LS100_FULL[1]
    else:
        cfg, rec = chip_smoke.CONVERGENCE[pid]
        refs = CV.dev_refs(load_config(os.path.join(REPO, "configs",
                                                    f"{cfg}.yaml")))
        n = 192
    records = CV.read_records(os.path.join(EVIDENCE, f"{rec}.jsonl"))
    assert len(refs) == len(records) == n
    assert CV.refs_match(refs, records) == n
    if pid == "16":
        refs, hyps = [r["ref"] for r in records], [r["hyp"] for r in records]
        assert (round(wer(refs, hyps), 4), round(cer(refs, hyps), 4)) == \
            (0.0801, 0.0251) == (chip_smoke.LS100_FULL_TPU["dev_wer"][-1],
                                 chip_smoke.LS100_FULL_TPU["dev_cer"][-1])
        with open(os.path.join(EVIDENCE, f"{rec}_summary.json")) as f:
            assert json.load(f)["wer"] == 0.0671


@functools.lru_cache(maxsize=None)
def _ls100_full_manifests():
    return (chip_smoke.ls100_full_manifest("train-clean-100"),
            chip_smoke.ls100_full_manifest("dev-clean"))


# ls100_full's sampler at training seeds 1 and 2 (the shuffle and the
# speed-perturbation draws follow train.seed): each epoch's steps and pad
# waste, which phase 16 at that seed holds its run to.
LS100_FULL_SEEDS = {1: {"steps": (673, 673, 673, 675, 673),
                        "pad_waste": (0.117, 0.1167, 0.1174, 0.1193, 0.1171)},
                    2: {"steps": (672, 674, 673, 673, 673),
                        "pad_waste": (0.1161, 0.1182, 0.117, 0.1172, 0.1167)}}


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ls100_full_epochs_equal_the_tpu_table(seed, monkeypatch):
    """ls100_full.yaml's sampler over its corpus at its own scale (the
    texts and durations drawn without rendering any audio): 101.3 h, under
    11.7 GB of 16-bit PCM, and each of its 5 epochs' steps and pad waste
    (1 - real samples after speed perturbation over the batches' padded
    samples, as the trainer counts it; chip_smoke.ls100_full_plan) equal
    at seed 0 to the TPU run's epoch table (the port's sampler is the JAX
    one's copy, both at world size 1), and at seeds 1 and 2 to
    LS100_FULL_SEEDS; phase 16 holds its run at the seed to the same
    (chip_smoke.ls100_full_expected: the TPU table at seed 0, the plan at
    another)."""
    config = load_config(chip_smoke.LS100_CONFIG)
    sr = config.data.sample_rate
    utts, dev = _ls100_full_manifests()
    pcm = 2 * sum(round(u.duration * sr) for u in utts + dev)
    assert len(utts) == 28500 and round(pcm / 2 / sr / 3600, 1) == 101.3
    assert pcm < 11.7e9
    plan = chip_smoke.ls100_full_plan(seed)
    assert not plan["skipped"]
    want = (chip_smoke.LS100_FULL_TPU if seed == 0
            else LS100_FULL_SEEDS[seed])
    assert plan["steps"] == want["steps"]
    assert plan["pad_waste"] == want["pad_waste"]
    monkeypatch.setattr(chip_smoke, "ls100_full_plan",
                        lambda s: plan if s == seed else None)
    assert chip_smoke.ls100_full_expected(seed) == {
        k: want[k] for k in ("steps", "pad_waste")}


def _state(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"param w": torch.randn(3, 4, generator=g),
            "param b16": torch.randn(5, generator=g).to(torch.bfloat16),
            "mu w": torch.randn(3, 4, generator=g),
            "opt count": torch.tensor(7.0, dtype=torch.float64),
            "step": torch.tensor(7),
            "generator": g.get_state()}


def _one_ulp(t):
    t = t.clone()
    t[1, 2] = torch.nextafter(t[1, 2], torch.tensor(np.inf))
    return t


def _renamed(state):
    state["nu w"] = state.pop("mu w")
    return state


@pytest.mark.parametrize("change", [
    lambda st: dict(st, **{"param w": _one_ulp(st["param w"])}),
    lambda st: dict(st, **{"param b16": (st["param b16"].view(torch.int16)
                                         + 1).view(torch.bfloat16)}),
    lambda st: dict(st, **{"mu w": st["mu w"].double()}),
    lambda st: dict(st, **{"mu w": st["mu w"].reshape(4, 3)}),
    lambda st: dict(st, step=st["step"] + 1),
    _renamed], ids=["one_ulp", "bf16_bit", "dtype", "shape", "step", "key"])
def test_state_digest_is_the_states_bits_in_key_order(change):
    """chip_smoke.state_digest, which phases 14dr and 16r hold two runs'
    final states and best.pt files to: equal states give equal digests
    whatever order their keys went in; one ulp of one entry, one bit of a
    bf16 entry, a dtype, a shape, the step or a key's name changes it."""
    a = _state()
    digest = chip_smoke.state_digest(torch, a)
    assert len(digest) == 64 and int(digest, 16) >= 0
    assert chip_smoke.state_digest(torch, _state()) == digest
    assert chip_smoke.state_digest(
        torch, dict(reversed(list(a.items())))) == digest
    assert chip_smoke.state_digest(torch, change(_state())) != digest
    assert chip_smoke.state_digest(torch, a) == digest  # a is unchanged


def test_checkpoint_digest_equals_the_runs(tmp_path):
    """A training checkpoint's flat state (chip_smoke.checkpoint_state:
    parameters, Adam's moments, step, generator) has the digest of the
    run's state it was saved from (chip_smoke.state_of), so a run whose
    best epoch is its last gives best.pt its final digest; a step later
    both move."""
    from gluon_e2e_asr_tpu_torch.training.checkpoint import (
        save_train_checkpoint)

    config = load_config(TINY)
    batch, tok = chip_smoke.repro_batch(torch, TINY, "bucket")
    model = build_model(config, tok.vocab_size, train=True,
                        sos_id=tok.sos_id, eos_id=tok.eos_id)
    opt = T.make_optimizer(config)
    state = T.create_train_state(config, model, opt, torch.device("cpu"))
    step = T.make_train_step(model, config, opt)
    step(state, batch)
    path = save_train_checkpoint(
        str(tmp_path), model.state_dict(), state.opt_state, state.step, {},
        is_best=True, generator=state.generator.get_state())
    run = chip_smoke.state_digest(torch, chip_smoke.state_of(torch, model,
                                                             state))
    best = os.path.join(str(tmp_path), "best.pt")
    assert os.path.realpath(best) == os.path.realpath(path)
    saved = chip_smoke.checkpoint_state(torch, best)
    assert any(k.startswith("mu ") for k in saved) and any(
        k.startswith("nu ") for k in saved)
    assert chip_smoke.state_digest(torch, saved) == run
    step(state, batch)
    assert chip_smoke.state_digest(
        torch, chip_smoke.state_of(torch, model, state)) != run


@pytest.mark.parametrize("seed,repeat,name", [
    (0, False, "ls100_full_h100_dev2700"),
    (1, False, "ls100_full_h100_dev2700_seed1"),
    (2, False, "ls100_full_h100_dev2700_seed2"),
    (0, True, "ls100_full_h100_dev2700_repeat"),
    (2, True, "ls100_full_h100_dev2700_repeat_seed2")])
def test_phase16_outputs_take_the_seed(seed, repeat, name):
    """Phase 16's records, epoch lines and repeat file are named as phase
    14's: ``_seed<N>`` at a training seed other than 0, ``_repeat`` for
    ``--only 16r``; phase 16 reads the seed from its ``--set``
    overrides."""
    assert chip_smoke.record_name(chip_smoke.LS100_FULL_NAME, seed,
                                  repeat) == name
    assert chip_smoke.record_name("flagship_bf16_h100_dev192", seed,
                                  repeat) == name.replace(
        "ls100_full_h100_dev2700", "flagship_bf16_h100_dev192")
    config = load_config(chip_smoke.LS100_CONFIG)
    apply_overrides(config, [f"train.seed={seed}"])
    assert config.train.seed == seed


def _outs(losses=(1.0, 0.5, 0.25), digest="0" * 64):
    return {"steps": len(losses), "train_lines": [{"step": 1, "loss": 1.0}],
            "epochs": [{"epoch": 0, "dev_wer": 0.5}], "best_epoch": 0,
            "final_digest": digest, "best_digest": digest}


@pytest.mark.parametrize("case", ["equal", "loss", "batch", "digest",
                                  "shorter"])
def test_repeat_report_finds_where_runs_part(case):
    """chip_smoke.repeat_report: two runs equal in every run_outputs entry
    and every step's loss and batch are equal; a step whose loss or batch
    differs is the first step where they part (from 1); runs equal step
    for step but not in a digest differ in that entry alone; a run that
    stops early parts at the step after its last. The records are
    compared as the phases compare them across processes
    (chip_smoke.step_keys: each step's loss and its batch's SHA-256)."""
    rec = [(1.0, b"a"), (0.5, b"b"), (0.25, b"c")]
    other, outs = list(rec), _outs()
    want_first, want_differ = None, []
    if case == "loss":
        other[1] = (np.nextafter(0.5, 1.0), b"b")
        want_first = 2
    elif case == "batch":
        other[2] = (0.25, b"d")
        want_first = 3
    elif case == "digest":
        outs = dict(outs, final_digest="1" * 64)
        want_differ = ["final_digest"]
    elif case == "shorter":
        other = other[:2]
        want_first = 3
    report = chip_smoke.repeat_report(
        [_outs(), outs], [chip_smoke.step_keys(r) for r in (rec, other)])
    assert report == {"equal": case == "equal", "differ": want_differ,
                      "first_parted_step": want_first}


@pytest.mark.parametrize("overrides,want", [
    ((), [[]]),
    (("train.seed=1",), [["train.seed=1"]]),
    (("train.seed=1", "train.seed=2"), [["train.seed=1"], ["train.seed=2"]]),
    (("train.seed=2", "data.batch_size=8", "train.seed=1"),
     [["data.batch_size=8", "train.seed=2"],
      ["data.batch_size=8", "train.seed=1"]]),
    (("data.batch_size=8",), [["data.batch_size=8"]])],
    ids=["none", "one", "two", "mixed", "no_seed"])
def test_seed_runs_train_each_seed_in_turn(overrides, want):
    """chip_smoke.seed_runs: ``--only 16 --set train.seed=1 --set
    train.seed=2`` trains each seed in turn (after one render), each with
    the overrides that name no seed; without a seed, the overrides
    alone. The last override wins for a seed (as apply_overrides does)."""
    assert chip_smoke.seed_runs(overrides) == want
    for sets in want:
        config = load_config(chip_smoke.LS100_CONFIG)
        apply_overrides(config, sets)
        seeds = [o for o in sets if o.startswith("train.seed=")]
        assert config.train.seed == (int(seeds[-1].split("=")[1]) if seeds
                                     else 0)


def _repeat_files():
    return sorted(p for p in os.listdir(CARD_EVIDENCE)
                  if p.endswith(".json") and "_repeat" in p)


def _assert_repeat(directory, name, log_every=10):
    """A repeat file (chip_smoke.write_repeat) holds REPEAT_RUNS runs
    identical in every logged train line, every epoch line, the step
    losses' and batches' digests and the final-state and best.pt digests,
    and its epoch lines file (``<record>_epochs.jsonl``) the first run's
    epochs, the same values."""
    with open(os.path.join(directory, name)) as f:
        rep = json.load(f)
    assert rep["equal"] and rep["first_parted_step"] is None
    assert not rep["differ"]
    runs = [{k: v for k, v in r.items() if k != "run"} for r in rep["runs"]]
    assert [r["run"] for r in rep["runs"]] == [1, 2]
    assert len(runs) == chip_smoke.REPEAT_RUNS
    assert all(r == runs[0] for r in runs[1:])
    run = runs[0]
    for k in ("final_digest", "best_digest", "step_losses_sha256",
              "batches_sha256"):
        assert len(run[k]) == 64 and int(run[k], 16) >= 0
    assert run["steps"] == run["epochs"][-1]["step"]
    assert len(run["train_lines"]) == run["steps"] // log_every
    assert all(np.isfinite(line["loss"]) for line in run["train_lines"])
    epochs = CV.read_records(os.path.join(
        directory, name[:-len(".json")] + "_epochs.jsonl"))
    assert [{k: e[k] for k in (*chip_smoke.REPEAT_EPOCH_KEYS, "loss_logged")}
            for e in epochs] == run["epochs"]
    return rep


@pytest.mark.parametrize("name", _repeat_files())
def test_committed_repeats_are_bit_equal(name):
    """Each committed repeat (phases 16r and 14dr: two runs of one seed
    in one chip call, the second in a child process) is equal bit for
    bit (_assert_repeat), and the README names it beside its record."""
    _assert_repeat(CARD_EVIDENCE, name)
    with open(os.path.join(CARD_EVIDENCE, "README.md")) as f:
        readme = f.read()
    assert f"`{name[:-len('.json')]}.jsonl`" in readme and f"`{name}`" in readme


def test_two_runs_of_one_seed_repeat_on_the_cpu(tmp_path):
    """The repeat of phases 14dr and 16r on the CPU: the tiny config
    twice through the train CLI (chip_smoke._run_cli) at one seed, each
    run's run_outputs (logged lines, epoch lines, step losses and
    batches, the final state's and best.pt's digests) equal, repeat_report
    equal, and write_repeat's file passes the committed repeats' checks;
    a run at another seed parts at its first step. The first run is kept
    as the phase keeps its own (chip_smoke.json_copy, step_keys), the
    others as a child process writes them (repeat_worker: through a JSON
    file), and they compare equal."""
    out = str(tmp_path)
    sets = [a for o in TINY_SETS + ["train.log_every_steps=1"]
            for a in ("--set", o)]
    outs, records = [], []
    for run in range(chip_smoke.REPEAT_RUNS):
        record = []
        trainer, lines = chip_smoke._run_cli(
            torch, TINY, f"run{run + 1}", sets, record, device="cpu",
            out_dir=out)
        got = {"outputs": chip_smoke.run_outputs(torch, trainer, lines,
                                                 record),
               "steps": chip_smoke.step_keys(record)}
        if run == 0:
            got = chip_smoke.json_copy(got)
        else:
            path = os.path.join(out, f"run{run + 1}.json")
            with open(path, "w") as f:
                json.dump(got, f)
            with open(path) as f:
                got = json.load(f)
        outs.append(got["outputs"])
        records.append(got["steps"])
        if run == 0:
            CV.write_lines(os.path.join(out, "tiny_repeat_epochs.jsonl"),
                           CV.epoch_records(lines))
    report = chip_smoke.repeat_report(outs, records)
    assert report == {"equal": True, "differ": [], "first_parted_step": None}
    chip_smoke.write_repeat(os.path.join(out, "tiny_repeat.json"), outs,
                            report, config=TINY, seed=0)
    rep = _assert_repeat(out, "tiny_repeat.json", log_every=1)
    assert rep["runs"][0]["steps"] == len(records[0]) > 2
    assert all(len(h) == 64 for _, h in records[0])
    assert rep["runs"][0]["best_epoch"] in (0, 1)
    record = []
    trainer, lines = chip_smoke._run_cli(
        torch, TINY, "seed1", sets + ["--set", "train.seed=1"], record,
        device="cpu", out_dir=out)
    other = chip_smoke.json_copy(chip_smoke.run_outputs(torch, trainer, lines,
                                                        record))
    report = chip_smoke.repeat_report([outs[0], other],
                                      [records[0], chip_smoke.step_keys(record)])
    assert not report["equal"] and report["first_parted_step"] == 1
    assert {"final_digest", "best_digest", "train_lines"} <= set(
        report["differ"])


def test_refs_that_differ_void_the_comparison(tmp_path):
    """A record of another dev set does not pair: the tool refuses to
    train."""
    other = os.path.join(EVIDENCE, "english_flagship_dev192.jsonl")
    with pytest.raises(ValueError, match="void"):
        CV.main(["--config", os.path.join(REPO, "configs",
                                          "english_flagship.yaml"),
                 "--reference", other, "--workdir", str(tmp_path),
                 "--device", "cpu"])


def test_tiny_config_compared_with_itself_is_a_tie(tmp_path):
    """The phase's path on the CPU: two epochs of a tiny config through
    the train CLI, best.pt decoded by its beam over the dev set, then the
    records against themselves (a difference of exactly 0), and a second
    run through the tool's CLI against the first run's records (the same
    seed on the CPU: the same records, again 0)."""
    first = str(tmp_path / "first")
    trainer, lines = CV.train(TINY, first, TINY_SETS, "cpu")
    epochs = [r for r in lines if r["event"] == "epoch"]
    ckpt, best_epoch = CV.best_checkpoint(trainer)
    assert len(epochs) == 2
    assert epochs[best_epoch]["dev_wer"] == min(r["dev_wer"] for r in epochs)
    out = os.path.join(first, "best_dev.jsonl")
    res = CV.decode_best(TINY, ckpt, out, TINY_SETS, "cpu")
    records = CV.read_records(out)
    assert res["method"] == "beam" and len(records) == res["num_utts"] == 8
    assert all(set(r) == set(CV.RECORD_KEYS) for r in records)
    config = load_config(TINY)
    apply_overrides(config, TINY_SETS)
    assert CV.refs_match(CV.dev_refs(config), records) == 8
    got = CV.compare(out, out)
    assert got["wer_diff"] == 0.0 and got["wer_diff_ci95"] == [0.0, 0.0]
    assert got["p_diff_ge_0"] == 1.0 and got["tie"]
    assert got["wer"] == got["reference_wer"]
    summary = CV.main(["--config", TINY, "--reference", out, "--workdir",
                       str(tmp_path / "second"), "--device", "cpu",
                       *[a for s in TINY_SETS for a in ("--set", s)]])
    assert CV.read_records(summary["records"]) == records
    assert summary["wer_diff"] == 0.0 and summary["best_epoch"] == best_epoch


def test_epoch_lines_and_records_in_the_evidence_form(tmp_path):
    """``convergence epochs``: each epoch line of a metrics file with the
    mean loss of the train lines logged in that epoch (None where it
    logged none); ``convergence records``: RECORD_KEYS of each record,
    sorted by utt_id; ``intervals`` equals ``compare``'s own half."""
    lines = [{"event": "datasets"},
             {"event": "train", "step": 10, "loss": 4.0},
             {"event": "train", "step": 20, "loss": 2.0},
             {"event": "epoch", "epoch": 0, "step": 25, "dev_wer": 0.9},
             {"event": "ckpt_io", "epoch": 0},
             {"event": "epoch", "epoch": 1, "step": 30, "dev_wer": 0.8},
             {"event": "train", "step": 40, "loss": 1.0},
             {"event": "epoch", "epoch": 2, "step": 50, "dev_wer": 0.7}]
    metrics = tmp_path / "metrics.jsonl"
    CV.write_lines(str(metrics), lines)
    out = tmp_path / "epochs.jsonl"
    CV.main(["epochs", str(metrics), str(out)])
    got = CV.read_records(str(out))
    assert [r["epoch"] for r in got] == [0, 1, 2]
    assert [r["loss_logged"] for r in got] == [3.0, None, 1.0]
    assert got[0]["dev_wer"] == 0.9 and got[2]["step"] == 50
    raw = tmp_path / "raw.jsonl"
    src = CV.read_records(os.path.join(EVIDENCE, "m5_beam_dev192.jsonl"))
    CV.write_lines(str(raw), [dict(r, extra=1) for r in reversed(src)])
    rec = tmp_path / "rec.jsonl"
    CV.main(["records", str(raw), str(rec)])
    kept = CV.read_records(str(rec))
    assert [r["utt_id"] for r in kept] == sorted(r["utt_id"] for r in src)
    assert all(set(r) == set(CV.RECORD_KEYS) for r in kept)
    both = CV.compare(str(rec), os.path.join(EVIDENCE, "m5_beam_dev192.jsonl"))
    alone = CV.intervals(str(rec))
    assert {k: both[k] for k in alone} == alone
    assert both["wer_diff"] == 0.0 and both["tie"]


LONG_STEPS = 100


def _long_batch(i, vocab):
    """MC._batch's shape (3 utterances of up to 0.3 s and a pad row), its
    lengths and labels drawn anew for batch i."""
    rng = np.random.RandomState(100 + i)
    Bn, S, L = 3, 4800, 5
    audio = (rng.randn(Bn + 1, S) * 0.1).astype(np.float32)
    audio[Bn] = 0.0
    audio_len = np.array([S, rng.randint(S // 2, S + 1),
                          rng.randint(S // 3, S + 1), 0], np.int32)
    labels = rng.randint(4, vocab, size=(Bn + 1, L)).astype(np.int32)
    label_len = np.array([L, rng.randint(2, L + 1), rng.randint(1, L + 1), 0],
                         np.int32)
    labels[np.arange(L)[None, :] >= label_len[:, None]] = 0
    return {"audio": audio, "audio_len": audio_len, "labels": labels,
            "label_len": label_len}


def _long_cut(config):
    """MC._cut, and f32 compute where the config trains in bf16: over
    LONG_STEPS steps bf16's rounding, which XLA and PyTorch order
    differently, keeps rtol 1e-5 out of reach for ls100_full and
    flagship_bf16."""
    config = MC._cut(config)
    config.model.compute_dtype = "float32"
    return config


def _long_cmvn(config):
    """Global CMVN stats (ls100_full) for both packages' steps: phase 6e's
    seeded ones (chip_smoke.repro_cmvn); None for other CMVN modes."""
    stats = chip_smoke.repro_cmvn(torch, config, torch.device("cpu"))
    return None if stats is None else tuple(t.numpy() for t in stats)


@pytest.mark.parametrize("name", ["english_m5_bpe", "milestone5_beam",
                                  "ls100_full", "flagship_bf16"])
def test_port_trains_like_jax_over_many_steps(name):
    """LONG_STEPS train steps of the config at test widths (_long_cut: the
    bf16 configs, ls100_full and flagship_bf16, in f32) over 8
    batches in turn, from the same parameters, the JAX step's SpecAugment
    draws and coins fed to the port's: every step's loss within rtol 1e-5
    of JAX's (tests/test_torch_train_step.py's), and the parameters at the
    end within 1% of the largest learning rate of JAX's (the milestone
    test's bound for firm entries, here over every entry). ls100_full's
    tokenizer is its BPE 128 over the train texts of its corpus at its own
    scale (chip_smoke.ls100_full_manifest; no audio rendered), its global
    CMVN the seeded stats of _long_cmvn, given to both steps. Over 200 steps
    of english_m5_bpe the losses stayed within 2.6e-7 and the parameters
    within 1.9e-6 (the LR 2e-3)."""
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    config = _long_cut(load_config(path))
    jconfig = _long_cut(jax_load_config(path))
    if name == "ls100_full":
        tok = build_tokenizer(config, (u.text for u in
                                       chip_smoke.ls100_full_manifest(
                                           "train-clean-100")))
    else:
        tok = MC._tokenizer(config)
    V = tok.vocab_size
    batches = [_long_batch(i % 8, V) for i in range(LONG_STEPS)]
    cmvn = _long_cmvn(config)
    if cmvn is None:
        jmodel, tx, step = MC._jax_step(jconfig, V, tok.sos_id, tok.eos_id)
    else:
        jmodel = jax_build_model(jconfig, V, tok.sos_id, tok.eos_id)
        tx = jts.make_optimizer(jconfig)
        step = jts.make_train_step(jmodel, jconfig, tx,
                                   cmvn_stats=tuple(map(jnp.asarray, cmvn)))
    st = jts.create_train_state(
        jconfig, jmodel, tx, batches[0],
        cmvn_stats=None if cmvn is None else tuple(map(jnp.asarray, cmvn)))
    init = MC._flat(st.params)
    fc = config.frontend
    frames = num_frames(batches[0]["audio"].shape[1], fc.win_length,
                        fc.hop_length)
    L = batches[0]["labels"].shape[1] + 1
    jax_losses, draws = [], []
    for b in batches:
        _, step_rng = jax.random.split(st.rng)
        k_spec, k_ss, _ = jax.random.split(step_rng, 3)
        p_ss = T.ss_prob(config, int(st.step))
        coins = None
        if config.loss.mtl_alpha < 1.0 and p_ss > 0.0:
            c = np.array(jax.random.bernoulli(k_ss, p_ss, (L, len(b["audio"]))))
            c[0] = False
            coins = torch.from_numpy(c)
        draws.append((MC._jax_draws(k_spec, fc, len(b["audio"]), frames),
                      coins))
        st, m = step(st, {k: jnp.asarray(v) for k, v in b.items()})
        jax_losses.append(float(m["loss"]))
    jax_params = MC._flat(st.params)

    model = build_model(config, V, train=True, sos_id=tok.sos_id,
                        eos_id=tok.eos_id)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in init.items()})
    opt = T.make_optimizer(config)
    state = T.TrainState(step=0,
                         opt_state=opt.init(dict(model.named_parameters())),
                         generator=torch.Generator().manual_seed(0))
    fn = T.make_train_step(model, config, opt, None if cmvn is None else
                           tuple(map(torch.from_numpy, cmvn)))
    losses = []
    for b, (spec, coins) in zip(batches, draws):
        with mock.patch.object(T, "draw_spec_augment", lambda *a: spec), \
                mock.patch.object(T, "draw_coins", lambda *a: coins):
            losses.append(float(fn(state, {k: torch.from_numpy(v)
                                           for k, v in b.items()})["loss"]))
    np.testing.assert_allclose(losses, jax_losses, rtol=1e-5)
    assert losses[-1] < 0.8 * losses[0]  # it trained
    lr = max(opt.lr(i) for i in range(LONG_STEPS))
    for k, v in model.state_dict().items():
        np.testing.assert_allclose(v.numpy(), jax_params[k], rtol=0,
                                   atol=0.01 * lr, err_msg=k)


def _card_records():
    """(record, reference) of each committed record: the README's tables
    pair each record (first column) with every reference record in its
    row (the TPU run's under docs/evidence/, or another record of this
    directory), or with None where the row has none (its intervals
    alone)."""
    path = os.path.join(CARD_EVIDENCE, "README.md")
    if not os.path.exists(path):
        return []
    pairs = []
    with open(path) as f:
        for line in f:
            cells = [c.strip(" `") for c in line.split("|")]
            if len(cells) > 3 and cells[1].endswith(".jsonl"):
                refs = [r.strip(" `") for c in cells[2:] for r in c.split(",")]
                refs = [r for r in refs if r.endswith(".jsonl")]
                pairs += [(cells[1], r) for r in refs] or [(cells[1], None)]
    return pairs


def _fmt_ci(v, lo, hi, sign=False):
    f = "{:+.4f}" if sign else "{:.4f}"
    return f"{f.format(v)} [{f.format(lo)}, {f.format(hi)}]"


def _verdict(lo, hi, card=""):
    """A tie where the paired interval holds 0; a failure where it lies
    wholly above +10 points (phase 16's 2,700-utterance record: a fault
    above LS100_FULL_FAULT, +3 points); a gap otherwise."""
    word, above = (("fault", chip_smoke.LS100_FULL_FAULT)
                   if "_dev2700" in card else ("fail", 0.10))
    return "tie" if lo <= 0.0 <= hi else word if lo > above else "gap"


@pytest.mark.parametrize("card,tpu", _card_records())
def test_perf_numbers_recompute_from_the_records(card, tpu):
    """PERF.md's row of each committed record and its reference: the
    record's WER and CER with their 95% intervals, the reference's WER,
    and the paired difference with its interval, p(diff >= 0) and the
    verdict, as the root tools/wer_ci.py computes them from the two
    records (10,000 resamples, seed 0, paired by utt_id); a record with
    no reference, its intervals alone."""
    root = _root_ci()
    a = os.path.join(CARD_EVIDENCE, card)
    n = 2700 if "_dev2700" in card else 192
    if tpu is None:
        ca = root.per_utt_counts(a)
        assert len(ca) == n
        w, lw, hw, ce, lc, hc = root.bootstrap_ci(ca)
        cells = [card, _fmt_ci(w, lw, hw), _fmt_ci(ce, lc, hc)]
    else:
        b = os.path.join(CARD_EVIDENCE, tpu)
        if not os.path.exists(b):
            b = os.path.join(EVIDENCE, tpu)
        ca, cb = _paired(root, a, b)
        assert len(ca) == len(cb) == n
        w, lw, hw, ce, lc, hc = root.bootstrap_ci(ca)
        rw = root.bootstrap_ci(cb)[0]
        d, lo, hi, p = root.paired_diff_ci(ca, cb)
        cells = [card, _fmt_ci(w, lw, hw), _fmt_ci(ce, lc, hc), f"{rw:.4f}",
                 _fmt_ci(d, lo, hi, sign=True), f"{p:.4f}",
                 _verdict(lo, hi, card)]
    with open(os.path.join(REPO, "PERF.md")) as f:
        rows = [line for line in f if f"`{card}`" in line]
    assert rows, f"PERF.md has no row for {card}"
    assert any(all(c in row for c in cells) for row in rows), (cells, rows)
    with open(a) as f:
        first = json.loads(f.readline())
    assert set(first) == set(CV.RECORD_KEYS)


def _epoch_rows():
    """(record, its epochs file, the README's "best of epochs" cell) of
    each committed record that has its run's epoch lines beside it."""
    path = os.path.join(CARD_EVIDENCE, "README.md")
    rows = []
    with open(path) as f:
        for line in f:
            cells = [c.strip(" `") for c in line.split("|")]
            if len(cells) > 3 and cells[1].endswith(".jsonl"):
                epochs = cells[1][:-len(".jsonl")] + "_epochs.jsonl"
                best = [c for c in cells if " of " in c and
                        c.split(" of ")[0].isdigit()]
                if os.path.exists(os.path.join(CARD_EVIDENCE, epochs)):
                    rows.append((cells[1], epochs, best[0]))
    return rows


def test_every_epochs_file_belongs_to_a_record():
    named = {e for _, e, _ in _epoch_rows()}
    on_disk = {os.path.basename(p) for p in os.listdir(CARD_EVIDENCE)
               if p.endswith("_epochs.jsonl")}
    assert named == on_disk and len(on_disk) >= 3


@pytest.mark.parametrize("record,epochs,best", _epoch_rows())
def test_best_epoch_recomputes_from_the_epoch_lines(record, epochs, best):
    """The README's best epoch of a run is the first epoch of least dev
    WER in its epoch lines (the trainer's ``dev_wer < best_wer``), out of
    every epoch the run trained; each line carries its dev WER and CER
    and a mean training loss."""
    rows = CV.read_records(os.path.join(CARD_EVIDENCE, epochs))
    assert [r["epoch"] for r in rows] == list(range(len(rows)))
    wers = [r["dev_wer"] for r in rows]
    assert best == f"{wers.index(min(wers))} of {len(rows)}"
    for r in rows:
        assert r["dev_wer"] >= 0.0 and r["dev_cer"] >= 0.0
        loss = r.get("loss", r.get("loss_logged"))
        assert loss is not None and np.isfinite(loss)
