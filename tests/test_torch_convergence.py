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
- the port's train step against the JAX package's over LONG_STEPS steps
  of english_m5_bpe and milestone5_beam at test widths (the plain
  versions, the same draws): the longest comparison of training the CPU
  allows in a test, where rounding could drift that 2 steps cannot show;
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
from gluon_e2e_asr_tpu.training import train_step as jts  # noqa: E402
from gluon_e2e_asr_tpu_torch.config import apply_overrides, load_config  # noqa: E402
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


def test_ls100_full_epochs_equal_the_tpu_table():
    """ls100_full.yaml's sampler over its corpus at its own scale (the
    texts and durations drawn without rendering any audio): 101.3 h, under
    11.7 GB of 16-bit PCM, and each of its 5 epochs' steps and pad waste
    (1 - real samples after speed perturbation over the batches' padded
    samples, as the trainer counts it) equal to the TPU run's epoch table:
    the port's sampler is the JAX one's copy, both at world size 1."""
    from gluon_e2e_asr_tpu_torch.data import sampler as S

    config = load_config(chip_smoke.LS100_CONFIG)
    dc, sr = config.data, config.data.sample_rate
    utts = chip_smoke.ls100_full_manifest("train-clean-100")
    dev = chip_smoke.ls100_full_manifest("dev-clean")
    samples = [round(u.duration * sr) for u in utts]
    pcm = 2 * (sum(samples) + sum(round(u.duration * sr) for u in dev))
    assert len(utts) == 28500 and round(pcm / 2 / sr / 3600, 1) == 101.3
    assert pcm < 11.7e9
    specs = S.make_bucket_specs(dc.bucket_bounds_sec, sr, dc.batch_size,
                                dc.max_label_len, config.frontend.hop_length,
                                dc.dynamic_batch)
    sp = tuple(dc.speed_perturb)
    seed = config.train.seed
    factor = functools.lru_cache(maxsize=None)(S.perturb_factor)
    with mock.patch.object(S, "perturb_factor", factor):
        sampler = S.BucketSampler(
            utts, specs, sr, seed=seed, shuffle=dc.shuffle,
            drop_last=dc.drop_last, sortagrad_epochs=dc.sortagrad_epochs,
            speed_perturb=sp, perturb_seed=seed,
            static_placement=dc.static_placement)
        steps, waste = [], []
        for e in range(config.train.num_epochs):
            real = padded = n = 0
            for b, idxs in sampler.epoch_batches(e):
                spec = specs[b]
                n += 1
                padded += spec.batch_size * spec.max_samples
                for i in idxs:
                    f = factor(seed, e, i, sp)
                    real += (samples[i] if f == 1.0 else
                             min(int(round(samples[i] / f)), spec.max_samples))
            steps.append(n)
            waste.append(round(1.0 - real / padded, 4))
    assert not sampler.skipped
    tpu = chip_smoke.LS100_FULL_TPU
    assert tuple(steps) == tpu["steps"] and tuple(waste) == tpu["pad_waste"]


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


@pytest.mark.parametrize("name", ["english_m5_bpe", "milestone5_beam"])
def test_port_trains_like_jax_over_many_steps(name):
    """LONG_STEPS train steps of the config at test widths (MC._cut) over 8
    batches in turn, from the same parameters, the JAX step's SpecAugment
    draws and coins fed to the port's: every step's loss within rtol 1e-5
    of JAX's (tests/test_torch_train_step.py's), and the parameters at the
    end within 1% of the largest learning rate of JAX's (the milestone
    test's bound for firm entries, here over every entry). Over 200 steps
    of english_m5_bpe the losses stayed within 2.6e-7 and the parameters
    within 1.9e-6 (the LR 2e-3)."""
    path = os.path.join(REPO, "configs", f"{name}.yaml")
    config = MC._cut(load_config(path))
    jconfig = MC._cut(jax_load_config(path))
    tok = MC._tokenizer(config)
    V = tok.vocab_size
    batches = [_long_batch(i % 8, V) for i in range(LONG_STEPS)]
    jmodel, tx, step = MC._jax_step(jconfig, V, tok.sos_id, tok.eos_id)
    st = jts.create_train_state(jconfig, jmodel, tx, batches[0])
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
    fn = T.make_train_step(model, config, opt)
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
