"""PyTorch port: its tools against the root tools/*.py of the JAX package,
on the same inputs, on the CPU.

- ``make_synth_corpus``: the same file tree, transcripts and FLAC bytes
  from the same seed;
- ``compute_cmvn`` on a small FLAC corpus, float32 and int16 transfer:
  the stats within 1e-5 relative, and the int16 stats equal to the
  float32 ones (the dequant before the log-mel);
- ``average_ckpts``: bridged checkpoints averaged against JAX's average
  of the originals, bridged, within 1e-7; the result restores as a
  training checkpoint and as a decoding one; ``ordered_best_ckpts``;
  fewer than two inputs raise;
- ``tune_decode``: ``_parse_grid``, ``in_holdout`` and a sweep on the
  blessed tiny golden: the same records and the same best;
- ``plot_attention``: the teacher-forced matrices against JAX's within
  1e-5, dot and loc attention, and the CLI's ``.npy`` files on the
  golden;
- ``run_milestones`` with ``CONFIGS`` set to a tiny config: its
  ``milestone_done`` and ``all_milestones`` lines.
"""

import dataclasses
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu_torch.bridge import params_from_jax, read_jax_checkpoint
from gluon_e2e_asr_tpu_torch.tools import (
    average_ckpts, compute_cmvn, make_synth_corpus, plot_attention,
    run_milestones, tune_decode)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
GOLDEN_YAML = os.path.join(GOLD, "tiny_golden.yaml")
GOLDEN_CKPT = os.path.join(GOLD, "tiny_golden.msgpack")


def _root_tool(name):
    """A root tools/<name>.py of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


CORPUS_FLAGS = ["--num-train", "10", "--num-dev", "4", "--text-mode",
                "english", "--durations", "librispeech", "--jitter", "0.04",
                "--noise", "0.05", "--pool-split", "sentence", "--workers",
                "1", "--seed", "0"]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same flags through the port's tool and the root one."""
    root = tmp_path_factory.mktemp("corpora")
    ours, ref = str(root / "port"), str(root / "jax")
    summary = make_synth_corpus.main(["--out", ours, *CORPUS_FLAGS])
    _root_tool("make_synth_corpus").main(["--out", ref, *CORPUS_FLAGS])
    return ours, ref, summary


def _tree(root):
    out = {}
    for d, _, files in os.walk(root):
        for fn in files:
            p = os.path.join(d, fn)
            with open(p, "rb") as f:
                out[os.path.relpath(p, root)] = f.read()
    return out


def test_make_synth_corpus_writes_the_root_tools_files(corpora):
    ours, ref, summary = corpora
    a, b = _tree(ours), _tree(ref)
    assert sorted(a) == sorted(b)
    assert sum(k.endswith(".flac") for k in a) == 14
    assert any(k.startswith("dev-clean/900/1000/") for k in a)
    for k in a:
        assert a[k] == b[k], k
    assert summary["num_train"] == 10 and summary["hours"] > 0


def _ls_config(tmp_path, corpus, transfer_dtype):
    """ls100_full.yaml's data and frontend on ``corpus``, at batch 4."""
    from gluon_e2e_asr_tpu_torch.config import load_config

    cfg = load_config(os.path.join(REPO, "configs", "ls100_full.yaml"))
    cfg.data.data_dir = corpus
    cfg.data.batch_size = 4
    cfg.data.transfer_dtype = transfer_dtype
    path = str(tmp_path / f"ls_{transfer_dtype}.yaml")
    with open(path, "w") as f:  # JSON is YAML
        json.dump(dataclasses.asdict(cfg), f)
    return path


def test_compute_cmvn_matches_the_root_tool(corpora, tmp_path):
    corpus = corpora[0]
    stats = {}
    for td in ("float32", "int16"):
        cfg = _ls_config(tmp_path, corpus, td)
        ours = str(tmp_path / f"port_{td}.npz")
        ref = str(tmp_path / f"jax_{td}.npz")
        out = compute_cmvn.main(["--config", cfg, "--output", ours,
                                 "--device", "cpu"])
        _root_tool("compute_cmvn").main(["--config", cfg, "--output", ref])
        a, b = np.load(ours), np.load(ref)
        assert sorted(a.files) == sorted(b.files) == ["mean", "std"]
        for k in ("mean", "std"):
            assert a[k].dtype == np.float32 and a[k].shape == (80,)
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, atol=0)
        assert np.all(a["std"] > 0) and np.all(np.isfinite(a["mean"]))
        assert out["frames"] > 1000
        stats[td] = a
    # int16 transfer dequantizes before the log-mel: no log(2^30) shift
    for k in ("mean", "std"):
        np.testing.assert_allclose(stats["int16"][k], stats["float32"][k],
                                   rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """Two JAX trainer checkpoints: the golden, and the golden with every
    parameter moved by seeded noise (a later step, with a dev WER)."""
    import flax.serialization

    d = tmp_path_factory.mktemp("jax_ckpts")
    with open(GOLDEN_CKPT, "rb") as f:
        payload = flax.serialization.msgpack_restore(f.read())
    with open(GOLDEN_CKPT + ".json") as f:
        meta = json.load(f)
    rng = np.random.RandomState(0)

    def moved(t):
        if isinstance(t, dict):
            return {k: moved(v) for k, v in t.items()}
        return (t + rng.randn(*t.shape).astype(t.dtype) * 0.1).astype(t.dtype)

    paths = []
    for i, (step, wer) in enumerate(((100, 0.5), (200, 0.25))):
        p = dict(payload)
        if i:
            p["state"] = dict(payload["state"], params=moved(
                payload["state"]["params"]))
        path = str(d / f"ckpt_{step}.msgpack")
        with open(path, "wb") as f:
            f.write(flax.serialization.msgpack_serialize(p))
        with open(path + ".json", "w") as f:
            json.dump(dict(meta, step=step, dev_wer=wer), f)
        paths.append(path)
    return paths


def _port_ckpt(jax_path, out_dir):
    """The JAX checkpoint bridged into a port trainer checkpoint (with an
    Adam state and a generator state)."""
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.training.checkpoint import save_checkpoint
    from gluon_e2e_asr_tpu_torch.training.train_step import make_optimizer

    tree, cmvn, meta = read_jax_checkpoint(jax_path)
    params = params_from_jax(tree)
    opt = make_optimizer(load_config(GOLDEN_YAML))
    step = int(meta["step"])
    path = os.path.join(out_dir, f"ckpt_{step}.pt")
    save_checkpoint(path, params, meta, cmvn, opt_state=opt.init(params),
                    step=step,
                    generator=torch.Generator().manual_seed(step).get_state())
    return path


def test_average_ckpts_matches_the_root_tools_average(jax_ckpts, tmp_path):
    from gluon_e2e_asr_tpu_torch.decode import restore_model
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.training.checkpoint import (
        restore_params, restore_train_checkpoint)
    from gluon_e2e_asr_tpu_torch.training.train_step import make_optimizer

    ours = [_port_ckpt(p, str(tmp_path)) for p in jax_ckpts]
    ref_out = str(tmp_path / "avg.msgpack")
    _root_tool("average_ckpts").average_checkpoints(jax_ckpts, ref_out)
    out = str(tmp_path / "avg.pt")
    summary = average_ckpts.main(["--out", out, "--last", "2",
                                  "--ckpt-dir", str(tmp_path)])
    assert summary["inputs"] == ["ckpt_100.pt", "ckpt_200.pt"]
    assert summary["step"] == 200
    want = params_from_jax(read_jax_checkpoint(ref_out)[0])
    got, _, meta = restore_params(out)
    assert meta["averaged_from"] == summary["inputs"]
    assert meta["dev_wer"] == 0.25
    inputs = [restore_params(p)[0] for p in ours]
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                   rtol=0, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(
            got[k].double().numpy(),
            (inputs[0][k].double() + inputs[1][k].double()).numpy() / 2,
            rtol=0, atol=1e-7, err_msg=k)
    # a training checkpoint: the newest input's step, optimizer state and
    # generator state; and a decoding one
    opt = make_optimizer(load_config(GOLDEN_YAML))
    ck = restore_train_checkpoint(out, opt.init(got))
    newest = restore_train_checkpoint(ours[-1], opt.init(got))
    assert ck.step == 200 and torch.equal(ck.generator, newest.generator)
    model, cmvn, tok = restore_model(load_config(GOLDEN_YAML), out,
                                     torch.device("cpu"))
    for k, v in model.state_dict().items():
        torch.testing.assert_close(v, got[k], rtol=0, atol=0)
    assert tok.to_json() == meta["vocab"]


def test_ordered_ckpts_and_too_few_inputs(jax_ckpts, tmp_path):
    ours = [_port_ckpt(p, str(tmp_path)) for p in jax_ckpts]
    with open(os.path.join(str(tmp_path), "ckpt_300.pt.json"), "w") as f:
        f.write("{torn")  # a torn sidecar is left out, not fatal
    with open(os.path.join(str(tmp_path), "ckpt_300.pt"), "wb") as f:
        f.write(b"")
    assert average_ckpts.ordered_best_ckpts(str(tmp_path), 1) == [ours[1]]
    assert average_ckpts.ordered_best_ckpts(str(tmp_path), 5) == ours
    assert average_ckpts.ordered_last_ckpts(str(tmp_path), 2)[0] == ours[1]
    with pytest.raises(ValueError, match=">= 2"):
        average_ckpts.average_checkpoints(ours[:1], str(tmp_path / "x.pt"))
    with pytest.raises(SystemExit):
        average_ckpts.main(["--out", "x.pt", "--last", "2"])


def test_tune_decode_grid_and_holdout_match_the_root_tool():
    ref = _root_tool("tune_decode")
    items = ["ctc_weight=0.0,0.3", "beam_size=4,8", "length_norm=true,False"]
    assert tune_decode._parse_grid(items) == ref._parse_grid(items)
    assert tune_decode._parse_grid(items)["length_norm"] == [True, False]
    with pytest.raises(SystemExit):
        tune_decode._parse_grid(["oops"])
    ids = [f"dev-{i:05d}" for i in range(400)]
    for frac in (0.0, 0.3, 0.5, 1.0):
        assert [tune_decode.in_holdout(u, frac) for u in ids] == \
            [ref.in_holdout(u, frac) for u in ids]


def test_tune_decode_sweep_matches_the_root_tool(tmp_path, capsys):
    args = ["--config", GOLDEN_YAML, "--ckpt", GOLDEN_CKPT,
            "--grid", "ctc_weight=0.0,0.5", "--grid", "beam_size=2"]
    want = _root_tool("tune_decode").main(
        args + ["--output", str(tmp_path / "j.jsonl")])
    got = tune_decode.main(args + ["--output", str(tmp_path / "p.jsonl"),
                                   "--device", "cpu"])
    capsys.readouterr()
    assert got == want
    rows = [json.loads(x) for x in open(tmp_path / "p.jsonl")]
    assert rows == [json.loads(x) for x in open(tmp_path / "j.jsonl")]
    assert len(rows) == 3 and rows[-1]["event"] == "tune_decode_done"
    assert {r["tune_n"] + r["holdout_n"] for r in rows[:2]} == {16}


@pytest.mark.parametrize("att_type", ["dot", "loc"])
def test_attention_maps_match_the_root_tool(tmp_path, att_type):
    """The same batch and parameters (JAX's init, bridged): the
    teacher-forced matrices within 1e-5, each valid row a distribution."""
    import jax
    from gluon_e2e_asr_tpu.config import (
        Config, DataConfig, FrontendConfig, LossConfig, ModelConfig,
        TrainConfig)
    from gluon_e2e_asr_tpu.data.loader import DataLoader
    from gluon_e2e_asr_tpu.data.manifest import build_synthetic_manifest
    from gluon_e2e_asr_tpu.data.sampler import BucketSampler, make_bucket_specs
    from gluon_e2e_asr_tpu.data.tokenizer import CharTokenizer
    from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model
    from gluon_e2e_asr_tpu.training.train_step import (
        create_train_state, make_optimizer)
    from gluon_e2e_asr_tpu_torch.config import load_config
    from gluon_e2e_asr_tpu_torch.models.asr import build_model

    cfg = Config(
        data=DataConfig(dataset="synthetic", synth_num_train=4,
                        synth_max_tokens=5, batch_size=4,
                        bucket_bounds_sec=(1.5,)),
        frontend=FrontendConfig(specaug_freq_masks=0, specaug_time_masks=0),
        model=ModelConfig(enc_hidden=16, enc_layers=2, enc_subsample=(1, 2),
                          dec_hidden=16, dec_embed=8, att_dim=8,
                          att_type=att_type, loc_conv_channels=4,
                          loc_conv_width=11),
        loss=LossConfig(mtl_alpha=0.3),
        train=TrainConfig(seed=0),
    )
    tok = CharTokenizer()
    utts = build_synthetic_manifest(4, seed=0, max_tokens=5)
    specs = make_bucket_specs(cfg.data.bucket_bounds_sec, 16000, 4, 16)
    loader = DataLoader(utts, BucketSampler(utts, specs, 16000, seed=0,
                                            shuffle=False), tok)
    b = next(iter(loader.epoch(0)))
    batch = {"audio": b.audio, "audio_len": b.audio_len,
             "labels": b.labels, "label_len": b.label_len}
    jmodel = jax_build_model(cfg, tok.vocab_size, tok.sos_id, tok.eos_id)
    state = create_train_state(cfg, jmodel, make_optimizer(cfg), batch)
    want, want_len = _root_tool("plot_attention").attention_maps(
        jmodel, state.params, cfg, batch)

    path = str(tmp_path / "cfg.yaml")
    with open(path, "w") as f:  # JSON is YAML
        json.dump(dataclasses.asdict(cfg), f)
    pcfg = load_config(path)
    model = build_model(pcfg, tok.vocab_size, sos_id=tok.sos_id,
                        eos_id=tok.eos_id)
    model.load_state_dict(params_from_jax(
        jax.tree_util.tree_map(np.asarray, state.params)))
    got, got_len = plot_attention.attention_maps(model.eval(), pcfg, batch)
    np.testing.assert_array_equal(got_len, want_len)
    assert got.shape == want.shape == (4, b.labels.shape[1] + 1,
                                       got.shape[-1])
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)
    for row in range(len(b.utt_ids)):
        T = int(got_len[row])
        np.testing.assert_allclose(got[row, :, :T].sum(-1), 1.0, atol=1e-5)
        assert np.abs(got[row, :, T:]).max() == 0.0


def test_plot_attention_cli_matches_the_root_tool(tmp_path, capsys):
    args = ["--config", GOLDEN_YAML, "--ckpt", GOLDEN_CKPT, "--num", "3",
            "--no-png"]
    _root_tool("plot_attention").main(args + ["--out", str(tmp_path / "j")])
    summary = plot_attention.main(args + ["--out", str(tmp_path / "p"),
                                          "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert json.loads(lines[0])["utts"] == summary["utts"]
    assert len(summary["utts"]) == 3 and not summary["png"]
    for u in summary["utts"]:
        a = np.load(tmp_path / "p" / f"{u}.npy")
        b = np.load(tmp_path / "j" / f"{u}.npy")
        assert a.shape == b.shape and a.shape[0] > 1
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
        np.testing.assert_allclose(a.sum(-1), 1.0, atol=1e-5)
    assert not list((tmp_path / "p").glob("*.png"))


def test_run_milestones_prints_its_lines(tmp_path, capsys, monkeypatch):
    cfg = str(tmp_path / "tiny.yaml")
    with open(GOLDEN_YAML) as f:
        text = f.read()
    with open(cfg, "w") as f:
        f.write(text.replace("num_epochs: 150", "num_epochs: 1")
                .replace("synth_num_train: 32", "synth_num_train: 8")
                .replace("synth_num_dev: 16", "synth_num_dev: 4")
                .replace("ckpt_dir: ckpts_golden",
                         f"ckpt_dir: ckpts_golden\n  metrics_path: "
                         f"{tmp_path / 'metrics.jsonl'}")
                .replace("method: beam", "method: greedy"))
    monkeypatch.setattr(run_milestones, "CONFIGS", [("m1", cfg),
                                                    ("m9", cfg)])
    results = run_milestones.main(["--workdir", str(tmp_path / "ms"),
                                   "--only", "1", "--device", "cpu"])
    out = capsys.readouterr().out
    done = [json.loads(x) for x in out.splitlines()
            if x.startswith('{"event": "milestone_done"')]
    assert [d["milestone"] for d in done] == ["m1"] and len(results) == 1
    assert done[0]["method"] == "greedy" and 0 <= done[0]["dev_cer"]
    assert '"event": "all_milestones"' in out
    assert os.path.exists(tmp_path / "ms" / "m1" / "ckpts_golden" / "best.pt")
