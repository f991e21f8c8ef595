"""PyTorch port: its own copies of the JAX package's jax-free modules
(the config schema, the data pipeline, the metrics, the JSONL logger)
against the originals, and the port importing nothing of the JAX package.

Every result must be identical: the same config fields and fingerprint
for every config of the repo, the same token ids, manifests, waveforms,
bucket batches (float32 and int16 transfer, with speed perturbation) and
error rates.
"""

import ast
import dataclasses
import glob
import os
import subprocess
import sys

import numpy as np
import pytest

from gluon_e2e_asr_tpu import config as jcfg
from gluon_e2e_asr_tpu.data import loader as jloader
from gluon_e2e_asr_tpu.data import manifest as jmanifest
from gluon_e2e_asr_tpu.data import sampler as jsampler
from gluon_e2e_asr_tpu.data import tokenizer as jtok
from gluon_e2e_asr_tpu.eval import metrics as jmetrics
from gluon_e2e_asr_tpu.utils import logging as jlogging
from gluon_e2e_asr_tpu_torch import config as tcfg
from gluon_e2e_asr_tpu_torch.data import loader as tloader
from gluon_e2e_asr_tpu_torch.data import manifest as tmanifest
from gluon_e2e_asr_tpu_torch.data import sampler as tsampler
from gluon_e2e_asr_tpu_torch.data import tokenizer as ttok
from gluon_e2e_asr_tpu_torch.eval import metrics as tmetrics
from gluon_e2e_asr_tpu_torch.utils import logging as tlogging

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs", "*.yaml"))
                 + [os.path.join(REPO, "tests", "goldens", "tiny_golden.yaml")])


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_config_files_load_the_same(path):
    ours, ref = tcfg.load_config(path), jcfg.load_config(path)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.fingerprint() == ref.fingerprint()


def test_config_defaults_and_overrides_match():
    ours, ref = tcfg.Config(), jcfg.Config()
    sets = ["model.att_type=dot", "loss.mtl_alpha=0.3", "train.dp=false",
            "data.speed_perturb=[0.9,1.0,1.1]"]
    tcfg.apply_overrides(ours, sets)
    jcfg.apply_overrides(ref, sets)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert ours.fingerprint() == ref.fingerprint()


def _utts(mod, text_mode, split="all", n=24):
    return mod.build_synthetic_manifest(n, 7, 3, 14, prefix="u",
                                        text_mode=text_mode, noise=0.05,
                                        jitter=0.05, split=split)


@pytest.mark.parametrize("text_mode,split", [("random", "all"),
                                             ("english", "train"),
                                             ("english", "dev")])
def test_synthetic_manifests_and_audio_match(text_mode, split):
    ours, ref = _utts(tmanifest, text_mode, split), _utts(jmanifest, text_mode, split)
    assert [dataclasses.asdict(u) for u in ours] == [dataclasses.asdict(u) for u in ref]
    for a, b in zip(ours[:4], ref[:4]):
        np.testing.assert_array_equal(tmanifest.load_audio(a),
                                      jmanifest.load_audio(b))


@pytest.mark.parametrize("kind", ["char", "bpe"])
def test_tokenizers_match(kind):
    texts = [u.text for u in _utts(jmanifest, "english", n=64)]
    if kind == "char":
        ours = ttok.CharTokenizer.build_from_texts(texts)
        ref = jtok.CharTokenizer.build_from_texts(texts)
    else:
        ours = ttok.SubwordTokenizer.build_from_texts(texts, 60)
        ref = jtok.SubwordTokenizer.build_from_texts(texts, 60)
    assert ours.to_json() == ref.to_json() and ours.fingerprint() == ref.fingerprint()
    for t in texts[:10]:
        assert ours.encode(t) == ref.encode(t)
        assert ours.decode(ours.encode(t)) == ref.decode(ref.encode(t))
    blob = ref.to_json()
    assert ttok.tokenizer_from_json(blob).to_json() == blob


@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_bucket_batches_match(transfer_dtype):
    """Two epochs of shuffled, speed-perturbed bucket batches."""
    built = {}
    for name, mf, sp, ld, tk in (
            ("port", tmanifest, tsampler, tloader, ttok),
            ("jax", jmanifest, jsampler, jloader, jtok)):
        utts = _utts(mf, "random", n=40)
        specs = sp.make_bucket_specs([1.0, 2.0], 16000, 8, 320, 160)
        tok = tk.CharTokenizer()
        sampler = sp.BucketSampler(utts, specs, 16000, seed=3, shuffle=True,
                                   speed_perturb=(0.9, 1.0, 1.1),
                                   perturb_seed=3)
        loader = ld.DataLoader(utts, sampler, tok, 16000,
                               speed_perturb=(0.9, 1.0, 1.1), perturb_seed=3,
                               transfer_dtype=transfer_dtype)
        built[name] = [b for e in (0, 1) for b in loader.epoch(e)]
        built[name + "_specs"] = [dataclasses.astuple(s) for s in specs]
    assert built["port_specs"] == built["jax_specs"]
    assert len(built["port"]) == len(built["jax"]) > 2
    for a, b in zip(built["port"], built["jax"]):
        assert a.bucket == b.bucket and a.utt_ids == b.utt_ids
        for k in ("audio", "audio_len", "labels", "label_len"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k), err_msg=k)
            assert getattr(a, k).dtype == getattr(b, k).dtype


def test_prefetched_epoch_matches_the_synchronous_one():
    utts = _utts(tmanifest, "random", n=30)
    specs = tsampler.make_bucket_specs([1.0, 2.0], 16000, 4, 320, 160)
    loader = tloader.DataLoader(utts, tsampler.BucketSampler(
        utts, specs, 16000, seed=1), ttok.CharTokenizer(), 16000)
    pre = loader.prefetch_epoch(0, depth=2)
    try:
        got = [b for _, b in pre]
    finally:
        pre.close()
    for a, b in zip(got, loader.epoch(0)):
        np.testing.assert_array_equal(a.audio, b.audio)
        assert a.utt_ids == b.utt_ids


def test_metrics_match():
    rng = np.random.RandomState(0)
    words = ["a", "bb", "cat", "dog", "eel", "fox"]
    refs = [" ".join(rng.choice(words, rng.randint(1, 8))) for _ in range(30)]
    hyps = [" ".join(rng.choice(words, rng.randint(0, 8))) for _ in range(30)]
    assert tmetrics.wer(refs, hyps) == jmetrics.wer(refs, hyps)
    assert tmetrics.cer(refs, hyps) == jmetrics.cer(refs, hyps)
    for unit in ("word", "char"):
        assert tmetrics.error_report(refs, hyps, unit) == \
            jmetrics.error_report(refs, hyps, unit)
    lat = list(rng.rand(17))
    for q in (50, 90, 99):
        assert tlogging.percentile(lat, q) == jlogging.percentile(lat, q)


# Copied file -> the top-level definitions (``Class.method`` for methods)
# that differ from the original on purpose: where the port builds its
# native library (``build/native/`` at the root of the checkout) and that
# a failed build raises with the compiler's stderr (the JAX ``get_lib``
# returns None); the FLOP count's peaks, which are the H100's and take no
# environment override (the JAX ones are TPU v5e's, with an env hook).
COPIES = {
    "config.py": set(),
    "data/sampler.py": set(),
    "data/tokenizer.py": set(),
    "data/loader.py": set(),
    "data/manifest.py": set(),
    "eval/metrics.py": set(),
    "utils/flops.py": {"PEAK_TFLOPS", "peak_tflops"},
    "utils/logging.py": set(),
    "utils/native.py": {"_BUILD_DIR", "_lib_path", "_prune_stale",
                        "_build_failed", "_build_error", "_build", "get_lib"},
}


def _definitions(path: str, package: str) -> dict:
    """Top-level name -> AST dump without docstrings, the package's name
    replaced by the JAX package's."""
    with open(path) as f:
        src = f.read().replace(package, "gluon_e2e_asr_tpu")
    tree = ast.parse(src)
    for n in ast.walk(tree):
        body = getattr(n, "body", None)
        if (isinstance(n, (ast.Module, ast.FunctionDef, ast.ClassDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            n.body = body[1:] or [ast.Pass()]
    out = {}
    for n in tree.body:
        if isinstance(n, ast.ClassDef):
            for m in n.body:
                if isinstance(m, ast.FunctionDef):
                    out[f"{n.name}.{m.name}"] = ast.dump(m)
            n.body = [m for m in n.body if not isinstance(m, ast.FunctionDef)]
            out[n.name] = ast.dump(n)
        elif isinstance(n, ast.FunctionDef):
            out[n.name] = ast.dump(n)
        elif isinstance(n, (ast.Assign, ast.AnnAssign)):
            targets = n.targets if isinstance(n, ast.Assign) else [n.target]
            out[",".join(ast.unparse(t) for t in targets)] = ast.dump(n)
    return out


@pytest.mark.parametrize("rel", sorted(COPIES) + ["data/english_pool.txt",
                                                 "native/asr_native.cpp"])
def test_copied_files_match_their_originals(rel):
    """The cheapest guard against the copies drifting: the word pool and
    the native library's source byte for byte, and every definition of
    each module the same code as the original's, apart from the listed
    ones (and those must still differ)."""
    ours = os.path.join(REPO, "gluon_e2e_asr_tpu_torch", rel)
    ref = os.path.join(REPO, "gluon_e2e_asr_tpu", rel)
    if not rel.endswith(".py"):
        with open(ours, "rb") as a, open(ref, "rb") as b:
            assert a.read() == b.read()
        return
    a = _definitions(ours, "gluon_e2e_asr_tpu_torch")
    b = _definitions(ref, "gluon_e2e_asr_tpu")
    assert len(a) > 1
    differ = {k for k in set(a) | set(b) if a.get(k) != b.get(k)}
    assert differ == COPIES[rel]


@pytest.fixture(scope="module")
def flac_corpus(tmp_path_factory):
    """A LibriSpeech FLAC tree rendered by the root tools/make_synth_corpus.py
    (LibriSpeech durations, English text, the native encoder)."""
    root = str(tmp_path_factory.mktemp("ls_flac"))
    subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "make_synth_corpus.py"),
         "--out", root, "--num-train", "12", "--num-dev", "4",
         "--text-mode", "english", "--durations", "librispeech",
         "--jitter", "0.04", "--noise", "0.05", "--pool-split", "sentence",
         "--workers", "1", "--seed", "0"],
        check=True, capture_output=True, timeout=300, cwd=REPO,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    return root


@pytest.mark.parametrize("split", ["train-clean-100", "dev-clean"])
def test_flac_manifest_matches(flac_corpus, split):
    ours = tmanifest.build_librispeech_manifest(flac_corpus, split)
    ref = jmanifest.build_librispeech_manifest(flac_corpus, split)
    assert len(ours) == len(ref) > 0
    assert all(u.audio_path.endswith(".flac") for u in ours)
    assert [dataclasses.asdict(u) for u in ours] == \
        [dataclasses.asdict(u) for u in ref]
    for a, b in zip(ours[:3], ref[:3]):
        np.testing.assert_array_equal(tmanifest.load_audio(a),
                                      jmanifest.load_audio(b))


@pytest.mark.parametrize("perturb", [False, True], ids=["plain", "perturbed"])
@pytest.mark.parametrize("transfer_dtype", ["float32", "int16"])
def test_flac_bucket_batches_match(flac_corpus, transfer_dtype, perturb):
    """ls100's buckets over the FLAC tree: the fused native route of both
    packages, and the port's Python route, give the same batches."""
    sp = (0.9, 1.0, 1.1) if perturb else ()
    built = {}
    for name, mf, smp, ld, tk, native in (
            ("port", tmanifest, tsampler, tloader, ttok, True),
            ("port_python", tmanifest, tsampler, tloader, ttok, False),
            ("jax", jmanifest, jsampler, jloader, jtok, True)):
        utts = mf.build_librispeech_manifest(flac_corpus, "train-clean-100")
        specs = smp.make_bucket_specs([9.2, 12.37, 15.04, 18.38], 16000, 4,
                                      320, 160, True)
        sampler = smp.BucketSampler(utts, specs, 16000, seed=0, shuffle=True,
                                    sortagrad_epochs=1, speed_perturb=sp,
                                    perturb_seed=0)
        loader = ld.DataLoader(utts, sampler, tk.CharTokenizer(), 16000,
                               speed_perturb=sp, perturb_seed=0,
                               transfer_dtype=transfer_dtype,
                               use_native=native)
        built[name] = [b for e in (0, 1) for b in loader.epoch(e)]
        if native:
            assert loader._native_wav is not None
            assert loader._native_wav_failures == 0
    assert len(built["port"]) == len(built["jax"]) > 2
    for other in ("jax", "port_python"):
        for a, b in zip(built["port"], built[other]):
            assert a.bucket == b.bucket and a.utt_ids == b.utt_ids
            for k in ("audio", "audio_len", "labels", "label_len"):
                np.testing.assert_array_equal(getattr(a, k), getattr(b, k),
                                              err_msg=f"{other} {k}")
                assert getattr(a, k).dtype == getattr(b, k).dtype


def test_the_port_imports_nothing_of_the_jax_package():
    """Every module of the port, and chip_smoke.py, in a process where
    importing jax, flax or the JAX package fails."""
    code = (
        "import importlib, pkgutil, sys\n"
        "for m in ('jax', 'flax', 'gluon_e2e_asr_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import gluon_e2e_asr_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, "
        "pkg.__name__ + '.')]\n"
        "for name in names + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and\n"
        "       (m.split('.')[0] in ('jax', 'flax', 'gluon_e2e_asr_tpu'))]\n"
        "assert not bad, bad\n"
        "print(' '.join(names))\n"
        "print(len(names))\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=300, cwd=REPO,
                          env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split()[-1]) >= 20
    for name in ("models.lm", "train_lm", "transcribe", "tools.align",
                 "tools.rescore_nbest", "tools.make_lm_corpus",
                 "utils.native", "tools.make_synth_corpus",
                 "tools.compute_cmvn", "tools.average_ckpts",
                 "tools.tune_decode", "tools.plot_attention", "utils.flops",
                 "tools.run_milestones", "tools.wer_ci",
                 "tools.convergence"):
        assert f"gluon_e2e_asr_tpu_torch.{name}" in proc.stdout, name
