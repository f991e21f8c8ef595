"""PyTorch port: the weight bridge, the port's checkpoints and the decode
CLI on the blessed tiny golden.

The golden checkpoint (a hybrid model: encoder, CTC head and an
add-attention decoder) is read through the JAX package's own
``restore_checkpoint`` (with the decode CLI's restore template), bridged
to the port whole, saved with the port's checkpoint module and decoded
by the port's CLI on the CPU, greedily and with the batched beam: every
hypothesis of ``golden_greedy.jsonl`` and ``golden_beam.jsonl`` must come
back exactly, the beam's scores within 1e-4 (``tools/fidelity_diff.py``'s
tolerance). One run of each does so in a process where importing jax,
flax or the JAX package fails.
"""

import importlib.util
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import load_config
from gluon_e2e_asr_tpu.data.loader import DataLoader
from gluon_e2e_asr_tpu.data.sampler import BucketSampler, make_bucket_specs
from gluon_e2e_asr_tpu.data.tokenizer import tokenizer_from_json
from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model
from gluon_e2e_asr_tpu.training.checkpoint import (
    restore_checkpoint as jax_restore)
from gluon_e2e_asr_tpu.training.train_step import (
    create_template_state, make_optimizer)
from gluon_e2e_asr_tpu.training.trainer import build_datasets as jax_datasets
from gluon_e2e_asr_tpu_torch import decode
from gluon_e2e_asr_tpu_torch.bridge import (
    params_from_jax, params_to_jax, read_jax_checkpoint)
from gluon_e2e_asr_tpu_torch.models.asr import build_model
from gluon_e2e_asr_tpu_torch.training.checkpoint import (
    restore_checkpoint, save_checkpoint)
from gluon_e2e_asr_tpu_torch.training.trainer import build_datasets

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLD = os.path.join(REPO, "tests", "goldens")
CONFIG = os.path.join(GOLD, "tiny_golden.yaml")

_spec = importlib.util.spec_from_file_location(
    "fidelity_diff", os.path.join(REPO, "tools", "fidelity_diff.py"))
fidelity_diff = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(fidelity_diff)


def _golden_jax():
    """(params as nested numpy dicts, cmvn, meta) of the golden, restored
    the way the JAX decode CLI restores it."""
    config = load_config(CONFIG)
    with open(os.path.join(GOLD, "tiny_golden.msgpack.json")) as f:
        tok = tokenizer_from_json(json.load(f)["vocab"])
    _, dev = jax_datasets(config)
    specs = make_bucket_specs(
        config.data.bucket_bounds_sec, config.data.sample_rate,
        config.data.batch_size, config.data.max_label_len,
        config.frontend.hop_length, config.data.dynamic_batch)
    first = next(iter(DataLoader(
        dev, BucketSampler(dev, specs, config.data.sample_rate, seed=0,
                           shuffle=False),
        tok, config.data.sample_rate).epoch(0)))
    model = jax_build_model(config, tok.vocab_size, tok.sos_id, tok.eos_id)
    template = create_template_state(
        config, model, make_optimizer(config),
        {"audio": first.audio, "audio_len": first.audio_len,
         "labels": first.labels, "label_len": first.label_len})
    state, cmvn, meta = jax_restore(os.path.join(GOLD, "tiny_golden.msgpack"),
                                    template, params_only=True)
    return jax.tree_util.tree_map(np.asarray, state.params), cmvn, meta


@pytest.fixture(scope="module")
def golden():
    return _golden_jax()


@pytest.fixture(scope="module")
def port_ckpt(golden, tmp_path_factory):
    params, cmvn, meta = golden
    path = str(tmp_path_factory.mktemp("ckpt") / "golden.pt")
    return save_checkpoint(path, params_from_jax(params), meta, cmvn)


def test_bridge_round_trip_is_bit_exact(golden):
    """Every leaf comes back bit for bit, the add-attention decoder's
    included, and the port's model loads the bridged state strictly."""
    params = golden[0]
    assert set(params["decoder"]) >= {"att_b", "att_v", "embed", "out_w"}
    state = params_from_jax(params)
    back = params_to_jax(state)
    assert set(back) == {"encoder", "decoder"}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == leaf.dtype and node.shape == leaf.shape
        assert node.tobytes() == np.asarray(leaf).tobytes()
    config = load_config(CONFIG)
    vocab = params["decoder"]["embed"].shape[0]
    build_model(config, vocab).load_state_dict(state)


def test_jax_checkpoint_reader_matches_flax(golden):
    """``read_jax_checkpoint`` (the port's own msgpack reader) returns the
    golden's parameters bit for bit as the JAX package restores them, its
    cmvn and its sidecar."""
    params, cmvn, meta = golden
    got, got_cmvn, got_meta = read_jax_checkpoint(
        os.path.join(GOLD, "tiny_golden.msgpack"))
    assert got_meta == meta and got_cmvn is None and cmvn is None
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(got))
    for path, leaf in flat:
        node = got
        for k in path:
            node = node[k.key]
        assert node.dtype == leaf.dtype and node.shape == leaf.shape
        assert node.tobytes() == np.asarray(leaf).tobytes()


@pytest.mark.parametrize("tree,match", [
    ({"encoder": {"l0_in_v": np.zeros(1)}}, "l0_in_v"),
    ({"encoder": {"vgg": {"conv1_1": {}}}}, "vgg"),
    ({"encoder": {"ctc_head": {"kernel": np.zeros(1)}}}, "ctc_head"),
    ({"lm": {}}, "lm"),
    ({"decoder": {"att_w": np.zeros(1)}}, "att_w"),
    ({"decoder": {"embed": {"kernel": np.zeros(1)}}}, "subtree"),
])
def test_bridge_unknown_keys_raise(tree, match):
    with pytest.raises(KeyError, match=match):
        params_from_jax(tree)


def test_checkpoint_round_trip(tmp_path):
    params = {"encoder.l0_in_w": torch.randn(3, 4)}
    cmvn = (np.arange(3, dtype=np.float32), np.ones(3, np.float32))
    path = save_checkpoint(str(tmp_path / "c.pt"), params,
                           {"vocab": "v", "config_hash": "h"}, cmvn)
    p2, c2, meta = restore_checkpoint(path)
    assert torch.equal(p2["encoder.l0_in_w"], params["encoder.l0_in_w"])
    np.testing.assert_array_equal(c2[0].numpy(), cmvn[0])
    assert meta == {"vocab": "v", "config_hash": "h"}
    assert not os.path.exists(path + ".tmp")


def test_build_datasets_matches_jax():
    config = load_config(CONFIG)
    for ours, ref in zip(build_datasets(config), jax_datasets(config)):
        assert [u.utt_id for u in ours] == [u.utt_id for u in ref]
        assert [u.text for u in ours] == [u.text for u in ref]


def _decode_args(ckpt, out, method="greedy"):
    return ["--config", CONFIG, "--ckpt", ckpt, "--method", method,
            "--output", str(out), "--device", "cpu"]


def test_greedy_decode_reproduces_golden(port_ckpt, tmp_path):
    out = tmp_path / "greedy.jsonl"
    result = decode.main(_decode_args(port_ckpt, out))
    assert result["num_utts"] == 16
    assert result["warm_passes"] == 1 and result["num_batches"] == 2
    rc = fidelity_diff.main([os.path.join(GOLD, "golden_greedy.jsonl"),
                             str(out)])
    assert rc == 0, "the port's greedy decode diverged from the golden"


@pytest.mark.parametrize("impl", ["pallas", "pallas_regrid"])
def test_greedy_decode_with_fused_frontend_reproduces_golden(port_ckpt,
                                                             tmp_path, impl):
    """``frontend.impl`` pallas (K5) and pallas_regrid (K6) decode the
    golden's 16 hypotheses; on the CPU through their plain versions."""
    out = tmp_path / "greedy.jsonl"
    result = decode.main(_decode_args(port_ckpt, out)
                         + ["--set", f"frontend.impl={impl}"])
    assert result["num_utts"] == 16
    rc = fidelity_diff.main([os.path.join(GOLD, "golden_greedy.jsonl"),
                             str(out)])
    assert rc == 0, f"the greedy decode with impl {impl} diverged"


def test_beam_decode_reproduces_golden(port_ckpt, tmp_path):
    out = tmp_path / "beam.jsonl"
    result = decode.main(_decode_args(port_ckpt, out, "beam"))
    assert result["num_utts"] == 16 and result["method"] == "beam"
    assert result["beam_steps_total"] > 0
    rc = fidelity_diff.main([os.path.join(GOLD, "golden_beam.jsonl"),
                             str(out)])
    assert rc == 0, "the port's beam decode diverged from the golden"


@pytest.mark.parametrize("method", ["beam", "ctc_beam"])
def test_beam_methods_are_not_ported_yet(port_ckpt, tmp_path, method):
    """The beams fuse an external LM through the CLI (the port once raised
    here): ``decode.lm_weight`` without ``decode.lm_ckpt`` raises naming
    it; with a port LM checkpoint over the golden's vocabulary (random
    weights) the decode writes an n-best record per utterance."""
    from gluon_e2e_asr_tpu_torch.models.lm import LSTMLM, save_lm

    args = _decode_args(port_ckpt, tmp_path / "b.jsonl", method)
    with pytest.raises(ValueError, match="decode.lm_ckpt"):
        decode.main(args + ["--set", "decode.lm_weight=0.3"])
    with open(port_ckpt + ".json") as f:
        vocab = json.load(f)["vocab"]
    V = tokenizer_from_json(vocab).vocab_size
    lm = LSTMLM(V, 8, 16, 1)
    lm.reset_parameters(torch.Generator().manual_seed(0))
    lm_path = save_lm(str(tmp_path / "lm.pt"), lm.state_dict(), {
        "vocab_size": V, "embed_dim": 8, "hidden": 16, "layers": 1,
        "vocab": vocab})
    result = decode.main(args + ["--set", "decode.lm_weight=0.3",
                                 "--set", f"decode.lm_ckpt={lm_path}",
                                 "--set", "decode.nbest=2"])
    assert result["num_utts"] == 16 and result["method"] == method
    recs = [json.loads(x) for x in open(tmp_path / "b.jsonl")]
    assert len(recs) == 16 and all(r["nbest"] for r in recs)


def _decode_without_jax(port_ckpt, tmp_path, method, golden):
    """The decode CLI in a process where importing jax, flax or the JAX
    package fails; its records against the golden."""
    out = tmp_path / "nojax.jsonl"
    code = (
        "import sys\n"
        "for m in ('jax', 'flax', 'gluon_e2e_asr_tpu'):\n"
        "    sys.modules[m] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "from gluon_e2e_asr_tpu_torch import decode\n"
        f"decode.main({_decode_args(port_ckpt, out, method)!r})\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'flax'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
    )
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=300,
                          env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    rc = fidelity_diff.main([os.path.join(GOLD, golden), str(out)])
    assert rc == 0


def test_decode_runs_without_jax(port_ckpt, tmp_path):
    _decode_without_jax(port_ckpt, tmp_path, "greedy", "golden_greedy.jsonl")


def test_beam_decode_runs_without_jax(port_ckpt, tmp_path):
    _decode_without_jax(port_ckpt, tmp_path, "beam", "golden_beam.jsonl")
