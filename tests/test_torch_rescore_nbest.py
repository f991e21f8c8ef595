"""PyTorch port: ``tools/rescore_nbest.py`` against the JAX package's tool
on the CPU.

The same n-best records and the same LM checkpoint (a JAX ``save_lm``
file, which the port's ``load_lm`` reads through the bridge) go through
both tools, with and without ``--lm-length-norm``: the summary lines
must be equal and the rescored records equal (their fused scores and LM
log-probabilities within 1e-5, the order and the hypotheses exactly).
"""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.data.tokenizer import CharTokenizer
from gluon_e2e_asr_tpu.models.lm import LSTMLM, save_lm
from gluon_e2e_asr_tpu_torch.tools import rescore_nbest

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "jax_rescore_nbest", os.path.join(REPO, "tools", "rescore_nbest.py"))
jax_rescore = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jax_rescore)

CANDS = [["the cat sat", "the cat sad", "a cat sat", "the hat sat"],
         ["on the mat", "on a mat", "one the mat"],
         ["hello", "hallo"]]
REFS = ["the cat sat", "on a mat", "hallo world"]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("rescore")
    tok = CharTokenizer()
    model = LSTMLM(vocab_size=tok.vocab_size, embed_dim=8, hidden=16, layers=1)
    params = model.init(jax.random.PRNGKey(3), jnp.zeros((1, 2), jnp.int32),
                        jnp.ones((1,), jnp.int32))["params"]
    lm = str(d / "lm.msgpack")
    save_lm(lm, params, {"vocab_size": tok.vocab_size, "embed_dim": 8,
                         "hidden": 16, "layers": 1, "vocab": tok.to_json()})
    records = str(d / "records.jsonl")
    with open(records, "w") as f:
        for i, (ref, cands) in enumerate(zip(REFS, CANDS)):
            f.write(json.dumps({
                "utt_id": f"u{i}", "ref": ref, "hyp": cands[0], "score": -1.0,
                "nbest": [{"hyp": c, "score": -1.0 - 0.01 * j}
                          for j, c in enumerate(cands)]}) + "\n")
    return d, lm, records


def _summary(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("norm", [[], ["--lm-length-norm"]],
                         ids=["raw", "length_norm"])
def test_rescoring_matches_jax(inputs, capsys, norm):
    d, lm, records = inputs
    args = [records, "--lm", lm, "--weight", "2.0", *norm]
    jax_rescore.main(args + ["--output", str(d / "jax.jsonl")])
    want = _summary(capsys)
    got = rescore_nbest.main(args + ["--output", str(d / "port.jsonl"),
                                     "--device", "cpu"])
    assert _summary(capsys) == got
    for k in ("event", "num_utts", "lm_weight", "baseline_wer",
              "rescored_wer", "oracle_wer"):
        assert got[k] == want[k], k
    w = [json.loads(x) for x in open(d / "jax.jsonl")]
    g = [json.loads(x) for x in open(d / "port.jsonl")]
    assert any(r["hyp"] != c[0] for r, c in zip(g, CANDS))  # the LM re-ranked
    assert len(g) == len(w) == 3
    for rw, rg in zip(w, g):
        assert {k: v for k, v in rg.items() if k != "nbest"} == \
            {k: v for k, v in rw.items() if k != "nbest"}
        assert [c["hyp"] for c in rg["nbest"]] == [c["hyp"] for c in rw["nbest"]]
        for cg, cw in zip(rg["nbest"], rw["nbest"]):
            assert cg["am_score"] == cw["am_score"]
            np.testing.assert_allclose(cg["score"], cw["score"], rtol=0,
                                       atol=1e-5)
            np.testing.assert_allclose(cg["lm_logprob"], cw["lm_logprob"],
                                       rtol=0, atol=1e-4)


def test_rescoring_refuses_records_without_nbest(inputs, tmp_path):
    _, lm, _ = inputs
    records = tmp_path / "one_best.jsonl"
    records.write_text(json.dumps({"utt_id": "u0", "ref": "a", "hyp": "a"})
                       + "\n")
    with pytest.raises(SystemExit, match="nbest"):
        rescore_nbest.main([str(records), "--lm", lm, "--device", "cpu"])


def test_make_lm_corpus_matches_jax(tmp_path, capsys):
    """english_m5.yaml's LM corpus (its sentence split: the train side of
    the pool, none dropped) is the JAX tool's, byte for byte."""
    from gluon_e2e_asr_tpu_torch.tools import make_lm_corpus

    spec = importlib.util.spec_from_file_location(
        "jax_make_lm_corpus", os.path.join(REPO, "tools", "make_lm_corpus.py"))
    jax_tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tool)
    config = os.path.join(REPO, "configs", "english_m5.yaml")
    jax_tool.main(["--config", config, "--out", str(tmp_path / "j.txt")])
    want_line = capsys.readouterr().out.strip().splitlines()[-1]
    got = make_lm_corpus.main(["--config", config,
                               "--out", str(tmp_path / "p.txt")])
    got_line = capsys.readouterr().out.strip().splitlines()[-1]
    assert got_line.replace("p.txt", "j.txt") == want_line
    assert got["kept"] == got["pool"] > 1000
    assert (tmp_path / "p.txt").read_bytes() == (tmp_path / "j.txt").read_bytes()
