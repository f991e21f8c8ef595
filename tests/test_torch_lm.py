"""PyTorch port: the external LSTM LM (``models/lm.py``), its bridge and
checkpoints, and ``train_lm.py``, against the JAX package on the CPU.

Tiny LMs (V = 32, E = 16, H = 24 or 32, one and two layers) are
initialized by flax and bridged into the port; the same numpy inputs go
through both. The teacher-forced pass, the step loop and the sequence
log-probabilities agree within 1e-5; the bridge round-trips bit for
bit; a JAX ``save_lm`` checkpoint loads in the port; three train steps
of the port's ``make_lm_step`` (clip, AdamW at optax's default weight
decay, the warmup schedule) land within 1e-5 of JAX's ``train_step`` on
the same ``make_batches``; the port's CLI overfits a 4-sentence corpus.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu import train_lm as jax_train_lm
from gluon_e2e_asr_tpu.config import Config as JaxConfig
from gluon_e2e_asr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from gluon_e2e_asr_tpu.models import lm as JLM
from gluon_e2e_asr_tpu.models.lstm import lstm_scan as jax_lstm_scan
from gluon_e2e_asr_tpu_torch import bridge, train_lm
from gluon_e2e_asr_tpu_torch.config import Config
from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer
from gluon_e2e_asr_tpu_torch.models import lm as LM
from gluon_e2e_asr_tpu_torch.models.lstm import lstm_scan

torch.set_num_threads(1)
TOL = 1e-5
V = 32  # the default char vocabulary: 4 specials + 28 symbols


def _jax_lm(layers=2, hidden=24, seed=0, vocab=V):
    model = JLM.LSTMLM(vocab_size=vocab, embed_dim=16, hidden=hidden,
                       layers=layers)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, 2), jnp.int32),
                        jnp.ones((1,), jnp.int32))["params"]
    return model, jax.tree_util.tree_map(np.asarray, params)


def _port_lm(params, layers=2, hidden=24, vocab=V):
    lm = LM.LSTMLM(vocab, 16, hidden, layers)
    lm.load_state_dict(bridge.lm_params_from_jax(params))
    return lm.eval()


def _inputs(B=4, L=9, seed=0):
    rng = np.random.RandomState(seed)
    tokens = rng.randint(0, V, (B, L)).astype(np.int32)
    lens = np.array([L, L - 3, 1, 5][:B], np.int32)
    return tokens, lens


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_scan_matches_jax(reverse):
    rng = np.random.RandomState(1)
    B, T, H = 3, 6, 8
    xg = rng.randn(B, T, 4 * H).astype(np.float32)
    lens = np.array([6, 3, 0], np.int32)
    w_h = (rng.randn(H, 4 * H) * 0.3).astype(np.float32)
    want = jax_lstm_scan(jnp.asarray(xg), jnp.asarray(lens), jnp.asarray(w_h),
                         reverse=reverse)
    got = lstm_scan(torch.from_numpy(xg), torch.from_numpy(lens),
                    torch.from_numpy(w_h), reverse=reverse)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)
    assert not got[2].any()  # a row of length 0 emits zeros


@pytest.mark.parametrize("layers", [1, 2])
def test_forward_matches_jax(layers):
    model, params = _jax_lm(layers)
    tokens, lens = _inputs()
    want = model.apply({"params": params}, jnp.asarray(tokens),
                       jnp.asarray(lens))
    with torch.no_grad():
        got = _port_lm(params, layers)(torch.from_numpy(tokens),
                                       torch.from_numpy(lens))
    assert got.shape == (4, 9, V) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=TOL)


@pytest.mark.parametrize("layers", [1, 2])
def test_step_loop_matches_forward(layers):
    """The beam's step, token by token, gives the teacher-forced pass's
    logits at every valid position, and JAX's step the same."""
    model, params = _jax_lm(layers, hidden=32)
    lm = _port_lm(params, layers, hidden=32)
    tokens, lens = _inputs()
    with torch.no_grad():
        full = lm(torch.from_numpy(tokens), torch.from_numpy(lens))
        state = lm.init_state(4)
        jstate = model.apply({"params": params}, 4, method=model.init_state)
        for i in range(tokens.shape[1]):
            state, logits = lm.step(state, torch.from_numpy(tokens[:, i]))
            jstate, jlogits = model.apply({"params": params}, jstate,
                                          jnp.asarray(tokens[:, i]),
                                          method=model.step)
            np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits),
                                       rtol=0, atol=TOL)
            live = i < lens
            np.testing.assert_allclose(logits[live].numpy(),
                                       full[live, i].numpy(), rtol=0, atol=TOL)
    assert state["h"].shape == (layers, 4, 32)


def test_lm_logprob_batch_matches_jax():
    """Ragged rows, the empty row, and more rows than ``max_rows`` (three
    chunks of a stable shape): the batched scorer against JAX's and
    against the per-row scorer."""
    model, params = _jax_lm()
    lm = _port_lm(params)
    tok = CharTokenizer()
    rows = [tok.encode(t) for t in ("abc a", "z", "", "hello ab", "the cat",
                                    "q", "lorem ipsum dolor")]
    for max_rows in (2048, 3):
        want = JLM.lm_logprob_batch(model, params, rows, tok.eos_id,
                                    tok.sos_id, max_rows=max_rows)
        got = LM.lm_logprob_batch(lm, rows, tok.eos_id, tok.sos_id,
                                  max_rows=max_rows)
        assert got.shape == (len(rows),) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    for row, g in zip(rows, got):
        one = LM.lm_logprob(lm, row, tok.eos_id, tok.sos_id)
        np.testing.assert_allclose(one, g, rtol=0, atol=TOL)
        np.testing.assert_allclose(one, JLM.lm_logprob(
            model, params, np.array(row, np.int32), tok.eos_id, tok.sos_id),
            rtol=0, atol=TOL)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """A JAX ``save_lm`` checkpoint (flax msgpack + sidecar) read by the
    port's ``load_lm`` gives JAX's log-probabilities; the port's own
    checkpoint round-trips."""
    model, params = _jax_lm()
    tok = JaxTokenizer()
    meta = {"vocab_size": V, "embed_dim": 16, "hidden": 24, "layers": 2,
            "vocab": tok.to_json()}
    path = str(tmp_path / "lm.msgpack")
    JLM.save_lm(path, params, meta)
    lm, got_meta = LM.load_lm(path)
    assert got_meta == meta and not lm.training
    rows = [tok.encode("ab c"), tok.encode("hello")]
    want = JLM.lm_logprob_batch(model, params, rows, tok.eos_id, tok.sos_id)
    np.testing.assert_allclose(
        LM.lm_logprob_batch(lm, rows, tok.eos_id, tok.sos_id), want,
        rtol=0, atol=TOL)
    port_path = str(tmp_path / "port" / "lm.pt")
    LM.save_lm(port_path, lm.state_dict(), meta)
    lm2, meta2 = LM.load_lm(port_path)
    assert meta2 == meta
    for k, v in lm.state_dict().items():
        assert torch.equal(v, lm2.state_dict()[k])


def test_bridge_round_trips_bit_for_bit():
    _, params = _jax_lm(layers=2)
    state = bridge.lm_params_from_jax(params)
    assert set(state) == set(LM.LSTMLM(V, 16, 24, 2).state_dict())
    back = bridge.lm_params_to_jax(state)
    assert set(back) == set(params)
    for k, v in params.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape
        assert back[k].tobytes() == v.tobytes()
    with pytest.raises(KeyError, match="unknown LM parameter"):
        bridge.lm_params_from_jax(dict(params, cell0_bias=params["cell0_b"]))
    with pytest.raises(KeyError, match="unknown LM parameter"):
        bridge.lm_params_to_jax(dict(state, extra=state["out_b"]))


def test_initialization_draws_the_flax_distributions():
    """The port's own init (from ``lm.seed``): the flax initializers'
    distributions, not their numbers."""
    lm = LM.build_lm(Config(), V)
    lm.reset_parameters(torch.Generator().manual_seed(0))
    p = {k: v.detach() for k, v in lm.named_parameters()}
    assert p["embed"].shape == (V, 256)
    np.testing.assert_allclose(float(p["embed"].std()), 1 / 16, rtol=0.05)
    wh = p["cell1_wh"]  # [512, 2048]: orthonormal rows
    np.testing.assert_allclose((wh @ wh.T).numpy(), np.eye(512),
                               atol=1e-4)
    for name in ("cell0_wx", "cell1_wx", "out_w"):
        w = p[name]
        lim = 2 * np.sqrt(1 / w.shape[0]) / 0.87962566103423978
        assert float(w.abs().max()) <= lim + 1e-6
        np.testing.assert_allclose(float(w.std()), np.sqrt(1 / w.shape[0]),
                                   rtol=0.05)
    assert all(not p[n].any() for n in ("cell0_b", "cell1_b", "out_b"))


def _lm_configs(tmp_path):
    """(JAX config, port config) of a small LM on the synthetic manifests
    with an extra text file."""
    extra = tmp_path / "extra.txt"
    extra.write_text("the quick brown fox\n\njumps over\nthe lazy dog\n")
    configs = []
    for cls in (JaxConfig, Config):
        c = cls()
        c.data.synth_num_train = 10
        c.data.synth_num_dev = 4
        c.lm.embed_dim, c.lm.hidden, c.lm.layers = 16, 24, 2
        c.lm.max_len, c.lm.batch_size = 24, 4
        c.lm.warmup_steps = 2
        c.lm.learning_rate = 3e-3
        c.lm.grad_clip_norm = 0.5  # clips in every step here
        c.lm.extra_text = str(extra)
        configs.append(c)
    return configs


def test_texts_and_batches_match_jax(tmp_path):
    jc, pc = _lm_configs(tmp_path)
    texts = jax_train_lm.gather_texts(jc)
    assert train_lm.gather_texts(pc) == texts
    assert texts[1][-3:] == ["the quick brown fox", "jumps over",
                             "the lazy dog"]
    tok, jtok = CharTokenizer(), JaxTokenizer()
    got = list(train_lm.make_batches(texts[1], tok, 24, 4,
                                     np.random.default_rng(3)))
    want = list(jax_train_lm.make_batches(texts[1], jtok, 24, 4,
                                          np.random.default_rng(3)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    assert got[-1][2][0] > 0 and not got[-1][2][1:].any()  # len-0 pad rows


def test_lm_train_steps_match_jax(tmp_path):
    """Three steps from the same (bridged) parameters on the same
    batches: the loss and every parameter within 1e-5."""
    jc, pc = _lm_configs(tmp_path)
    _, train_texts, _ = jax_train_lm.gather_texts(jc)
    model, params = _jax_lm(layers=2, seed=4)
    tx, jstep, jeval = jax_train_lm.make_lm_step(model, jc.lm)
    opt_state = tx.init(params)
    lm = _port_lm(params).train()
    opt, step, evals = train_lm.make_lm_step(lm, pc.lm)
    state = opt.init(dict(lm.named_parameters()))
    batches = list(jax_train_lm.make_batches(
        train_texts, JaxTokenizer(), 24, 4, np.random.default_rng(0)))[:3]
    for ti, tg, ln in batches:
        params, opt_state, jloss, jcount = jstep(
            params, opt_state, jnp.asarray(ti), jnp.asarray(tg),
            jnp.asarray(ln))
        loss, count = step(state, *(torch.from_numpy(a) for a in (ti, tg, ln)))
        assert int(count) == int(jcount)
        np.testing.assert_allclose(float(loss), float(jloss), rtol=0, atol=TOL)
        for k, v in lm.state_dict().items():
            np.testing.assert_allclose(v.numpy(), np.asarray(params[k]),
                                       rtol=0, atol=TOL, err_msg=k)
    assert state["count"] == 3
    s, c = evals(*(torch.from_numpy(a) for a in batches[0]))
    js, jc_ = jeval(params, *(jnp.asarray(a) for a in batches[0]))
    assert int(c) == int(jc_)
    np.testing.assert_allclose(float(s), float(js), rtol=1e-5)


def test_train_lm_cli_overfits_a_small_corpus(tmp_path, capsys):
    """The port's CLI on the CPU, as tests/test_lm.py overfits JAX's: dev
    perplexity (the same 4 sentences) far below the uniform vocabulary's,
    the metrics lines, the best checkpoint and its sidecar, which the
    port's ``load_lm`` reads back."""
    dev_texts = train_lm.gather_texts(_small_config())[2]
    extra = tmp_path / "text.txt"
    extra.write_text("\n".join(dev_texts) + "\n")
    args = ["--workdir", str(tmp_path), "--device", "cpu"]
    for kv in ("data.synth_num_train=0", "data.synth_num_dev=4",
               "data.synth_seed=7", "lm.embed_dim=32", "lm.hidden=64",
               "lm.layers=1", "lm.max_len=48", "lm.batch_size=4",
               "lm.num_epochs=150", "lm.warmup_steps=10",
               "lm.learning_rate=3e-3", f"lm.extra_text={extra}",
               "lm.ckpt_path=lm/lm.pt"):
        args += ["--set", kv]
    res = train_lm.main(args)
    assert res["best_dev_ppl"] < V / 4
    done = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert done["event"] == "lm_done" and done["ckpt"] == res["ckpt"]
    lines = [json.loads(x) for x in open(tmp_path / "lm_metrics.jsonl")]
    assert [r["epoch"] for r in lines] == list(range(150))
    assert all(r["event"] == "lm_epoch" for r in lines)
    assert lines[-1]["dev_ppl"] < lines[0]["dev_ppl"]
    lm, meta = LM.load_lm(res["ckpt"])
    assert meta["hidden"] == 64 and meta["vocab"] == CharTokenizer().to_json()
    assert os.path.exists(res["ckpt"] + ".json")
    assert meta["dev_ppl"] == res["best_dev_ppl"]


def _small_config():
    c = Config()
    c.data.synth_num_train = 4
    c.data.synth_num_dev = 4
    c.data.synth_seed = 7
    return c
