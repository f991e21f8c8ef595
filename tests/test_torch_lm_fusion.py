"""PyTorch port: LM shallow fusion in the batched beam against the JAX
package's ``make_beam_decoder(..., lm_bundle=...)`` on the CPU.

A tiny hybrid model with location-aware attention (2 BiLSTM layers of
16, a decoder of 16 units; its flax parameters, the eos bias lowered so
that the untrained decoder does not end at once) and a tiny two-layer
LSTM LM (E 16, H 24), both bridged into the port, decode the same seeded
audio (4 ragged utterances) at ``lm_weight`` 0.5: full-vocabulary CTC
scoring, partial scoring, ``ctc_beam``, end detection and an n-best
list. The hypotheses must be identical and the scores within 1e-4 (the
tolerance of ``tests/test_torch_beam.py``). At ``lm_weight`` 0 the port's
beam with an LM is bit-identical to the one without; a JAX ``train_lm``
checkpoint works as ``decode.lm_ckpt``; and at full width the fused
beam's winner is the brute-force argmax of the attention and LM scores.
"""

import copy
import itertools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gluon_e2e_asr_tpu.config import Config, ModelConfig
from gluon_e2e_asr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from gluon_e2e_asr_tpu.decoding.beam import make_beam_decoder as jax_beam
from gluon_e2e_asr_tpu.models import lm as JLM
from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model
from gluon_e2e_asr_tpu.training import train_step as jts
from gluon_e2e_asr_tpu_torch.bridge import lm_params_from_jax, params_from_jax
from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer
from gluon_e2e_asr_tpu_torch.decoding import beam as B
from gluon_e2e_asr_tpu_torch.frontend.features import frontend_apply
from gluon_e2e_asr_tpu_torch.models import lm as LM
from gluon_e2e_asr_tpu_torch.models.asr import build_model

torch.set_num_threads(1)
LM_WEIGHT = 0.5


def _config():
    c = Config()
    c.model = ModelConfig(enc_hidden=16, enc_layers=2, enc_subsample=(1, 2),
                          dec_hidden=16, dec_embed=8, att_dim=16,
                          att_type="loc", loc_conv_channels=4,
                          loc_conv_width=7, compute_dtype="float32")
    c.loss.mtl_alpha = 0.3
    c.decode.method = "beam"
    c.decode.beam_size = 4
    c.decode.ctc_weight = 0.3
    c.decode.maxlen_ratio = 0.5
    return c


def _audio():
    rng = np.random.RandomState(0)
    lens = np.array([8000, 6400, 4800, 7200], np.int32)
    audio = (rng.randn(4, 8000) * 0.3).astype(np.float32)
    audio *= np.arange(8000)[None] < lens[:, None]
    return audio, lens


def _models(alphabet=None):
    """(JAX model, its params, JAX LM, its params, the port's model, the
    port's LM), over the char vocabulary of ``alphabet``."""
    config = _config()
    jtok = JaxTokenizer(alphabet) if alphabet else JaxTokenizer()
    V = jtok.vocab_size
    model = jax_build_model(config, V, jtok.sos_id, jtok.eos_id)
    audio, lens = _audio()
    labels = np.random.RandomState(1).randint(4, V, (4, 5))
    batch = {"audio": audio, "audio_len": lens,
             "labels": labels.astype(np.int32),
             "label_len": np.full(4, 5, np.int32)}
    state = jts.create_train_state(config, model, optax.adam(1e-3), batch)
    params = jax.tree_util.tree_map(np.array, state.params)
    params["decoder"]["out_b"][jtok.eos_id] -= 4.0
    lm = JLM.LSTMLM(vocab_size=V, embed_dim=16, hidden=24, layers=2)
    lm_params = jax.tree_util.tree_map(np.asarray, lm.init(
        jax.random.PRNGKey(9), jnp.zeros((1, 2), jnp.int32),
        jnp.ones((1,), jnp.int32))["params"])
    port = build_model(config, V, sos_id=jtok.sos_id, eos_id=jtok.eos_id)
    port.load_state_dict(params_from_jax(params))
    port.eval()
    port_lm = LM.LSTMLM(V, 16, 24, 2)
    port_lm.load_state_dict(lm_params_from_jax(lm_params))
    return model, params, lm, lm_params, port, port_lm.eval()


@pytest.fixture(scope="module")
def models():
    return _models()


CASES = {
    "full_vocab": {},
    "partial": {"ctc_score_candidates": 6},
    "penalty": {"length_norm": False, "penalty": 4.0},
    "end_detect": {"end_detect": True, "end_detect_d": 1.0},
    "ctc_beam": {"method": "ctc_beam"},
    "ctc_beam_partial": {"method": "ctc_beam", "ctc_score_candidates": 6},
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_beam_matches_jax(models, case):
    model, params, lm, lm_params, port, port_lm = models
    config = _config()
    config.decode.lm_weight = LM_WEIGHT
    for k, v in CASES[case].items():
        setattr(config.decode, k, v)
    audio, lens = _audio()
    jdec = jax_beam(model, config, JaxTokenizer(), lm_bundle=(lm, lm_params))
    texts, scores = jdec(jax.tree_util.tree_map(jnp.asarray, params),
                         jnp.asarray(audio), jnp.asarray(lens))
    pdec = B.make_beam_decoder(port, config, CharTokenizer(), lm_bundle=port_lm)
    got, got_scores = pdec(audio, lens)
    assert got == texts
    np.testing.assert_allclose(got_scores, np.asarray(scores), rtol=0, atol=1e-4)
    assert pdec.last_steps == jdec.last_steps
    assert any(got)
    # the LM moved the search: scores differ from the unfused beam's
    config.decode.lm_weight = 0.0
    _, plain_scores = B.make_beam_decoder(port, config, CharTokenizer())(
        audio, lens)
    assert not np.allclose(plain_scores, got_scores)


def test_fused_nbest_matches_jax(models):
    model, params, lm, lm_params, port, port_lm = models
    config = _config()
    config.decode.lm_weight = LM_WEIGHT
    config.decode.nbest = 3
    audio, lens = _audio()
    ref = jax_beam(model, config, JaxTokenizer(),
                   lm_bundle=(lm, lm_params)).nbest(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(audio),
        jnp.asarray(lens))
    got = B.make_beam_decoder(port, config, CharTokenizer(),
                              lm_bundle=port_lm).nbest(audio, lens)
    assert [[t for t, _ in r] for r in got] == [[t for t, _ in r] for r in ref]
    np.testing.assert_allclose([[s for _, s in r] for r in got],
                               [[s for _, s in r] for r in ref], atol=1e-4)


@pytest.mark.parametrize("method", ["beam", "ctc_beam"])
def test_lm_weight_zero_is_bit_identical(models, method):
    """With an LM given and lm_weight 0 no LM code runs: the texts and
    the scores of every n-best slot equal the LM-free beam's bit for bit."""
    port, port_lm = models[4], models[5]
    config = _config()
    config.decode.method = method
    config.decode.nbest = 4
    audio, lens = _audio()
    base = B.make_beam_decoder(port, config, CharTokenizer()).nbest(audio, lens)
    config.decode.lm_weight = 0.0
    fused = B.make_beam_decoder(port, config, CharTokenizer(),
                                lm_bundle=port_lm).nbest(audio, lens)
    assert base == fused


def test_jax_lm_checkpoint_as_decode_lm_ckpt(models, tmp_path):
    """A JAX ``train_lm.py`` checkpoint given as ``decode.lm_ckpt`` fuses
    as the bridged LM does; a vocabulary that does not fit raises."""
    model, params, lm, lm_params, port, port_lm = models
    tok = JaxTokenizer()
    meta = {"vocab_size": tok.vocab_size, "embed_dim": 16, "hidden": 24,
            "layers": 2, "vocab": tok.to_json()}
    path = str(tmp_path / "lm.msgpack")
    JLM.save_lm(path, lm_params, meta)
    config = _config()
    config.decode.lm_weight = LM_WEIGHT
    audio, lens = _audio()
    want = B.make_beam_decoder(port, config, CharTokenizer(),
                               lm_bundle=port_lm)(audio, lens)
    config.decode.lm_ckpt = path
    got = B.make_beam_decoder(port, config, CharTokenizer())(audio, lens)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    # the same size, another symbol table
    other = JaxTokenizer("abcdefghijklmnopqrstuvwxyz!?")
    assert other.vocab_size == tok.vocab_size
    JLM.save_lm(path, lm_params, dict(meta, vocab=other.to_json()))
    with pytest.raises(ValueError, match="vocab differs"):
        B.make_beam_decoder(port, config, CharTokenizer())
    # another size
    small = JLM.LSTMLM(vocab_size=10, embed_dim=16, hidden=24, layers=2)
    small_params = small.init(jax.random.PRNGKey(0), jnp.zeros((1, 2), jnp.int32),
                              jnp.ones((1,), jnp.int32))["params"]
    JLM.save_lm(path, small_params, dict(meta, vocab_size=10, vocab=""))
    with pytest.raises(ValueError, match="vocab_size"):
        B.make_beam_decoder(port, config, CharTokenizer())
    config.decode.lm_ckpt = ""
    with pytest.raises(ValueError, match="decode.lm_ckpt"):
        B.make_beam_decoder(port, config, CharTokenizer())


def test_fused_beam_at_full_width_finds_the_exhaustive_optimum():
    """Full beam width, ctc_weight 0, no length normalization, lm_weight
    0.4: the beam's winner is the brute-force argmax of att_logp(seq, eos)
    + 0.4 * log p_lm(seq, eos) over every sequence of at most 2 tokens,
    each scored by the port's own decoder and LM (tests/test_lm.py's
    check, on the port)."""
    tok = CharTokenizer("abc")
    *_, port, lm = _models("abc")
    config = _config()
    audio, lens = _audio()
    audio, lens = audio[:1], lens[:1]
    with torch.no_grad():
        feats, flen = frontend_apply(config.frontend, torch.from_numpy(audio),
                                     torch.from_numpy(lens))
        enc, enc_len, _ = port.encode(feats, flen)
    T = enc.shape[1]
    lm_w = 0.4
    config.decode.maxlen_ratio = 3 / float(enc_len[0])
    config.decode.ctc_weight = 0.0
    config.decode.length_norm = False
    config.decode.lm_weight = lm_w
    allowed = [i for i in range(tok.vocab_size)
               if i not in (tok.blank_id, tok.sos_id, tok.eos_id, tok.unk_id)]
    A = len(allowed)
    config.decode.beam_size = 1 + A + A * A

    @torch.no_grad()
    def att_logprob(seq):
        """log p_att(seq, eos) by the port's decoder, one token a step."""
        enc_proj = port.decoder_precompute(enc)
        mask = (torch.arange(T)[None] < enc_len[:, None]).float()
        band = port.decoder_loc_band(T)
        state = port.decoder_init_state(1, T)
        total = 0.0
        for t_in, t_out in zip([tok.sos_id] + seq, seq + [tok.eos_id]):
            state, logits = port.decoder_step(state, torch.tensor([t_in]), enc,
                                              enc_proj, mask, band)
            total += float(torch.log_softmax(logits, -1)[0, t_out])
        return total

    seqs = [[]] + [[c] for c in allowed] + [list(p) for p in
                                            itertools.product(allowed, repeat=2)]
    scored = [(att_logprob(s) + lm_w * LM.lm_logprob(lm, s, tok.eos_id,
                                                     tok.sos_id), s)
              for s in seqs]
    best_score, best_seq = max(scored, key=lambda x: x[0])
    texts, scores = B.make_beam_decoder(port, copy.deepcopy(config), tok,
                                        lm_bundle=lm)(audio, lens)
    assert texts[0] == tok.decode(best_seq)
    np.testing.assert_allclose(scores[0], best_score, atol=1e-3)
