"""PyTorch port: the batched beam search against the JAX package's
``make_beam_decoder`` on the CPU.

A tiny hybrid model with location-aware attention (2 BiLSTM layers of 16,
a decoder of 16 units, 4 location channels of a width-7 filter), its
flax parameters (the eos bias lowered, so that the untrained decoder
does not end at once) bridged into the port, decodes the same seeded audio
(4 utterances of 0.3 to 0.5 s, ragged) with both beams: ``beam`` with
and without length normalization (and the insertion penalty), partial
CTC scoring, end detection, an n-best list, ``ctc_beam`` with full and
partial scoring, and ``beam`` over an add-attention decoder and over a
stacked (two-layer) location-aware one. The
hypotheses must be identical, the scores within 1e-4 (the golden gate's
tolerance, ``tools/fidelity_diff.py``), and the output steps run the
same. About 40 s in all, most of it the JAX programs' compilation.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from gluon_e2e_asr_tpu.config import Config, ModelConfig
from gluon_e2e_asr_tpu.data.tokenizer import CharTokenizer as JaxTokenizer
from gluon_e2e_asr_tpu.decoding.beam import make_beam_decoder as jax_beam
from gluon_e2e_asr_tpu.models.asr import build_model as jax_build_model
from gluon_e2e_asr_tpu.training import train_step as jts
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax, params_to_jax
from gluon_e2e_asr_tpu_torch.data.tokenizer import CharTokenizer
from gluon_e2e_asr_tpu_torch.decoding import beam as B
from gluon_e2e_asr_tpu_torch.decoding.serving import apply_b1_serving_defaults
from gluon_e2e_asr_tpu_torch.models.asr import build_model

torch.set_num_threads(1)


def _config(att_type="loc", dec_layers=1):
    c = Config()
    c.model = ModelConfig(enc_hidden=16, enc_layers=2, enc_subsample=(1, 2),
                          dec_hidden=16, dec_embed=8, att_dim=16,
                          att_type=att_type, loc_conv_channels=4,
                          loc_conv_width=7, compute_dtype="float32",
                          dec_layers=dec_layers)
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


def _models(att_type, dec_layers=1):
    """(JAX model, its params, the port's model with them)."""
    config = _config(att_type, dec_layers)
    tok = JaxTokenizer()
    model = jax_build_model(config, tok.vocab_size, tok.sos_id, tok.eos_id)
    audio, lens = _audio()
    labels = np.random.RandomState(1).randint(4, tok.vocab_size, (4, 5))
    batch = {"audio": audio, "audio_len": lens,
             "labels": labels.astype(np.int32),
             "label_len": np.full(4, 5, np.int32)}
    state = jts.create_train_state(config, model, optax.adam(1e-3), batch)
    params = jax.tree_util.tree_map(np.array, state.params)
    # An untrained decoder ends at once; a lower eos bias gives the beam
    # hypotheses of a few tokens to rank.
    params["decoder"]["out_b"][tok.eos_id] -= 4.0
    port = build_model(config, tok.vocab_size, sos_id=tok.sos_id,
                       eos_id=tok.eos_id)
    port.load_state_dict(params_from_jax(params))
    port.eval()
    return model, params, port


@pytest.fixture(scope="module")
def loc_models():
    return _models("loc")


def _both(models, **decode):
    """(JAX texts, scores, steps), (port texts, scores, steps) with the
    decode options ``decode`` over the tiny config."""
    model, params, port = models
    config = copy.deepcopy(_config(port.cfg.att_type, port.cfg.dec_layers))
    for k, v in decode.items():
        setattr(config.decode, k, v)
    audio, lens = _audio()
    jdec = jax_beam(model, config, JaxTokenizer())
    texts, scores = jdec(jax.tree_util.tree_map(jnp.asarray, params),
                         jnp.asarray(audio), jnp.asarray(lens))
    pdec = B.make_beam_decoder(port, config, CharTokenizer())
    got, got_scores = pdec(audio, lens)
    return ((texts, np.asarray(scores), jdec.last_steps),
            (got, got_scores, pdec.last_steps))


def _check(ref, got):
    assert got[0] == ref[0]
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-4)
    assert got[2] == ref[2]


@pytest.mark.parametrize("options", [
    {}, {"length_norm": False, "penalty": 0.5},
    {"ctc_score_candidates": 6}, {"end_detect": True, "end_detect_d": 1.0},
    {"minlen_ratio": 0.2}],
    ids=["length_norm", "penalty", "partial", "end_detect", "minlen"])
def test_beam_matches_jax(loc_models, options):
    ref, got = _both(loc_models, **options)
    _check(ref, got)
    assert any(got[0])  # some hypothesis is not empty


@pytest.mark.parametrize("options", [{}, {"ctc_score_candidates": 6}],
                         ids=["full", "partial"])
def test_ctc_beam_matches_jax(loc_models, options):
    _check(*_both(loc_models, method="ctc_beam", **options))


def test_nbest_matches_jax(loc_models):
    model, params, port = loc_models
    config = _config()
    config.decode.nbest = 3
    audio, lens = _audio()
    ref = jax_beam(model, config, JaxTokenizer()).nbest(
        jax.tree_util.tree_map(jnp.asarray, params), jnp.asarray(audio),
        jnp.asarray(lens))
    got = B.make_beam_decoder(port, config, CharTokenizer()).nbest(audio, lens)
    assert [[t for t, _ in row] for row in got] == [[t for t, _ in row] for row in ref]
    np.testing.assert_allclose([[s for _, s in row] for row in got],
                               [[s for _, s in row] for row in ref], atol=1e-4)


def test_add_attention_beam_matches_jax():
    _check(*_both(_models("add")))


def test_stacked_decoder_beam_matches_jax():
    """Two decoder layers: the beam's states carry h and c [2, B*K, H]
    through step_beam and the parent gathers."""
    ref, got = _both(_models("loc", dec_layers=2))
    _check(ref, got)
    assert any(got[0])


def test_loc_checkpoint_round_trips_bit_for_bit(loc_models):
    """The location-aware model's leaves, loc_filter and loc_proj among
    them, go through the bridge and back bit for bit."""
    params = loc_models[1]
    assert {"loc_filter", "loc_proj"} <= set(params["decoder"])
    back = params_to_jax(params_from_jax(params))
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    assert len(flat) == len(jax.tree_util.tree_leaves(back))
    for path, leaf in flat:
        node = back
        for k in path:
            node = node[k.key]
        assert node.dtype == leaf.dtype and node.shape == leaf.shape
        assert node.tobytes() == np.asarray(leaf).tobytes()


def test_lm_fusion_and_mesh_raise(loc_models):
    """LM shallow fusion asked for with no LM raises, naming
    decode.lm_ckpt. (Fusion itself is ported and held to JAX in
    tests/test_torch_lm_fusion.py; the mesh, data-parallel beam
    decoding, in tests/test_torch_parallel.py.)"""
    port = loc_models[2]
    config = _config()
    config.decode.lm_weight = 0.5
    with pytest.raises(ValueError, match="decode.lm_ckpt"):
        B.make_beam_decoder(port, config, CharTokenizer())


def test_b1_serving_defaults():
    """At B=1 the beams get partial scoring (2K candidates) and end
    detection, unless set on the command line; other batches keep theirs."""
    config = _config()
    config.data.batch_size = 1
    apply_b1_serving_defaults(config)
    assert config.decode.ctc_score_candidates == 8 and config.decode.end_detect
    config = _config()
    config.data.batch_size = 1
    apply_b1_serving_defaults(config, ["decode.end_detect=false"])
    assert config.decode.ctc_score_candidates == 8
    assert not config.decode.end_detect
    config = _config()
    apply_b1_serving_defaults(config)
    assert config.decode.ctc_score_candidates == 0 and not config.decode.end_detect
