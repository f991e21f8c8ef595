"""PyTorch port: the stacked attention decoder (``dec_layers > 1``)
against the JAX package's route for it on the CPU.

There ``_use_fused`` is False for more than one layer, so the JAX
decoder runs its ``lax.scan`` over ``step`` whatever ``dec_impl`` says:
the steps in f32, only ``precompute`` in the compute dtype. The port
runs the same loop in plain torch (``AttentionDecoder._stacked``), never
K4. The same bridged flax parameters and seeded inputs go through both,
for dot, add and location-aware attention, 2 and 3 layers, the
scheduled-sampling coins off and on (the JAX decoder's own draw,
reproduced and fed to the port): the teacher-forced logits, every
gradient, greedy ``step`` loops and ``step_beam``.

Tolerances: the JAX suite's fused-against-scan tolerance, rtol/atol 1e-5
for logits and states, the fed-back tokens identical; gradients atol
2e-5 of each gradient's largest magnitude.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import ModelConfig as JaxModelConfig
from gluon_e2e_asr_tpu.models.decoder import AttentionDecoder as JaxDecoder
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax
from gluon_e2e_asr_tpu_torch.config import ModelConfig
from gluon_e2e_asr_tpu_torch.models.decoder import AttentionDecoder
from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

torch.set_num_threads(1)

V = 12
B, T, L = 4, 24, 9
ENC_LEN = np.array([24, 20, 17, 5], np.int32)
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfg(cls, att_type, layers, **kw):
    sizes = dict(enc_hidden=16, dec_hidden=16, dec_embed=8, att_dim=8,
                 loc_conv_channels=3, loc_conv_width=5)
    return cls(att_type=att_type, dec_layers=layers, **{**sizes, **kw})


def setup(att_type, layers=2, seed=0, **kw):
    """(JAX decoder, its params, the port decoder with them bridged, enc,
    tokens)."""
    rng = np.random.RandomState(seed)
    enc = rng.randn(B, T, 32).astype(np.float32)
    tokens = rng.randint(0, V, size=(B, L)).astype(np.int32)
    tokens[:, 0] = 2
    jdec = JaxDecoder(_cfg(JaxModelConfig, att_type, layers, **kw), V)
    params = jdec.init(jax.random.PRNGKey(seed), jnp.asarray(enc),
                       jnp.asarray(ENC_LEN), jnp.asarray(tokens))["params"]
    dec = AttentionDecoder(_cfg(ModelConfig, att_type, layers, **kw), V)
    state = params_from_jax(
        {"decoder": jax.tree_util.tree_map(np.asarray, params)})
    dec.load_state_dict({k[len("decoder."):]: v for k, v in state.items()})
    return jdec, params, dec, enc, tokens


def jax_forward(jdec, params, enc, tokens, ss_prob, key):
    """The JAX teacher-forced pass and the coins [L,B] it drew."""
    logits = jdec.apply({"params": params}, jnp.asarray(enc),
                        jnp.asarray(ENC_LEN), jnp.asarray(tokens), ss_prob,
                        key if ss_prob > 0 else None)
    coins = jax.random.bernoulli(key, ss_prob, (L, B))
    return logits, torch.from_numpy(np.array(coins))


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
@pytest.mark.parametrize("ss_prob", [0.0, 0.5])
def test_stacked_forward_matches_jax_scan(att_type, ss_prob):
    jdec, p, dec, enc, tokens = setup(att_type)
    ref, coins = jax_forward(jdec, p, enc, tokens, ss_prob,
                             jax.random.PRNGKey(7))
    calls = K.las_decoder_fwd_plain.calls
    with torch.no_grad():
        got = dec(torch.from_numpy(enc), torch.from_numpy(ENC_LEN),
                  torch.from_numpy(tokens), coins)
    assert K.las_decoder_fwd_plain.calls == calls  # K4's route never ran
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    if ss_prob:  # some argmax was fed back
        assert (np.asarray(coins)[1:]).any()


@pytest.mark.parametrize("layers,att_type,cd", [
    (3, "loc", "float32"), (2, "add", "bfloat16"), (2, "dot", "bfloat16")])
def test_stacked_layers_and_compute_dtype(layers, att_type, cd):
    """Three layers; and dec_impl pallas in bf16, where the JAX route still
    runs the steps in f32 and rounds only precompute's operands."""
    jdec, p, dec, enc, tokens = setup(att_type, layers, compute_dtype=cd,
                                      dec_impl="pallas")
    ref, coins = jax_forward(jdec, p, enc, tokens, 0.5, jax.random.PRNGKey(1))
    with torch.no_grad():
        got = dec(torch.from_numpy(enc), torch.from_numpy(ENC_LEN),
                  torch.from_numpy(tokens), coins)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
def test_stacked_gradients_match_jax(att_type):
    jdec, p, dec, enc, tokens = setup(att_type, seed=1)
    key = jax.random.PRNGKey(3)
    w = np.random.RandomState(2).randn(B, L, V).astype(np.float32)

    def loss(params, e):
        logits = jdec.apply({"params": params}, e, jnp.asarray(ENC_LEN),
                            jnp.asarray(tokens), 0.5, key)
        return jnp.sum(logits * w)

    gp, ge = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(enc))
    ref = params_from_jax({"decoder": jax.tree_util.tree_map(np.asarray, gp)})
    coins = jax_forward(jdec, p, enc, tokens, 0.5, key)[1]
    enc_t = torch.from_numpy(enc).requires_grad_(True)
    logits = dec(enc_t, torch.from_numpy(ENC_LEN), torch.from_numpy(tokens),
                 coins)
    (logits * torch.from_numpy(w)).sum().backward()
    grads = {f"decoder.{k}": q.grad for k, q in dec.named_parameters()}
    grads["enc"], ref["enc"] = enc_t.grad, torch.from_numpy(np.asarray(ge))
    assert set(grads) == set(ref)
    for k, r in ref.items():
        r = r.numpy()
        np.testing.assert_allclose(grads[k].numpy(), r, rtol=0,
                                   atol=2e-5 * np.abs(r).max(), err_msg=k)


def _jax_step(jdec, p, method, *args):
    return jdec.apply({"params": p}, *args, method=method)


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
def test_stacked_greedy_steps_match_jax(att_type):
    """A greedy loop over ``step`` (state h, c [L,B,H]), the loc band built
    once outside the loop, on both sides."""
    jdec, p, dec, enc, _ = setup(att_type, seed=2)
    enc_j, enc_t = jnp.asarray(enc), torch.from_numpy(enc)
    mask = (np.arange(T)[None] < ENC_LEN[:, None]).astype(np.float32)
    encp_j = _jax_step(jdec, p, jdec.precompute, enc_j)
    band_j = (_jax_step(jdec, p, jdec.build_loc_band, T)
              if att_type == "loc" else None)
    state_j = jdec.init_state(B, T)
    with torch.no_grad():
        encp_t = dec.precompute(enc_t)
        band_t = dec.build_loc_band(T) if att_type == "loc" else None
        state_t = dec.init_state(B, T)
        assert state_t["h"].shape == (2, B, 16)
        tok_j = jnp.full((B,), 2, jnp.int32)
        tok_t = torch.full((B,), 2, dtype=torch.int32)
        for _ in range(6):
            state_j, lg_j = _jax_step(jdec, p, jdec.step, state_j, tok_j, enc_j,
                                      encp_j, jnp.asarray(mask), band_j)
            state_t, lg_t = dec.step(state_t, tok_t, enc_t, encp_t,
                                     torch.from_numpy(mask), band_t)
            np.testing.assert_allclose(lg_t.numpy(), np.asarray(lg_j), **TOL)
            for k in ("h", "c", "att_w", "context"):
                np.testing.assert_allclose(state_t[k].numpy(),
                                           np.asarray(state_j[k]), **TOL,
                                           err_msg=k)
            tok_j = jnp.argmax(lg_j, -1).astype(jnp.int32)
            tok_t = torch.argmax(lg_t, -1).to(torch.int32)
            np.testing.assert_array_equal(tok_t.numpy(), np.asarray(tok_j))


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
def test_stacked_step_beam_matches_jax(att_type):
    """``step_beam`` over B*K rows from a random state (h, c [L,B*K,H],
    att_w [B,K,T]) with shared encoder tensors."""
    Kb = 3
    jdec, p, dec, enc, _ = setup(att_type, seed=3)
    rng = np.random.RandomState(4)
    mask = (np.arange(T)[None] < ENC_LEN[:, None]).astype(np.float32)
    att = rng.rand(B, Kb, T).astype(np.float32) * mask[:, None]
    state = {"h": rng.randn(2, B * Kb, 16).astype(np.float32),
             "c": rng.randn(2, B * Kb, 16).astype(np.float32),
             "att_w": att / att.sum(-1, keepdims=True),
             "context": rng.randn(B * Kb, 32).astype(np.float32)}
    tokens = rng.randint(0, V, size=(B * Kb,)).astype(np.int32)
    enc_j = jnp.asarray(enc)
    encp_j = _jax_step(jdec, p, jdec.precompute, enc_j)
    band_j = (_jax_step(jdec, p, jdec.build_loc_band, T)
              if att_type == "loc" else None)
    ref_state, ref = _jax_step(
        jdec, p, jdec.step_beam, {k: jnp.asarray(v) for k, v in state.items()},
        jnp.asarray(tokens), enc_j, encp_j, jnp.asarray(mask), Kb, band_j)
    enc_t = torch.from_numpy(enc)
    with torch.no_grad():
        got_state, got = dec.step_beam(
            {k: torch.from_numpy(v) for k, v in state.items()},
            torch.from_numpy(tokens), enc_t, dec.precompute(enc_t),
            torch.from_numpy(mask), Kb,
            dec.build_loc_band(T) if att_type == "loc" else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    for k in ("h", "c", "att_w", "context"):
        np.testing.assert_allclose(got_state[k].numpy(),
                                   np.asarray(ref_state[k]), **TOL, err_msg=k)
    assert dec.init_state_beam(B, Kb, T)["h"].shape == (2, B * Kb, 16)
