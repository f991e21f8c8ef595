"""PyTorch port: the attention decoder against the JAX package on the CPU.

The same parameters (a flax ``init``, bridged) and the same inputs (numpy
seeds) go through the JAX fused decoder (``ops/pallas_decoder.py``, its
Pallas kernels in interpret mode) and through the port's plain versions
(``ops/las_decoder.py``), which are what a CPU tensor runs, for dot, add
and location-aware attention. Small sizes: B=4, T'=24, L=11, H=32, and
for loc C=4 channels of a width-7 filter (the JAX suite marks its loc
interpret cases slow at larger sizes). Each test takes 0.3 to 4 s on one
CPU thread, the loc cases at most 4 s; the first dot case of a process
about 8 s more, JAX's compilation included.

Tolerances: the forward in f32, logits rtol/atol 1e-5 and the fed-back
tokens identical (the JAX suite's fused-against-scan tolerance,
``tests/test_pallas_decoder.py``); the gradients in f32, atol 2e-5 of
each gradient's largest magnitude (the same suite's). In bf16 both sides
round the same operands to bf16 and sum the exact products in f32, in
another order: the logits differ by f32 rounding (1.2e-7 of the largest
logit, measured over 8 seeds). A sum that landed on the other side of a
bf16 rounding boundary would change an operand by one bf16 ulp (2^-8
relative) and the logits by about 4e-3, and a wrongly rounded operand
by more: rtol 1e-4 with atol 1e-4 of the largest logit catches both
(the JAX suite's loosest decoder tolerance, bf16 against f32, is rtol
5e-3), and the fed-back tokens must be identical.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.config import ModelConfig
from gluon_e2e_asr_tpu.models.decoder import AttentionDecoder as JaxDecoder
from gluon_e2e_asr_tpu.ops.pallas_decoder import (
    build_loc_band_cmajor, las_decoder_fused, las_decoder_fwd)
from gluon_e2e_asr_tpu_torch.bridge import params_from_jax
from gluon_e2e_asr_tpu_torch.models.decoder import AttentionDecoder
from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

torch.set_num_threads(1)

V = 12
B, T, L = 4, 24, 11
ENC_LEN = np.array([24, 20, 17, 5], np.int32)


def _cfg(att_type, **kw):
    sizes = dict(enc_hidden=32, dec_hidden=32, dec_embed=16, att_dim=16,
                 dec_layers=1, loc_conv_channels=4, loc_conv_width=7)
    return ModelConfig(att_type=att_type, **{**sizes, **kw})


def _setup(att_type, seed=0):
    """(cfg, JAX decoder, its params as numpy, enc, tokens, coins [B,L])."""
    cfg = _cfg(att_type)
    rng = np.random.RandomState(seed)
    enc = rng.randn(B, T, 2 * cfg.enc_hidden).astype(np.float32)
    tokens = rng.randint(0, V, size=(B, L)).astype(np.int32)
    tokens[:, 0] = 2
    coins = rng.rand(B, L) < 0.5
    coins[:, 0] = False
    dec = JaxDecoder(cfg, V)
    variables = dec.init(jax.random.PRNGKey(seed), jnp.asarray(enc),
                         jnp.asarray(ENC_LEN), jnp.asarray(tokens))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    return cfg, dec, params, enc, tokens, coins


def _port(cfg, params):
    dec = AttentionDecoder(cfg, V)
    state = params_from_jax({"decoder": params})
    dec.load_state_dict({k[len("decoder."):]: v for k, v in state.items()})
    return dec


def _jax_args(cfg, p, enc, enc_proj, tokens, coins):
    """las_decoder_fwd's operands; the band (index 5) is None but for loc,
    where it is the channel-major band of the filter."""
    mask = (np.arange(T)[None] < ENC_LEN[:, None]).astype(np.float32)
    A = cfg.att_dim
    args = [jnp.asarray(a) for a in (
        tokens, coins.astype(np.float32), enc, enc_proj, mask,
        np.zeros((1, 1), np.float32), p["embed"], p["cell0_wx"],
        p["cell0_b"], p["cell0_wh"], p["att_q"],
        p.get("att_b", np.zeros((A,), np.float32)),
        p.get("att_v", np.zeros((A, 1), np.float32)),
        p.get("loc_proj", np.zeros((1, A), np.float32)), p["out_w"],
        p["out_b"])]
    args[5] = (build_loc_band_cmajor(jnp.asarray(p["loc_filter"]), T)
               if cfg.att_type == "loc" else None)
    return args


def _port_args(dec, enc, enc_proj, tokens, coins, grad=False):
    enc_t = torch.from_numpy(enc).requires_grad_(grad)
    encp_t = torch.from_numpy(enc_proj).requires_grad_(grad)
    return (torch.from_numpy(tokens), torch.from_numpy(coins), enc_t, encp_t,
            torch.from_numpy(ENC_LEN), dec.weights())


def _band(dec):
    """The port's channel-major band of a loc decoder (None otherwise)."""
    if dec.cfg.att_type != "loc":
        return None
    return K.build_loc_band_cmajor(dec.loc_filter.detach(), T)


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
@pytest.mark.parametrize("with_coins", [False, True])
def test_forward_matches_jax_fused(att_type, with_coins):
    cfg, _, p, enc, tokens, coins = _setup(att_type)
    if not with_coins:
        coins[:] = False
    enc_proj = enc @ p["att_k"]
    args = _jax_args(cfg, p, enc, enc_proj, tokens, coins)
    ref, (h, c, att, ctx, tok) = las_decoder_fwd(
        *args, compute_dtype="float32", l_chunk=4, is_dot=att_type == "dot")
    dec = _port(cfg, p)
    with torch.no_grad():
        got, resid = K.las_decoder_fwd_plain(
            *_port_args(dec, enc, enc_proj, tokens, coins), torch.float32,
            att_type, _band(dec))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(resid[4].numpy(), np.asarray(tok))
    for name, a, b in zip(("h", "c", "att", "ctx"), resid[:4], (h, c, att, ctx)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-5, err_msg=name)
    if with_coins:  # the coins did feed back some argmax
        assert (resid[4].numpy() != tokens).any()


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
@pytest.mark.parametrize("with_coins", [False, True])
def test_gradients_match_jax_vjp(att_type, with_coins):
    """Every gradient of las_decoder_fused's VJP against the port's
    autograd Function; in loc mode the filter's comes through the band
    built from it on both sides (JAX: ``build_loc_band_cmajor`` inside
    the differentiated function)."""
    cfg, _, p, enc, tokens, coins = _setup(att_type, seed=1)
    if not with_coins:
        coins[:] = False
    enc_proj = enc @ p["att_k"]
    cot = np.random.RandomState(5).randn(B, L, V).astype(np.float32)
    args = _jax_args(cfg, p, enc, enc_proj, tokens, coins)
    is_loc = att_type == "loc"
    if not is_loc:
        args[5] = jnp.zeros((1, 1), jnp.float32)
    diff = (2, 3, 6, 7, 8, 9, 10, 14, 15) + (
        (11, 12) if att_type != "dot" else ()) + ((5, 13) if is_loc else ())

    def f(*d):
        full = list(args)
        for i, a in zip(diff, d):
            full[i] = a
        if is_loc:  # index 5 carries the filter, built into the band here
            full[5] = build_loc_band_cmajor(full[5], T)
        return las_decoder_fused(("float32", 4, att_type), *full)

    primals = [jnp.asarray(p["loc_filter"]) if i == 5 else args[i] for i in diff]
    _, vjp = jax.vjp(f, *primals)
    ref = dict(zip(diff, vjp(jnp.asarray(cot))))
    dec = _port(cfg, p)
    tokens_t, coins_t, enc_t, encp_t, len_t, w = _port_args(
        dec, enc, enc_proj, tokens, coins, grad=True)
    logits = K.las_decoder(tokens_t, coins_t, enc_t, encp_t, len_t, w,
                           torch.float32, att_type,
                           dec.loc_filter if is_loc else None)
    (logits * torch.from_numpy(cot)).sum().backward()
    got = {2: enc_t.grad, 3: encp_t.grad, 6: dec.embed.grad,
           7: dec.cell0_wx.grad, 8: dec.cell0_b.grad, 9: dec.cell0_wh.grad,
           10: dec.att_q.grad, 14: dec.out_w.grad, 15: dec.out_b.grad}
    if att_type != "dot":
        got.update({11: dec.att_b.grad, 12: dec.att_v.grad})
    if is_loc:
        got.update({5: dec.loc_filter.grad, 13: dec.loc_proj.grad})
    for i in diff:
        a, b = np.asarray(ref[i]), got[i].numpy()
        scale = max(np.abs(a).max(), 1e-6)
        np.testing.assert_allclose(b / scale, a / scale, atol=2e-5,
                                   err_msg=f"operand {i}")


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
def test_bf16_forward_matches_jax_interpret(att_type):
    cfg, _, p, enc, tokens, coins = _setup(att_type, seed=2)
    enc_proj = enc @ p["att_k"]
    args = _jax_args(cfg, p, enc, enc_proj, tokens, coins)
    ref, resid = las_decoder_fwd(*args, compute_dtype="bfloat16", l_chunk=4,
                                 is_dot=att_type == "dot")
    dec = _port(cfg, p)
    with torch.no_grad():
        got, mine = K.las_decoder_fwd_plain(
            *_port_args(dec, enc, enc_proj, tokens, coins), torch.bfloat16,
            att_type, _band(dec))
    ref = np.asarray(ref)
    np.testing.assert_array_equal(mine[4].numpy(), np.asarray(resid[4]))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                               atol=1e-4 * np.abs(ref).max())


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
@pytest.mark.parametrize("dec_impl,cd", [("scan", "float32"),
                                         ("scan", "bfloat16"),
                                         ("pallas", "float32"),
                                         ("pallas", "bfloat16")])
def test_module_forward_matches_jax_decoder(att_type, dec_impl, cd):
    """The teacher-forced pass of the module (precompute included, coins
    off) against the JAX module under both ``dec_impl`` settings: the
    scan path rounds only the precompute's operands to ``compute_dtype``,
    the fused kernel (interpret mode) every product's. f32 at 1e-5, bf16
    at 1e-4 of the largest logit (see the module docstring)."""
    cfg, _, p, enc, tokens, _ = _setup(att_type, seed=3)
    cfg = _cfg(att_type, dec_impl=dec_impl, compute_dtype=cd)
    jdec = JaxDecoder(cfg, V)
    ref = np.asarray(jdec.apply(
        {"params": jax.tree_util.tree_map(jnp.asarray, p)}, jnp.asarray(enc),
        jnp.asarray(ENC_LEN), jnp.asarray(tokens), 0.0, None))
    dec = _port(cfg, p)
    with torch.no_grad():
        got = dec(torch.from_numpy(enc), torch.from_numpy(ENC_LEN),
                  torch.from_numpy(tokens)).numpy()
    tol = 1e-5 if cd == "float32" else 1e-4
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(1.0, np.abs(ref).max()))


def _jax_step_setup(jdec, p, enc):
    v = {"params": jax.tree_util.tree_map(jnp.asarray, p)}
    enc_j = jnp.asarray(enc)
    encp_j = jdec.apply(v, enc_j, method=jdec.precompute)
    band_j = (jdec.apply(v, T, method=jdec.build_loc_band)
              if jdec.cfg.att_type == "loc" else None)
    return v, enc_j, encp_j, band_j


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
def test_step_matches_jax_step(att_type):
    """Three steps of ``step`` against the JAX method; loc with the band
    built once outside the loop."""
    cfg, jdec, p, enc, tokens, _ = _setup(att_type, seed=4)
    v, enc_j, encp_j, band_j = _jax_step_setup(jdec, p, enc)
    mask = (np.arange(T)[None] < ENC_LEN[:, None]).astype(np.float32)
    state_j = jdec.apply(v, B, T, method=jdec.init_state)
    dec = _port(cfg, p)
    enc_t = torch.from_numpy(enc)
    with torch.no_grad():
        encp_t = dec.precompute(enc_t)
        band_t = dec.build_loc_band(T) if att_type == "loc" else None
        state_t = dec.init_state(B, T)
        for i in range(3):
            state_j, lj = jdec.apply(v, state_j, jnp.asarray(tokens[:, i]),
                                     enc_j, encp_j, jnp.asarray(mask), band_j,
                                     method=jdec.step)
            state_t, lt = dec.step(state_t, torch.from_numpy(tokens[:, i]),
                                   enc_t, encp_t, torch.from_numpy(mask),
                                   band_t)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                                       atol=1e-5)
    for k in ("h", "c", "att_w", "context"):
        np.testing.assert_allclose(state_t[k].numpy(), np.asarray(state_j[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("att_type,use_band", [
    ("dot", True), ("add", True), ("loc", True), ("loc", False)],
    ids=["dot", "add", "loc-band", "loc-conv"])
def test_step_beam_matches_jax_step_beam(att_type, use_band):
    """Three beam-layout steps (K=3, the encoder tensors unreplicated)
    against ``step_beam``; loc through the band and through the
    convolution fallback."""
    K_ = 3
    cfg, jdec, p, enc, tokens, _ = _setup(att_type, seed=6)
    v, enc_j, encp_j, band_j = _jax_step_setup(jdec, p, enc)
    if not use_band:
        band_j = None
    mask = (np.arange(T)[None] < ENC_LEN[:, None]).astype(np.float32)
    toks = np.random.RandomState(9).randint(0, V, size=(3, B * K_)).astype(np.int32)
    state_j = jdec.apply(v, B, K_, T, method=jdec.init_state_beam)
    dec = _port(cfg, p)
    enc_t = torch.from_numpy(enc)
    with torch.no_grad():
        encp_t = dec.precompute(enc_t)
        band_t = (dec.build_loc_band(T) if att_type == "loc" and use_band
                  else None)
        state_t = dec.init_state_beam(B, K_, T)
        for i in range(3):
            state_j, lj = jdec.apply(v, state_j, jnp.asarray(toks[i]), enc_j,
                                     encp_j, jnp.asarray(mask), K_, band_j,
                                     method=jdec.step_beam)
            state_t, lt = dec.step_beam(state_t, torch.from_numpy(toks[i]),
                                        enc_t, encp_t, torch.from_numpy(mask),
                                        K_, band_t)
            np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                                       atol=1e-5)
    for k in ("h", "c", "att_w", "context"):
        assert state_t[k].shape == state_j[k].shape, k
        np.testing.assert_allclose(state_t[k].numpy(), np.asarray(state_j[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("width", [7, 100])
def test_loc_bands_and_convolution_match_jax(width):
    """The (t,c)-minor band of ``build_loc_band``, the channel-major band
    of ``build_loc_band_cmajor`` and the convolution fallback (SAME
    padding: (w-1)//2 frames before, 49 at the even width 100) against
    JAX, on attention weights that are not a softmax (every frame
    counts)."""
    cfg = _cfg("loc", loc_conv_width=width)
    jdec = JaxDecoder(cfg, V)
    p = jax.tree_util.tree_map(np.asarray, jdec.init(
        jax.random.PRNGKey(3), jnp.zeros((B, T, 64)), jnp.asarray(ENC_LEN),
        jnp.zeros((B, L), jnp.int32))["params"])
    v = {"params": jax.tree_util.tree_map(jnp.asarray, p)}
    dec = _port(cfg, p)
    att = np.random.RandomState(2).rand(5, T).astype(np.float32)
    band_j = np.asarray(jdec.apply(v, T, method=jdec.build_loc_band))
    with torch.no_grad():
        np.testing.assert_array_equal(dec.build_loc_band(T).numpy(), band_j)
        np.testing.assert_array_equal(
            K.build_loc_band_cmajor(dec.loc_filter, T).numpy(),
            np.asarray(build_loc_band_cmajor(jnp.asarray(p["loc_filter"]), T)))
        for band in (jnp.asarray(band_j), None):
            ref = jdec.apply(v, jnp.asarray(att), band,
                             method=lambda m, a, b: m._loc_feature(a, b))
            got = dec._loc_feature(torch.from_numpy(att),
                                   None if band is None else dec.build_loc_band(T))
            np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                                       atol=1e-6)
    assert dec.build_loc_band(2001) is None  # 2001^2 * 4 > 16e6: the conv


@pytest.mark.parametrize("att_type", ["dot", "add", "loc"])
def test_parameters_match_flax_names_and_shapes(att_type):
    cfg, _, p, *_ = _setup(att_type) if att_type != "loc" else (
        _cfg("loc", loc_conv_channels=4, loc_conv_width=7), None, None)
    if p is None:
        dec_j = JaxDecoder(cfg, V)
        p = jax.tree_util.tree_map(np.asarray, dec_j.init(
            jax.random.PRNGKey(0), jnp.zeros((B, T, 64)), jnp.asarray(ENC_LEN),
            jnp.zeros((B, L), jnp.int32))["params"])
    dec = AttentionDecoder(cfg, V)
    ours = {k: tuple(v.shape) for k, v in dec.state_dict().items()}
    assert ours == {k: v.shape for k, v in p.items()}
    _port(cfg, p)  # loads strictly


def test_initializers_follow_flax():
    cfg = _cfg("add", enc_hidden=64, dec_hidden=64, dec_embed=128, att_dim=96)
    dec = AttentionDecoder(cfg, 40)
    dec.reset_parameters(torch.Generator().manual_seed(0))
    np.testing.assert_allclose(dec.embed.std().item(), 1 / np.sqrt(128), rtol=0.1)
    for name in ("cell0_wx", "att_q", "att_k", "out_w"):
        p = getattr(dec, name)
        np.testing.assert_allclose(p.std().item(), 1 / np.sqrt(p.shape[0]),
                                   rtol=0.1, err_msg=name)
    wh = dec.cell0_wh.detach()
    np.testing.assert_allclose((wh @ wh.T).numpy(), np.eye(64), atol=1e-5)
    for name in ("cell0_b", "att_b", "out_b"):
        assert not getattr(dec, name).any()


@pytest.mark.parametrize("kw,match", [
    ({"att_type": "add", "dec_layers": 2}, "dec_layers"),
    ({"att_type": "dot", "dec_layers": 2}, "dec_layers"),
])
def test_unported_decoders_raise(kw, match):
    """Stacked decoder layers raised until the port ran them; now the
    teacher-forced pass of a decoder with ``dec_layers`` 2 matches the JAX
    decoder's route for it (its scan over ``step``) at rtol/atol 1e-5,
    and never runs K4's plain version (``match`` names the option)."""
    kw = dict(kw)
    att_type = kw.pop("att_type")
    cfg = _cfg(att_type, **kw)
    rng = np.random.RandomState(3)
    enc = rng.randn(B, T, 64).astype(np.float32)
    tokens = rng.randint(0, V, size=(B, L)).astype(np.int32)
    tokens[:, 0] = 2
    jdec = JaxDecoder(cfg, V)
    params = jdec.init(jax.random.PRNGKey(0), jnp.asarray(enc),
                       jnp.asarray(ENC_LEN), jnp.asarray(tokens))["params"]
    ref = jdec.apply({"params": params}, jnp.asarray(enc),
                     jnp.asarray(ENC_LEN), jnp.asarray(tokens))
    dec = _port(cfg, jax.tree_util.tree_map(np.asarray, params))
    assert getattr(dec.cfg, match) == 2
    calls = K.las_decoder_fwd_plain.calls
    with torch.no_grad():
        got = dec(torch.from_numpy(enc), torch.from_numpy(ENC_LEN),
                  torch.from_numpy(tokens))
    assert K.las_decoder_fwd_plain.calls == calls
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-5)


def test_add_attention_on_a_non_cpu_tensor_is_refused():
    """The kernels take CUDA tensors only, every mode; an unknown mode and
    a device with no implementation raise (no silent plain path)."""
    cfg, _, p, enc, tokens, coins = _setup("add")
    dec = _port(cfg, p)
    args = list(_port_args(dec, enc, enc @ p["att_k"], tokens, coins))
    for kind in ("add", "loc"):
        with pytest.raises(ValueError, match="CUDA"):
            K.las_decoder_fwd_kernel(*args, torch.float32, kind)
    with pytest.raises(ValueError, match="att_kind"):
        K.las_decoder(*args, torch.float32, "location")
    args[2] = args[2].to("meta")
    with pytest.raises(ValueError, match="no implementation"):
        K.las_decoder(*args, torch.float32, "dot")
