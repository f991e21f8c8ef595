"""PyTorch port on the card: the decoder kernels K4-fwd and K4-bwd
(csrc/las_decoder.cu) in dot, add and loc mode against their plain
versions at small, ragged shapes (an odd batch, a batch not a multiple of
K4-bwd's 8-row clusters, a row with no frames, T' and V not multiples of
anything, widths that leave the cluster's column slices padded, a filter
wider than T'), K4-bwd's cluster kernel at the flagships' widths (the
4.0 s bucket and T'=320), the kernel it takes by shape alone, its counts
and its refusals, K4-fwd's cluster kernel the same way (ragged shapes:
B=1, B not a multiple of 8, odd D and H; the flagships' widths; the
route mirror; the refusals), then the decoder's gradient on the card
against the same function on the CPU.

Marked ``cuda``: these skip where there is no CUDA device. On a machine
with the card and nvcc, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_decoder.py``.

Tolerances. f32: only the order of the sums differs, 1e-4 of each
output's largest magnitude, and the fed-back tokens identical. bf16: a
sum that lands on the other side of a bf16 rounding boundary changes an
operand of the next product by one bf16 ulp, and the recurrence carries
it along: 2e-2 of the largest magnitude. With scheduled sampling on in
bf16, such a flip can change an argmax and so a whole row's later
inputs: the rows whose fed-back tokens agree are compared, and most rows
must agree.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

REL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
MODES = ["dot", "add", "loc"]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(dev, B, L, T, D, A, E, H, V, seed=0, coin_p=0.0, kind="dot",
          C=4, W=7):
    """(tokens, coins, enc, enc_proj, enc_len, weights) and the loc filter
    [W,1,C] (None unless loc)."""
    from gluon_e2e_asr_tpu_torch.ops.las_decoder import Weights

    rng = np.random.RandomState(seed)
    f = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32)).to(dev)  # noqa: E731
    enc_len = rng.randint(1, T + 1, size=B).astype(np.int32)
    enc_len[0] = T
    enc_len[-1] = 0  # a pad row: no frames
    tokens = rng.randint(0, V, size=(B, L)).astype(np.int32)
    tokens[:, 0] = 2
    coins = rng.rand(B, L) < coin_p
    coins[:, 0] = False
    enc = torch.tanh(f(B, T, D))
    z = lambda *s: torch.zeros(*s, device=dev)  # noqa: E731
    energy = kind != "dot"
    w = Weights(f(V, E) / np.sqrt(E), f(E + D, 4 * H) / np.sqrt(E + D),
                f(4 * H) * 0.1, f(H, 4 * H) / np.sqrt(H), f(H, A) / np.sqrt(H),
                f(A) * 0.1 if energy else z(A),
                f(A, 1) / np.sqrt(A) if energy else z(A, 1),
                f(C, A) / np.sqrt(C) if kind == "loc" else z(1, A),
                f(H + D, V) / np.sqrt(H + D), f(V) * 0.1)
    enc_proj = enc @ (f(D, A) / np.sqrt(D))
    filt = f(W, 1, C) / np.sqrt(W) if kind == "loc" else None
    return (torch.from_numpy(tokens).to(dev), torch.from_numpy(coins).to(dev),
            enc, enc_proj, torch.from_numpy(enc_len).to(dev), w), filt


def _band(filt, T):
    from gluon_e2e_asr_tpu_torch.ops.las_decoder import build_loc_band_cmajor

    return None if filt is None else build_loc_band_cmajor(filt, T)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


SHAPES = [(3, 7, 19, 12, 8, 6, 8, 11), (5, 12, 33, 64, 40, 24, 40, 32),
          (2, 5, 9, 640, 320, 256, 320, 32), (11, 6, 13, 18, 8, 6, 10, 11)]


@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", SHAPES)
def test_forward_kernel_matches_plain(dev, cd, dims, kind):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, filt = _case(dev, *dims, kind=kind)
    logits, resid, (acts, q) = K.las_decoder_fwd_kernel(*args, cd, kind, filt)
    ref, ref_resid = K.las_decoder_fwd_plain(*args, cd, kind,
                                             _band(filt, dims[2]))
    torch.cuda.synchronize()
    assert torch.isfinite(logits).all()
    assert _rel(logits, ref) <= REL[cd]
    for name, a, b in zip(("h", "c", "att", "ctx"), resid[:4], ref_resid[:4]):
        assert _rel(a, b) <= REL[cd], name
    assert torch.equal(resid[4].long(), ref_resid[4].long())
    assert not resid[2][-1].any()  # the pad row attends nowhere
    T = args[2].shape[1]
    lens = args[4].long()
    for b in range(len(lens)):
        assert not resid[2][b, :, lens[b]:T].any()


@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_forward_kernel_with_scheduled_sampling(dev, cd, kind):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, filt = _case(dev, 6, 12, 33, 64, 40, 24, 40, 32, seed=3, coin_p=0.5,
                       kind=kind)
    logits, resid, _ = K.las_decoder_fwd_kernel(*args, cd, kind, filt)
    ref, ref_resid = K.las_decoder_fwd_plain(*args, cd, kind, _band(filt, 33))
    torch.cuda.synchronize()
    same = (resid[4].long() == ref_resid[4].long()).all(1)
    if cd == torch.float32:
        assert same.all()
    assert same.float().mean() >= 0.5
    assert _rel(logits[same], ref[same]) <= REL[cd]


@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", SHAPES)
def test_backward_kernel_matches_plain(dev, cd, dims, kind):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, filt = _case(dev, *dims, seed=1, kind=kind)
    tokens, coins, enc, enc_proj, enc_len, w = args
    _, resid, extras = K.las_decoder_fwd_kernel(*args, cd, kind, filt)
    B, L, V = tokens.shape + (w.embed.shape[0],)
    dl = torch.from_numpy(np.random.RandomState(7).randn(B, L, V)
                          .astype(np.float32)).to(dev)
    got = K.las_decoder_bwd_kernel(dl, resid, extras, enc, enc_proj, enc_len,
                                   w, cd, kind, filt)
    ref = K.las_decoder_bwd_plain(dl, resid, enc, enc_proj, enc_len, w, cd,
                                  kind, _band(filt, dims[2]))
    torch.cuda.synchronize()
    _assert_streams_match(got, ref, kind, cd)


def _assert_streams_match(got, ref, kind, cd):
    names = ["dgates", "dctx", "dqb", "demb", "d_encp"]
    names += [] if kind == "dot" else ["d_att_v"]
    names += ["d_loc_proj", "dfct"] if kind == "loc" else []
    for name in names:
        assert torch.isfinite(got[name]).all(), name
        assert _rel(got[name], ref[name]) <= REL[cd], (name, _rel(got[name], ref[name]))


def _backward(dev, dims, kind, cd, seed=1, **kw):
    """K4-bwd on the card and the plain sweep on the same K4-fwd
    residuals; (kernel streams, plain streams, route, counts before)."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, filt = _case(dev, *dims, seed=seed, kind=kind, **kw)
    tokens, coins, enc, enc_proj, enc_len, w = args
    _, resid, extras = K.las_decoder_fwd_kernel(*args, cd, kind, filt)
    B, L, V = tokens.shape + (w.embed.shape[0],)
    dl = torch.from_numpy(np.random.RandomState(7).randn(B, L, V)
                          .astype(np.float32) * 0.05).to(dev)
    fn = K.las_decoder_bwd_kernel
    before = (fn.launches, fn.cluster_launches)
    got = fn(dl, resid, extras, enc, enc_proj, enc_len, w, cd, kind, filt)
    ref = K.las_decoder_bwd_plain(dl, resid, enc, enc_proj, enc_len, w, cd,
                                  kind, _band(filt, dims[2]))
    torch.cuda.synchronize()
    C, W = (filt.shape[2], filt.shape[0]) if filt is not None else (0, 0)
    T, D, A, E, H = dims[2:7]
    route = K.bwd_route(kind, cd, T, D, A, E, H, V, C, W)
    return got, ref, route, before


# B, L, T', D, A, E, H, V of the flagships at the 4.0 s bucket and at
# bench.py's T'
FLAGSHIP_SHAPES = [(96, 81, 100, 640, 320, 256, 320, 32),
                   (96, 97, 320, 640, 320, 256, 320, 32)]


@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", FLAGSHIP_SHAPES)
def test_backward_cluster_kernel_at_the_flagship_shapes(dev, cd, dims, kind):
    """bwd_cluster_kernel at the flagships' widths (loc: C=10 channels of
    a width-100 filter), within chip_smoke.py's TOL_DEC (REL here)."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    got, ref, route, before = _backward(dev, dims, kind, cd, seed=5, C=10,
                                        W=100)
    assert route == "cluster"
    fn = K.las_decoder_bwd_kernel
    assert (fn.launches, fn.cluster_launches) == (before[0] + 1, before[1] + 1)
    _assert_streams_match(got, ref, kind, cd)


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_backward_cluster_kernel_with_odd_widths_in_dot_mode(dev, cd):
    """Dot attention takes any A: every width odd (A=11, D=19, E=7, H=13,
    V=5), so no product input, slice or frame row is a multiple of 4."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    got, ref, route, before = _backward(dev, (9, 6, 15, 19, 11, 7, 13, 5),
                                        "dot", cd)
    fn = K.las_decoder_bwd_kernel
    assert route == "cluster"
    assert fn.cluster_launches == before[1] + 1
    _assert_streams_match(got, ref, "dot", cd)


@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("dims", SHAPES)
def test_cluster_launches_count_the_cluster_kernel(dev, dims, kind):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    _, _, route, before = _backward(dev, dims, kind, torch.bfloat16)
    fn = K.las_decoder_bwd_kernel
    assert route == "cluster"
    assert (fn.launches, fn.cluster_launches) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_a_shape_the_cluster_plan_does_not_hold_takes_bwd_kernel(dev, cd, kind):
    """An 8000-word vocabulary: the cluster kernel's head input (8 rows of
    dlogits) outgrows its plan, so the shape goes to bwd_kernel, by shape
    alone, and is right there."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    got, ref, route, before = _backward(dev, (3, 5, 19, 12, 8, 6, 8, 8000),
                                        kind, cd)
    fn = K.las_decoder_bwd_kernel
    assert route == "rows"
    assert (fn.launches, fn.cluster_launches) == (before[0] + 1, before[1])
    _assert_streams_match(got, ref, kind, cd)


def test_route_mirror_matches_the_library(dev):
    """ops/las_decoder.py::bwd_route against the library's own choice,
    over random shapes of every mode and dtype."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    lib = K._lib()
    code = {"cluster": 1, "rows": 0, None: -1}
    rng = np.random.RandomState(0)
    seen = set()
    for _ in range(500):
        kind = MODES[rng.randint(3)]
        cd = (torch.float32, torch.bfloat16)[rng.randint(2)]
        loc = kind == "loc"
        dims = (int(rng.randint(1, 700)), int(rng.randint(1, 2048)),
                4 * int(rng.randint(1, 129)), int(rng.randint(1, 1024)),
                int(rng.randint(1, 1025)), int(rng.randint(1, 9000)),
                int(rng.randint(1, 17)) if loc else 0,
                int(rng.randint(1, 200)) if loc else 0)
        want = lib.las_decoder_bwd_route(K.MODES[kind], int(cd == torch.bfloat16),
                                         *dims)
        route = K.bwd_route(kind, cd, *dims)
        assert code[route] == want, (kind, cd, dims)
        seen.add(route)
    assert seen == {"cluster", "rows", None}


def test_refusals_raise(dev):
    """Nothing falls back: weights laid out for the other kernel than the
    shape's, and no cluster fitting on the device, raise."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, _ = _case(dev, 3, 7, 19, 12, 8, 6, 8, 11, kind="dot")
    tokens, coins, enc, enc_proj, enc_len, w = args
    _, resid, extras = K.las_decoder_fwd_kernel(*args, torch.float32, "dot")
    dl = torch.zeros(3, 7, 11, device=dev)
    real = K.bwd_route
    K.bwd_route = lambda *a: "rows"
    try:
        with pytest.raises(RuntimeError, match="laid out for the other"):
            K.las_decoder_bwd_kernel(dl, resid, extras, enc, enc_proj,
                                     enc_len, w, torch.float32, "dot")
    finally:
        K.bwd_route = real
    with pytest.raises(RuntimeError, match="no cluster of 8 CTAs"):
        K._launched(K._lib(), -1, "las_decoder_bwd", (3, 7))


@pytest.mark.parametrize("kind", MODES)
def test_autograd_on_card_matches_cpu(dev, kind):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, filt = _case(dev, 5, 12, 33, 64, 40, 24, 40, 32, seed=2,
                       coin_p=0.3, kind=kind)
    dl = np.random.RandomState(8).randn(5, 12, 32).astype(np.float32)
    consts = {"dot": (5, 6, 7), "add": (7,), "loc": ()}[kind]
    grads = {}
    for d in (dev, torch.device("cpu")):
        tokens, coins, enc, enc_proj, enc_len = (t.to(d) for t in args[:5])
        enc = enc.clone().requires_grad_(True)
        enc_proj = enc_proj.clone().requires_grad_(True)
        w = K.Weights(*(t.to(d).clone().requires_grad_(i not in consts)
                        for i, t in enumerate(args[5])))
        f = None if filt is None else filt.to(d).clone().requires_grad_(True)
        before = K.las_decoder_bwd_kernel.by_mode[kind]
        logits = K.las_decoder(tokens, coins, enc, enc_proj, enc_len, w,
                               torch.float32, kind, f)
        (logits * torch.from_numpy(dl).to(d)).sum().backward()
        assert K.las_decoder_bwd_kernel.by_mode[kind] == before + (d.type == "cuda")
        grads[d.type] = [enc.grad.cpu(), enc_proj.grad.cpu()] + [
            t.grad.cpu() for i, t in enumerate(w) if i not in consts] + (
            [f.grad.cpu()] if f is not None else [])
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert _rel(g, r) <= REL[torch.float32]


def test_unknown_mode_and_oversized_shapes_raise(dev):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, _ = _case(dev, 3, 7, 19, 12, 8, 6, 8, 11)
    with pytest.raises(ValueError, match="att_kind"):
        K.las_decoder_fwd_kernel(*args, torch.float32, "location")
    for A in (600, 10):  # above the limit; not a multiple of 4
        wide, _ = _case(dev, 2, 3, 5, 12, A, 6, 8, 11, kind="add")
        with pytest.raises(ValueError, match="att_dim"):
            K.las_decoder_fwd_kernel(*wide, torch.float32, "add")


# ---------------------------------------------------------------------------
# K4-fwd's cluster kernel (fwd_cluster_kernel)
# ---------------------------------------------------------------------------


def _forward(dev, dims, kind, cd, seed=0, **kw):
    """K4-fwd on the card and the plain forward on the same inputs, the
    gate activations and query recomputed from the plain residuals;
    (kernel outputs, plain outputs, route, counts before), each output
    (logits, h, c, att, ctx, acts, q) and the tokens."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, filt = _case(dev, *dims, seed=seed, kind=kind, **kw)
    tokens, coins, enc, enc_proj, enc_len, w = args
    fn = K.las_decoder_fwd_kernel
    before = (fn.launches, fn.cluster_launches)
    logits, resid, (acts, q) = fn(*args, cd, kind, filt)
    ref, ref_resid = K.las_decoder_fwd_plain(*args, cd, kind,
                                             _band(filt, dims[2]))
    h, c, att, ctx, tok = ref_resid
    r = lambda x: x.to(cd).float()  # noqa: E731
    H = w.w_h.shape[0]
    x = torch.cat([r(w.embed[tok.long()]), K._shift_right(ctx)], -1)
    g = r(x) @ r(w.w_x) + w.b_x + r(K._shift_right(h)) @ r(w.w_h)
    gi, gf, gg, go = torch.split(g, H, -1)
    ref_acts = torch.cat([torch.sigmoid(gi), torch.sigmoid(gf + 1.0),
                          torch.tanh(gg), torch.sigmoid(go)], -1)
    ref_q = r(h) @ r(w.att_q) + w.att_b
    torch.cuda.synchronize()
    C, W = (filt.shape[2], filt.shape[0]) if filt is not None else (0, 0)
    T, D, A, E = dims[2:6]
    route = K.fwd_route(kind, cd, T, D, A, E, H, w.embed.shape[0], C, W)
    return ((logits, *resid[:4], acts, q), resid[4], (ref, *ref_resid[:4],
            ref_acts, ref_q), ref_resid[4], route, before)


def _assert_forward_matches(got, tok, ref, ref_tok, cd):
    assert torch.equal(tok.long(), ref_tok.long())
    for name, a, b in zip(("logits", "h", "c", "att", "ctx", "acts", "q"),
                          got, ref):
        assert torch.isfinite(a).all(), name
        assert _rel(a, b) <= REL[cd], (name, _rel(a, b))


# B, L, T', D, A, E, H, V: one row (with no frames), B not a multiple of
# 8, odd D and H (A a multiple of 4, as add and loc take it)
RAGGED = [(1, 6, 15, 19, 12, 7, 13, 5), (11, 7, 13, 19, 8, 6, 11, 11),
          (9, 5, 21, 33, 16, 9, 37, 7)]


@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", RAGGED)
def test_forward_cluster_kernel_on_ragged_shapes(dev, cd, dims, kind):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    got, tok, ref, ref_tok, route, before = _forward(dev, dims, kind, cd)
    fn = K.las_decoder_fwd_kernel
    assert route == "cluster"
    assert (fn.launches, fn.cluster_launches) == (before[0] + 1, before[1] + 1)
    _assert_forward_matches(got, tok, ref, ref_tok, cd)
    assert not got[3][-1].any()  # the row with no frames attends nowhere


@pytest.mark.parametrize("kind", MODES)
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", FLAGSHIP_SHAPES)
def test_forward_cluster_kernel_at_the_flagship_shapes(dev, cd, dims, kind):
    """fwd_cluster_kernel at the flagships' widths (loc: C=10 channels of
    a width-100 filter), within chip_smoke.py's TOL_DEC (REL here)."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    got, tok, ref, ref_tok, route, before = _forward(dev, dims, kind, cd,
                                                     seed=5, C=10, W=100)
    fn = K.las_decoder_fwd_kernel
    assert route == "cluster"
    assert fn.cluster_launches == before[1] + 1
    _assert_forward_matches(got, tok, ref, ref_tok, cd)


@pytest.mark.parametrize("kind", MODES)
def test_a_shape_the_forward_cluster_plan_does_not_hold_takes_fwd_kernel(
        dev, kind):
    """E+D+H = 3000: the cluster kernel's two gate-input buffers outgrow
    its plan, so the shape goes to fwd_kernel, by shape alone."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    got, tok, ref, ref_tok, route, before = _forward(
        dev, (3, 5, 19, 2400, 8, 300, 300, 11), kind, torch.float32)
    fn = K.las_decoder_fwd_kernel
    assert route == "rows"
    assert (fn.launches, fn.cluster_launches) == (before[0] + 1, before[1])
    _assert_forward_matches(got, tok, ref, ref_tok, torch.float32)


def test_forward_route_mirror_matches_the_library(dev):
    """ops/las_decoder.py::fwd_route against the library's own choice,
    over random shapes of every mode and dtype."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    lib = K._lib()
    code = {"cluster": 1, "rows": 0, None: -1}
    rng = np.random.RandomState(1)
    seen = set()
    for _ in range(500):
        kind = MODES[rng.randint(3)]
        cd = (torch.float32, torch.bfloat16)[rng.randint(2)]
        loc = kind == "loc"
        dims = (int(rng.randint(1, 700)), int(rng.randint(1, 2048)),
                4 * int(rng.randint(1, 129)), int(rng.randint(1, 1024)),
                int(rng.randint(1, 1025)), int(rng.randint(1, 30000)),
                int(rng.randint(1, 17)) if loc else 0,
                int(rng.randint(1, 200)) if loc else 0)
        want = lib.las_decoder_fwd_route(K.MODES[kind], int(cd == torch.bfloat16),
                                         *dims)
        route = K.fwd_route(kind, cd, *dims)
        assert code[route] == want, (kind, cd, dims)
        seen.add(route)
    assert seen == {"cluster", "rows", None}


def test_forward_refusals_raise(dev):
    """Nothing falls back: weights laid out for the other K4-fwd kernel
    than the shape's, and no cluster fitting on the device, raise, naming
    the forward's kernel."""
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args, _ = _case(dev, 3, 7, 19, 12, 8, 6, 8, 11, kind="dot")
    real = K.fwd_route
    K.fwd_route = lambda *a: "rows"
    try:
        with pytest.raises(RuntimeError, match="other K4-fwd kernel"):
            K.las_decoder_fwd_kernel(*args, torch.float32, "dot")
    finally:
        K.fwd_route = real
    with pytest.raises(RuntimeError, match="8 CTAs of fwd_cluster_kernel"):
        K._launched(K._lib(), -1, "las_decoder_fwd", (3, 7))
    with pytest.raises(RuntimeError, match="8 CTAs of bwd_cluster_kernel"):
        K._launched(K._lib(), -1, "las_decoder_bwd", (3, 7))
