"""PyTorch port on the card: the decoder kernels K4-fwd and K4-bwd
(csrc/las_decoder.cu) in dot, add and loc mode against their plain
versions at small, ragged shapes (an odd batch, a row with no frames, T'
and V not multiples of anything, a filter wider than T'), then the
decoder's gradient on the card against the same function on the CPU.

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
          (2, 5, 9, 640, 320, 256, 320, 32)]


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
    names = ["dgates", "dctx", "dqb", "demb", "d_encp"]
    names += [] if kind == "dot" else ["d_att_v"]
    names += ["d_loc_proj", "dfct"] if kind == "loc" else []
    for name in names:
        assert torch.isfinite(got[name]).all(), name
        assert _rel(got[name], ref[name]) <= REL[cd], (name, _rel(got[name], ref[name]))


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
