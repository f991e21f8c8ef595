"""PyTorch port on the card: the decoder kernels K4-fwd and K4-bwd
(csrc/las_decoder.cu) against their plain versions at small, ragged
shapes (an odd batch, a row with no frames, T' and V not multiples of
anything), then the decoder's gradient on the card against the same
function on the CPU.

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


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _case(dev, B, L, T, D, A, E, H, V, seed=0, coin_p=0.0):
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
    w = Weights(f(V, E) / np.sqrt(E), f(E + D, 4 * H) / np.sqrt(E + D),
                f(4 * H) * 0.1, f(H, 4 * H) / np.sqrt(H), f(H, A) / np.sqrt(H),
                torch.zeros(A, device=dev), torch.zeros(A, 1, device=dev),
                f(H + D, V) / np.sqrt(H + D), f(V) * 0.1)
    enc_proj = enc @ (f(D, A) / np.sqrt(D))
    return (torch.from_numpy(tokens).to(dev), torch.from_numpy(coins).to(dev),
            enc, enc_proj, torch.from_numpy(enc_len).to(dev), w)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-30))


SHAPES = [(3, 7, 19, 12, 8, 6, 8, 11), (5, 12, 33, 64, 40, 24, 40, 32),
          (2, 5, 9, 640, 320, 256, 320, 32)]


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", SHAPES)
def test_forward_kernel_matches_plain(dev, cd, dims):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args = _case(dev, *dims)
    logits, resid, (acts, q) = K.las_decoder_fwd_kernel(*args, cd, "dot")
    ref, ref_resid = K.las_decoder_fwd_plain(*args, cd, "dot")
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


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
def test_forward_kernel_with_scheduled_sampling(dev, cd):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args = _case(dev, 6, 12, 33, 64, 40, 24, 40, 32, seed=3, coin_p=0.5)
    logits, resid, _ = K.las_decoder_fwd_kernel(*args, cd, "dot")
    ref, ref_resid = K.las_decoder_fwd_plain(*args, cd, "dot")
    torch.cuda.synchronize()
    same = (resid[4].long() == ref_resid[4].long()).all(1)
    if cd == torch.float32:
        assert same.all()
    assert same.float().mean() >= 0.5
    assert _rel(logits[same], ref[same]) <= REL[cd]


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dims", SHAPES)
def test_backward_kernel_matches_plain(dev, cd, dims):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args = _case(dev, *dims, seed=1)
    tokens, coins, enc, enc_proj, enc_len, w = args
    _, resid, extras = K.las_decoder_fwd_kernel(*args, cd, "dot")
    B, L, V = tokens.shape + (w.embed.shape[0],)
    dl = torch.from_numpy(np.random.RandomState(7).randn(B, L, V)
                          .astype(np.float32)).to(dev)
    got = K.las_decoder_bwd_kernel(dl, resid, extras, enc, enc_proj, enc_len,
                                   w, cd, "dot")
    ref = K.las_decoder_bwd_plain(dl, resid, enc, enc_proj, enc_len, w, cd,
                                  "dot")
    torch.cuda.synchronize()
    for name in ("dgates", "dctx", "dqb", "demb", "d_encp"):
        assert torch.isfinite(got[name]).all(), name
        assert _rel(got[name], ref[name]) <= REL[cd], (name, _rel(got[name], ref[name]))


def test_autograd_on_card_matches_cpu(dev):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args = _case(dev, 5, 12, 33, 64, 40, 24, 40, 32, seed=2, coin_p=0.3)
    dl = np.random.RandomState(8).randn(5, 12, 32).astype(np.float32)
    grads = {}
    for d in (dev, torch.device("cpu")):
        tokens, coins, enc, enc_proj, enc_len = (t.to(d) for t in args[:5])
        enc = enc.clone().requires_grad_(True)
        enc_proj = enc_proj.clone().requires_grad_(True)
        w = K.Weights(*(t.to(d).clone().requires_grad_(i not in (5, 6))
                        for i, t in enumerate(args[5])))
        before = K.las_decoder_bwd_kernel.launches
        logits = K.las_decoder(tokens, coins, enc, enc_proj, enc_len, w)
        (logits * torch.from_numpy(dl).to(d)).sum().backward()
        assert K.las_decoder_bwd_kernel.launches == before + (d.type == "cuda")
        grads[d.type] = [enc.grad.cpu(), enc_proj.grad.cpu()] + [
            t.grad.cpu() for i, t in enumerate(w) if i not in (5, 6)]
    for g, r in zip(grads["cuda"], grads["cpu"]):
        assert _rel(g, r) <= REL[torch.float32]


def test_add_attention_raises_on_the_card(dev):
    from gluon_e2e_asr_tpu_torch.ops import las_decoder as K

    args = _case(dev, 3, 7, 19, 12, 8, 6, 8, 11)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        K.las_decoder(*args, torch.float32, "add")
