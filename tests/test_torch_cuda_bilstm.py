"""PyTorch port on the card: the K1-fwd kernel (csrc/bilstm_fwd.cu)
against its plain version at small, ragged shapes and at the configs'
batch and hidden sizes through both recurrence kernels (the cluster
kernel for H <= 320, the L2 one above), the encoder on the card against
the encoder on the CPU, K1-bwd's two recurrence kernels
(csrc/bilstm_bwd.cu, chosen the same way), K1-bwd's products
(csrc/gemm_sm90.cuh) and K1-fwd's bf16 projection (csrc/proj_sm90.cuh)
against their plain twins, and the v1 layer K7.

Marked ``cuda``: these skip where there is no CUDA device. On a machine
with the card and nvcc, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_bilstm.py``
(the repository's conftest imports jax, which the port does not need).
Tolerances as in chip_smoke.py: f32 sums in another order, bf16 may
flip one rounding of h.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _inputs(B, T, D, H, dev, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(1, T + 1, size=B).astype(np.int32)
    lens[0] = T
    arrays = (rng.randn(B, T, D).astype(np.float32), lens,
              (rng.randn(D, 8 * H) / np.sqrt(D)).astype(np.float32),
              (rng.randn(8 * H) * 0.1).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    return tuple(torch.from_numpy(a).to(dev) for a in arrays)


@pytest.mark.parametrize("round_xg", [False, True])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 19, 12, 8), (5, 37, 33, 40),
                                   (9, 50, 130, 130)])
def test_kernel_matches_plain(dev, shape, cd, round_xg):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args = _inputs(*shape, dev)
    y = K.bilstm_fused_kernel(*args, compute_dtype=cd, round_xg=round_xg)
    ref = K.bilstm_fused_plain(*args, compute_dtype=cd, round_xg=round_xg)
    torch.cuda.synchronize()
    assert torch.isfinite(y).all()
    assert float((y - ref).abs().max()) <= TOL[cd]


# K1-fwd at the batch sizes of the configs (milestone 2's 16, the
# flagships' 96), at 50 (a partial group of rows) and at 1 (B=1 serving),
# at both hidden sizes of the configs, in both forms and both dtypes, and
# once past 320 (recur_kernel's route): y (and c, the activations) against
# the plain version, which launch counter moved, and the recurrence alone
# (bilstm_fused_fwd_recur_kernel) on the same projection. Rows of
# different lengths in each group.
@pytest.mark.parametrize("with_cell", [False, True])
@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(1, 256), (16, 256), (50, 256), (96, 256),
                                 (1, 320), (16, 320), (50, 320), (96, 320),
                                 (5, 400)])
def test_forward_recurrence_routes_match_plain(dev, B, H, cd, with_cell):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    T, D = 24, 32
    args = _inputs(B, T, D, H, dev, seed=B + H)
    x, lens, w_x, b_x, w_hf, w_hb = args
    f = K.bilstm_fused_kernel
    counts = (f.launches, f.cluster_launches)
    out = f(*args, compute_dtype=cd, with_cell=with_cell)
    y_ref, c_ref = K.bilstm_fused_plain(*args, compute_dtype=cd, with_cell=True)
    xg = torch.cat(K._project(x, lens, w_x, b_x, cd, False), -1).contiguous()
    r = K.bilstm_fused_fwd_recur_kernel(xg, lens, w_hf, w_hb, cd, with_cell)
    torch.cuda.synchronize()
    cluster = H <= K.CLUSTER_MAX_HIDDEN
    assert (f.launches, f.cluster_launches) == (counts[0] + 1,
                                                counts[1] + cluster)
    y = out[0] if with_cell else out
    y_r = r[0] if with_cell else r
    for got in (y, y_r):
        assert torch.isfinite(got).all()
        assert float((got - y_ref).abs().max()) <= TOL[cd]
    if with_cell:
        c, acts = out[1], out[2]
        assert _rel(c, c_ref) <= REL_BWD[cd] and _rel(r[1], c_ref) <= REL_BWD[cd]
        assert _rel(acts, xg) <= REL_BWD[cd]  # the recurrence alone's acts
        past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
        assert not y[past].any() and not c[past].any() and not acts[past].any()


def test_kernel_wrapper_checks_its_inputs(dev):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    x, lens, w_x, b_x, w_hf, w_hb = _inputs(3, 19, 12, 8, dev)
    with pytest.raises(ValueError, match="contiguous"):
        K.bilstm_fused_kernel(x.transpose(0, 1).contiguous().transpose(0, 1),
                              lens, w_x, b_x, w_hf, w_hb)
    with pytest.raises(ValueError, match="int32"):
        K.bilstm_fused_kernel(x, lens.long(), w_x, b_x, w_hf, w_hb)
    with pytest.raises(ValueError, match="hidden size"):
        big = torch.zeros(1025, 4 * 1025, device=dev)
        K.bilstm_fused_kernel(x, lens, w_x, b_x, big, big)


# K1-bwd at the batch sizes of the configs (milestone 2's 16, the
# flagships' 96) and at 50 (a partial group of rows), at both hidden
# sizes of the configs, and once past 320 (bwd_recur_kernel's route):
# every output against the plain backward, which launch counter moved, and
# the recurrence alone against the plain sweep's dg. Tolerances as in
# tests/test_torch_cuda_train.py.
REL_BWD = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,H", [(16, 256), (50, 256), (96, 256), (16, 320),
                                 (50, 320), (96, 320), (6, 400)])
def test_backward_recurrence_routes_match_plain(dev, B, H, cd):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    T, D = 24, 32
    args = _inputs(B, T, D, H, dev, seed=B + H)
    x, lens, w_x, b_x, w_hf, w_hb = args
    dy = torch.from_numpy(np.random.RandomState(H).randn(B, T, 2 * H)
                          .astype(np.float32)).to(dev)
    y, c, acts = K.bilstm_fused_kernel(*args, compute_dtype=cd, with_cell=True)
    f = K.bilstm_fused_bwd_kernel
    counts = (f.launches, f.cluster_launches)
    got = f(x, lens, w_x, w_hf, w_hb, y, c, acts, dy, compute_dtype=cd)
    ref = K.bilstm_fused_bwd_plain(x, lens, w_x, b_x, w_hf, w_hb, y, c, dy,
                                   compute_dtype=cd)
    dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy, cd)
    xg = torch.cat(K._project(x, lens, w_x, b_x, cd, False), -1)
    dg_ref = K._bwd_sweep(xg, lens, w_hf, w_hb, y, c, dy, cd)
    torch.cuda.synchronize()
    cluster = H <= K.CLUSTER_MAX_HIDDEN
    assert (f.launches, f.cluster_launches) == (counts[0] + 1,
                                                counts[1] + cluster)
    for name, g, r in zip(("dx", "dw_x", "db", "dw_hf", "dw_hb"), got, ref):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= REL_BWD[cd], (name, _rel(g, r))
    assert _rel(dg, dg_ref) <= REL_BWD[cd]


# K1-bwd's products through their own entry (bf16 on wgmma; f32 on the
# FMA units) against their plain twin on the reverse recurrence's dg, at
# tools/k1b_probe.py's shapes (the flagship's three layers at the 4.0 s
# bucket, milestone 2's first) and ragged ones: B=1 and T=1, every length
# 1, widths that need the wrapper's padding (D % 4, H % 4), T past a
# multiple of 64. Both sides round the operands the same way and sum in
# f32, so only the order of the sums differs: 1e-4 of each output's
# largest magnitude, chip_smoke.py's TOL_PRODUCTS.
PRODUCTS_SHAPES = [(96, 398, 80, 320, False), (96, 199, 1280, 320, False),
                   (96, 100, 1280, 320, False), (16, 398, 80, 256, False),
                   (1, 1, 80, 256, False), (8, 150, 1280, 256, True),
                   (5, 37, 33, 130, False), (3, 65, 12, 8, False)]


@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,D,H,ones", PRODUCTS_SHAPES)
def test_products_kernel_matches_plain_twin(dev, B, T, D, H, ones, cd):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    x, lens, w_x, b_x, w_hf, w_hb = _inputs(B, T, D, H, dev, seed=B + T)
    if ones:
        lens = torch.ones_like(lens)
    dy = torch.from_numpy(np.random.RandomState(T).randn(B, T, 2 * H)
                          .astype(np.float32)).to(dev)
    y, c, acts = K.bilstm_fused_kernel(x, lens, w_x, b_x, w_hf, w_hb, cd,
                                       with_cell=True)
    dg = K.bilstm_fused_bwd_recur_kernel(lens, w_hf, w_hb, c, acts, dy, cd)
    n = K.bilstm_fused_bwd_products_kernel.launches
    got = K.bilstm_fused_bwd_products_kernel(x, lens, w_x, y, dg, cd)
    ref = K.bilstm_fused_bwd_products_plain(x, lens, w_x, y, dg, cd)
    torch.cuda.synchronize()
    assert K.bilstm_fused_bwd_products_kernel.launches == n + 1
    for name, g, r in zip(("dx", "dw_x", "db", "dw_hf", "dw_hb"), got, ref):
        assert torch.isfinite(g).all(), name
        assert _rel(g, r) <= 1e-4, (name, _rel(g, r))
    past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
    assert not got[0][past].any()


# K1-fwd's projection through its own entry (bf16 on wgmma; f32 on the
# FMA units) against its plain twin, at chip_smoke.py's shapes (the
# flagship's three layers at the 4.0 s bucket) and ragged ones: B=1 and
# T=1, every length 1, D=33 with H=130 (x's rows padded, 8H not a multiple
# of the tile), H=256, and tiny widths. Both sides round the operands the
# same way and sum in f32: 1e-4 of the output's largest magnitude
# (chip_smoke.py's TOL_PROJ); with round_xg each element may also differ
# by one bf16 ulp of itself (2^-7 relative, an upper bound).
PROJ_SHAPES = [(96, 398, 80, 320, False), (96, 199, 1280, 320, False),
               (96, 100, 1280, 320, False), (1, 1, 80, 320, False),
               (8, 150, 1280, 320, True), (5, 37, 33, 130, False),
               (16, 199, 512, 256, False), (3, 19, 12, 8, False)]


@pytest.mark.parametrize("round_xg", [False, True])
@pytest.mark.parametrize("cd", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B,T,D,H,ones", PROJ_SHAPES)
def test_projection_kernel_matches_plain_twin(dev, B, T, D, H, ones, cd,
                                              round_xg):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    x, lens, w_x, b_x, _, _ = _inputs(B, T, D, H, dev, seed=B + T + D)
    if ones:
        lens = torch.ones_like(lens)
    n = K.bilstm_fused_proj_kernel.launches
    got = K.bilstm_fused_proj_kernel(x, lens, w_x, b_x, cd, round_xg)
    ref = K.bilstm_fused_proj_plain(x, lens, w_x, b_x, cd, round_xg)
    torch.cuda.synchronize()
    assert K.bilstm_fused_proj_kernel.launches == n + (cd == torch.bfloat16)
    assert torch.isfinite(got).all()
    ulp = 2.0 ** -7 * ref.abs() if round_xg and cd == torch.bfloat16 else 0.0
    assert ((got - ref).abs() <= 1e-4 * ref.abs().max() + ulp).all(), \
        float((got - ref).abs().max())
    past = torch.arange(T, device=dev)[None, :] >= lens[:, None]
    assert not got[..., 4 * H:][past].any()


def test_projection_kernel_wrapper_checks_its_inputs(dev):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    x, lens, w_x, b_x, _, _ = _inputs(3, 5, 4, 8, dev)
    with pytest.raises(ValueError, match="w_x must have shape"):
        K.bilstm_fused_proj_kernel(x, lens, w_x[:2], b_x, torch.bfloat16)
    with pytest.raises(ValueError, match="b_x must be"):
        K.bilstm_fused_proj_kernel(x, lens, w_x, b_x.double(), torch.bfloat16)
    with pytest.raises(ValueError, match="compute_dtype"):
        K.bilstm_fused_proj_kernel(x, lens, w_x, b_x, torch.float16)


def test_bf16_k1_fwd_goes_through_the_wgmma_projection(dev):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args = _inputs(4, 30, 20, 16, dev)
    n = K.bilstm_fused_proj_kernel.launches
    K.bilstm_fused_kernel(*args, compute_dtype=torch.bfloat16)
    K.bilstm_fused_kernel(*args, compute_dtype=torch.bfloat16, with_cell=True)
    K.bilstm_fused_kernel(*args, compute_dtype=torch.float32)
    assert K.bilstm_fused_proj_kernel.launches == n + 2


def test_encoder_on_card_matches_cpu(dev):
    from gluon_e2e_asr_tpu_torch.config import ModelConfig
    from gluon_e2e_asr_tpu_torch.models.asr import ASRModel
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    cfg = ModelConfig(enc_hidden=32, enc_layers=3, enc_subsample=(1, 2, 2),
                      lstm_impl="pallas", compute_dtype="float32")
    model = ASRModel(cfg, 12, 20)
    model.encoder.reset_parameters(torch.Generator().manual_seed(0))
    feats = torch.randn(4, 41, 20, generator=torch.Generator().manual_seed(1))
    lens = torch.tensor([41, 30, 7, 1], dtype=torch.int32)
    launches = K.bilstm_fused_kernel.launches
    with torch.inference_mode():
        ref = model.encode(feats, lens)
        got = model.to(dev).encode(feats.to(dev), lens.to(dev))
    assert K.bilstm_fused_kernel.launches == launches + 3
    for r, g in zip(ref, got):
        assert float((g.cpu().float() - r.float()).abs().max()) <= 1e-5


# K7: the v1 layer over given projections (bilstm_pallas). Forward h and
# c streams and every cotangent against the plain versions, which
# recompute the gates from the rounded streams where the kernels reuse the
# forward's activations; tolerance of each output's largest magnitude as
# in tests/test_torch_cuda_train.py (bf16: a rounding can flip).
REL_V1 = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _v1_inputs(B, T, H, dev, dtype, seed=0):
    rng = np.random.RandomState(seed)
    lens = rng.randint(0, T + 1, size=B).astype(np.int32)
    lens[0] = T
    arrays = ((rng.randn(B, T, 4 * H) * 0.5).astype(np.float32),
              (rng.randn(B, T, 4 * H) * 0.5).astype(np.float32), lens,
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32),
              (rng.randn(H, 4 * H) / np.sqrt(H)).astype(np.float32))
    xg_f, xg_b, lens, w_hf, w_hb = (torch.from_numpy(a).to(dev) for a in arrays)
    dy = torch.from_numpy(rng.randn(B, T, 2 * H).astype(np.float32)).to(dev)
    return (xg_f.to(dtype), xg_b.to(dtype), lens, w_hf, w_hb), dy.to(dtype)


def _rel(a, b):
    return float((a.float() - b.float()).abs().max()
                 / b.float().abs().max().clamp(min=1e-30))


@pytest.mark.parametrize("cd", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(3, 19, 8), (5, 37, 40), (9, 50, 130)])
def test_v1_kernels_match_plain(dev, shape, cd):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    args, dy = _v1_inputs(*shape, dev, cd)
    y, c, acts = K.bilstm_pallas_kernel(*args, compute_dtype=cd, with_cell=True)
    yp, cp = K.bilstm_pallas_plain(*args, compute_dtype=cd, with_cell=True)
    got = K.bilstm_pallas_bwd_kernel(args[2], args[3], args[4], y, c, acts, dy,
                                     cd, cd)
    ref = K.bilstm_pallas_bwd_plain(*args, yp, cp, dy, cd)
    torch.cuda.synchronize()
    assert _rel(y, yp) <= REL_V1[cd] and _rel(c, cp) <= REL_V1[cd]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.isfinite(g).all()
        assert _rel(g, r) <= REL_V1[cd]
    # the autograd path launches both kernels once
    leaves = [t.detach().requires_grad_(True) for t in
              (args[0], args[1], args[3], args[4])]
    n_f, n_b = K.bilstm_pallas_kernel.launches, K.bilstm_pallas_bwd_kernel.launches
    n_c = K.bilstm_pallas_bwd_kernel.cluster_launches
    n_fc = K.bilstm_pallas_kernel.cluster_launches
    out = K.bilstm_pallas(leaves[0], leaves[1], args[2], leaves[2], leaves[3], cd)
    out.backward(dy)
    assert out.dtype == cd
    assert (K.bilstm_pallas_kernel.launches, K.bilstm_pallas_bwd_kernel.launches) \
        == (n_f + 1, n_b + 1)
    assert K.bilstm_pallas_bwd_kernel.cluster_launches == n_c + 1  # H <= 320
    assert K.bilstm_pallas_kernel.cluster_launches == n_fc + 1
    for leaf, r in zip(leaves, (ref[0], ref[1], ref[2], ref[3])):
        assert _rel(leaf.grad, r) <= REL_V1[cd]


@pytest.mark.parametrize("shape", [(3, 19, 8), (5, 37, 40), (9, 50, 130)])
def test_v1_bf16_projections_f32_compute_match_plain(dev, shape):
    """bf16 projections with an f32 compute dtype: the backward recomputes
    the gates from the rounded h stream (bilstm_v1_gates), as the plain
    version and the TPU kernel do; bf16 tolerances (the streams are
    bf16)."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    f32 = torch.float32
    args, dy = _v1_inputs(*shape, dev, torch.bfloat16)
    y, c, acts = K.bilstm_pallas_kernel(*args, compute_dtype=f32, with_cell=True)
    yp, cp = K.bilstm_pallas_plain(*args, compute_dtype=f32, with_cell=True)
    n_g = K.bilstm_pallas_bwd_kernel.gate_launches
    got = K.bilstm_pallas_bwd_kernel(args[2], args[3], args[4], y, c, acts, dy,
                                     f32, torch.bfloat16, args[:2])
    ref = K.bilstm_pallas_bwd_plain(*args, yp, cp, dy, f32)
    torch.cuda.synchronize()
    assert K.bilstm_pallas_bwd_kernel.gate_launches == n_g + 1
    tol = REL_V1[torch.bfloat16]
    assert _rel(y, yp) <= tol and _rel(c, cp) <= tol
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.isfinite(g).all()
        assert _rel(g, r) <= tol
    with pytest.raises(ValueError, match="xg="):
        K.bilstm_pallas_bwd_kernel(args[2], args[3], args[4], y, c, acts, dy,
                                   f32, torch.bfloat16)
    # the autograd path recomputes too
    leaves = [t.detach().requires_grad_(True) for t in
              (args[0], args[1], args[3], args[4])]
    out = K.bilstm_pallas(leaves[0], leaves[1], args[2], leaves[2], leaves[3],
                          f32)
    out.backward(dy)
    assert out.dtype == torch.bfloat16
    assert K.bilstm_pallas_bwd_kernel.gate_launches == n_g + 2
    for leaf, r in zip(leaves, ref):
        assert _rel(leaf.grad, r) <= tol


@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_cluster_plan_takes_the_fewest_rows_that_fit(dev, direction):
    """K1's cluster plan as its launches ask for it: the fewest of 16, 32
    and 48 rows a cluster whose 2 * ceil(B / R) clusters the card holds at
    once (else 48, in waves)."""
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    for B in (1, 16, 50, 96, 148):
        for cd in (torch.float32, torch.bfloat16):
            plan = K.cluster_plan(direction, B, 320, cd, dev)
            R, cap = plan["rows_per_cluster"], plan["capacity"]
            assert R in (16, 32, 48) and cap >= 1
            assert plan["clusters"] == 2 * -(-B // R)
            assert plan["ctas"] == 16 * plan["clusters"]
            assert plan["waves"] == -(-plan["clusters"] // cap)
            # fewer than 48 rows only where those clusters fit in one wave
            assert R == 48 or plan["waves"] == 1
        assert K.cluster_plan(direction, 1, 320, cd, dev)[
            "rows_per_cluster"] == 16


def test_v1_kernel_refuses_what_it_cannot_take(dev):
    from gluon_e2e_asr_tpu_torch.ops import bilstm as K

    (xg_f, xg_b, lens, w_hf, w_hb), _ = _v1_inputs(3, 19, 8, dev, torch.bfloat16)
    calls = K.bilstm_pallas_plain.calls
    with pytest.raises(ValueError, match="compute_dtype must be"):
        K.bilstm_pallas(xg_f, xg_b, lens, w_hf, w_hb, torch.float16)
    with pytest.raises(ValueError, match="int32"):
        K.bilstm_pallas(xg_f, xg_b, lens.long(), w_hf, w_hb, torch.bfloat16)
    with pytest.raises(ValueError, match="hidden size"):
        big = torch.zeros(3, 19, 4 * 1025, device=dev)
        w = torch.zeros(1025, 4 * 1025, device=dev)
        K.bilstm_pallas(big, big, lens, w, w)
    assert K.bilstm_pallas_plain.calls == calls
