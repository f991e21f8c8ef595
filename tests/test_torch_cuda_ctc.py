"""PyTorch port on the card: K2 and K3 (``csrc/ctc.cu``, the warp design)
against their plain versions, their launch counters, their plan mirror,
the kernels a call launches (its warp kernel alone) and their refusals.

Shapes: the flagship's 4.0 s bucket (T=100, B=96, S=161) and bench.py's
(T=320, B=96, S=193): 3 and 4 warps a row, two states a lane; B=1; T=1;
S = 641 and 1024 (11 and 16 warps a row); small odd lattices, S=1 and
S=3 on one warp. Every
lattice of ``tools/ctc_probe.py::lattice`` with B >= 4 holds a row of
length 0, an infeasible row and a time mask that is not a prefix.

Tolerances: ``chip_smoke.py``'s TOL_ALPHA_REL and TOL_POST (1e-5): the
same f32 formulas with exact expf/logf on the card and torch's exp/log in
the plain version, only the last bits of the roundings can differ; alpha
relative to max(|plain|, 1) on live cells, dead cells (at most -1e29)
dead in both; post absolute (it lies in [0, 1]).

Marked ``cuda``: these skip where there is no CUDA device. On a machine
with the card and nvcc, run them with
``python -m pytest --noconftest -m cuda tests/test_torch_cuda_ctc.py``.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda

TOL_ALPHA_REL, TOL_POST = 1e-5, 1e-5
SHAPES = [(100, 96, 161), (320, 96, 193), (100, 1, 161), (1, 96, 161),
          (1, 1, 1), (37, 9, 641), (23, 5, 1024), (13, 7, 3), (29, 6, 65)]


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _check(dev, T, B, S, seed=0):
    from gluon_e2e_asr_tpu_torch.ops import ctc as C
    from gluon_e2e_asr_tpu_torch.tools.ctc_probe import lattice

    emit, tmask, skip, svalid, last = lattice(T, B, S, seed, dev)
    counts = (C.ctc_alpha_kernel.launches, C.ctc_beta_post_kernel.launches)
    alpha = C.ctc_alpha_kernel(emit, tmask, skip, svalid)
    alpha_p = C._alpha_plain(emit, tmask, skip, svalid)
    ll = C._log_likelihood(alpha_p, last // 2)
    post = C.ctc_beta_post_kernel(emit, tmask, skip, svalid, last, alpha_p, ll)
    post_p = C._beta_post_plain(emit, tmask, skip, svalid, last, alpha_p, ll)
    torch.cuda.synchronize()
    assert (C.ctc_alpha_kernel.launches, C.ctc_beta_post_kernel.launches) \
        == tuple(c + 1 for c in counts)
    live = alpha_p > -1e29
    assert bool((alpha[~live] <= -1e29).all())
    rel = ((alpha - alpha_p).abs() / alpha_p.abs().clamp(min=1.0))[live]
    assert rel.numel() == 0 or float(rel.max()) <= TOL_ALPHA_REL
    assert bool(torch.isfinite(post).all())
    assert float((post - post_p).abs().max()) <= TOL_POST
    assert bool((post[post_p == 0] == 0).all())


@pytest.mark.parametrize("T,B,S", SHAPES)
def test_kernels_match_plain(dev, T, B, S):
    _check(dev, T, B, S)


def test_plan_mirror_matches_the_library(dev):
    import ctypes

    from gluon_e2e_asr_tpu_torch.ops import ctc as C

    lib = C._lib()
    out = (ctypes.c_int * 3)()
    rng = np.random.RandomState(0)
    for _ in range(500):
        T, S = int(rng.randint(1, 3000)), int(rng.randint(1, C.MAX_STATES + 1))
        assert lib.ctc_plan(T, S, out) == 0
        assert tuple(out) == C.warp_plan(T, S)


def test_one_launch_a_call_and_nothing_else(dev):
    """A profiler trace of five calls of each wrapper: its kernel alone,
    once a call, no copy, compare or reduction beside it."""
    from gluon_e2e_asr_tpu_torch.ops import ctc as C
    from gluon_e2e_asr_tpu_torch.tools.ctc_probe import lattice, one_call

    emit, tmask, skip, svalid, last = lattice(100, 96, 161, 0, dev)
    alpha = C.ctc_alpha_kernel(emit, tmask, skip, svalid)
    ll = C._log_likelihood(alpha, last // 2)
    a = one_call(lambda: C.ctc_alpha_kernel(emit, tmask, skip, svalid))
    b = one_call(lambda: C.ctc_beta_post_kernel(emit, tmask, skip, svalid,
                                                last, alpha, ll))
    assert len(a) == 1 and "ctc_alpha_warp_kernel" in a[0][0], a
    assert len(b) == 1 and "ctc_beta_post_warp_kernel" in b[0][0], b
    assert a[0][1] == b[0][1] == 5  # one launch a call


def test_refusals(dev, monkeypatch):
    from gluon_e2e_asr_tpu_torch.ops import ctc as C
    from gluon_e2e_asr_tpu_torch.tools.ctc_probe import lattice

    emit, tmask, skip, svalid, last = lattice(5, 3, 1025, 0, dev)
    with pytest.raises(ValueError, match="exceed"):
        C.ctc_alpha_kernel(emit, tmask, skip, svalid)
    with pytest.raises(ValueError, match="exceed"):
        C.ctc_beta_post_kernel(emit, tmask, skip, svalid, last, emit,
                               emit[0, :, 0])
    emit, tmask, skip, svalid, last = lattice(5, 3, 161, 0, dev)
    with pytest.raises(ValueError, match="CUDA"):
        C.ctc_alpha_kernel(emit.cpu(), tmask.cpu(), skip.cpu(), svalid.cpu())
    with pytest.raises(ValueError, match="bool or uint8"):
        C.ctc_alpha_kernel(emit, tmask.float(), skip, svalid)
    # a plan the library does not share: it launches nothing
    n = C.ctc_alpha_kernel.launches
    monkeypatch.setattr(C, "KMAX", 8)
    with pytest.raises(RuntimeError, match="differ from ctc_warp_plan"):
        C.ctc_alpha_kernel(emit, tmask, skip, svalid)
    assert C.ctc_alpha_kernel.launches == n
