"""PyTorch port, K2/K3's warp design (``csrc/ctc.cu``) on the CPU: a torch
emulation of the kernels' decomposition held to the plain versions and to
the JAX kernels.

The emulation does what each lane of ``ctc_alpha_warp_kernel`` and
``ctc_beta_post_warp_kernel`` does, for all lanes at once: k contiguous
lattice states a lane in a [B, W, 32, k] tensor; the shuffles as shifts
along the lane axis, with the lanes a shuffle cannot reach keeping their
own value and then taking the neighbouring warp's boundary pair (or
NEG_INF at the row's ends); each warp's two boundary states exchanged as
the kernel does it, through a [2][W][2] buffer: pair q (the states after
step q-1, q = 0 the initial ones) written into the slot of q's parity
before the row's barrier and read at step q (a slot no warp wrote holds
NaN); the prefetch ring as the kernel runs it (``_Ring``: DEPTH + 1
slots, step t's row copied into slot t % (DEPTH + 1), DEPTH steps in
flight, a wait for all but DEPTH - 1 of them before step t reads its
slot, and the next copy into the slot step t-1 read); and the masks the
kernel derives from its own inputs (skipf2, finalok, is_last from the
staged time-mask column's count). ``test_emulation_copies_the_source``
holds those indices to the source's lines. It runs at k in {1, 2, 6, 8},
W in {1, 2, 4} and S in {1, 3, 5, 161, 193, 641, 1024} (each (k, W)
whose 32 W k lanes' states cover S), on lattices with a row of length 0,
an infeasible row and a time mask that is not a prefix.

Tolerances: against ``_alpha_plain`` and ``_beta_post_plain`` the same
torch operations on the same values in the same order: dead cells
(alpha at most -1e29, post 0) exactly equal, live cells within 1e-6 of
max(|plain|, 1) (torch's vectorised and scalar exp and log may round a
last bit apart). Against ``alpha_pallas`` and ``beta_post_pallas`` in
interpret mode: ``tests/test_torch_ctc.py``'s 1e-6, alpha on the rows
whose first frame is live (the TPU kernel's state starts uninitialised),
at every S but 1 (a lattice of one state: the TPU kernels' shift of the
state row by two lanes does not trace at a width of 1).

Also: the plan mirror ``warp_plan`` against a copy of the C rule, the
in-kernel masks against ``_beta_inputs``, and the wrappers' argument
builders, which pass bool masks as uint8 views of the same storage.
"""

import functools
import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from gluon_e2e_asr_tpu.ops import pallas_ctc
from gluon_e2e_asr_tpu_torch.ops import ctc as C
from gluon_e2e_asr_tpu_torch.tools.ctc_probe import lattice

torch.set_num_threads(1)

NEG = C.NEG_INF
LANES = 32
DEPTH = C.DEPTH  # csrc/ctc.cu's CTC_DEPTH
B_CASE = 5


def _steps(S):
    """Enough steps for the recursions to reach every state (alpha's
    live states at step t lie below 2t + 2; beta's the same from the
    end), so that every lane and warp boundary carries live values; at
    least 9: two full rings and a tail."""
    return max(9, S // 2 + 7)


SIZES = (1, 3, 5, 161, 193, 641, 1024)
CASES = [(S, k, W) for S in SIZES for k in (1, 2, 6, 8) for W in (1, 2, 4)
         if LANES * W * k >= S]
# one state a lane across warps (the lane two below a warp's first state
# is the warp below's last): no plan of the shipped build has it
CASES += [(65, 1, 4), (161, 1, 6)]
CU = os.path.join(os.path.dirname(C.__file__), "..", "csrc", "ctc.cu")


def _shfl_up(x, n):
    """__shfl_up_sync over the lane axis: lane l takes lane l-n's value,
    the lanes below n keep their own."""
    return torch.cat([x[..., :n], x[..., :-n]], -1)


def _shfl_down(x, n):
    return torch.cat([x[..., n:], x[..., -n:]], -1)


def _lanes(x, k, W, fill):
    """[B, S] -> [B, W, 32, k]: lane l of warp w holds states
    (32 w + l) k .. +k-1, padded past S with ``fill``."""
    B, S = x.shape
    return F.pad(x, (0, LANES * W * k - S), value=fill).reshape(B, W, LANES, k)


def kernel_masks(time_mask, allow_skip, last_state):
    """skipf2, finalok [B,S] and is_last [T,B] as the K3 kernel derives
    them: allow_skip two states on (0 past the row), s in {last-1, last},
    and t == (the count of the row's staged time-mask column) - 1."""
    T = time_mask.shape[0]
    S = allow_skip.shape[1]
    s = torch.arange(S)
    skipf2 = (s + 2 < S) & allow_skip[:, (s + 2).clamp(max=S - 1)]
    last = last_state.long()[:, None]
    finalok = (s == last) | (s == last - 1)
    count = time_mask.to(torch.int32).sum(0)
    return skipf2, finalok, torch.arange(T)[:, None] == (count - 1)[None, :]


class _Ring:
    """A table's prefetch ring as the kernel runs it: ``slots`` slots
    (the kernel's kRing = CTC_DEPTH + 1); ``fetch(t, now)`` at step
    ``now`` commits a group that copies step t's row (``row(t)``) into
    slot t % slots (an empty group past the table's T steps); ``wait(n)``
    lands the oldest groups until at most n are in flight
    (cp.async.wait_group); ``read(t)`` reads step t's slot. A copy may
    only fill a slot whose last row was read at an earlier step, and a
    step must find its own row landed in its slot."""

    def __init__(self, row, T, slots):
        self.row, self.T, self.slots = row, T, slots
        self.held = [None] * slots  # (step, row) landed in each slot
        self.read_at = [None] * slots  # the step that read each slot last
        self.flight = []

    def fetch(self, t, now):
        if t >= self.T:
            self.flight.append(None)
            return
        i = t % self.slots
        pending = [g for g in self.flight if g is not None and g[1] == i]
        assert not pending, f"step {t}'s copy joins one in flight in slot {i}"
        if self.held[i] is not None:
            assert self.read_at[i] == self.held[i][0] and self.read_at[i] < now, \
                f"step {t}'s copy at step {now} overwrites slot {i}, last " \
                f"read at {self.read_at[i]}"
        self.flight.append((t, i))

    def wait(self, n):
        while len(self.flight) > n:
            g = self.flight.pop(0)
            if g is not None:
                self.held[g[1]] = (g[0], self.row(g[0]))

    def read(self, t):
        i = t % self.slots
        assert self.held[i] is not None and self.held[i][0] == t, \
            f"step {t} reads slot {i} before its row landed"
        self.read_at[i] = t
        return self.held[i][1]


def _prefetch(rings, depth):
    """The kernel's prologue: steps 0 .. depth-1 in flight."""
    for j in range(depth):
        for r in rings:
            r.fetch(j, -1)


def _step_rows(rings, t, depth):
    """Step t's rows: wait_fetches<DEPTH - 1>, read its slot, then copy
    step t + depth's row into the slot step t-1 read."""
    out = []
    for r in rings:
        r.wait(depth - 1)
        out.append(r.read(t))
    for r in rings:
        r.fetch(t + depth, t)
    return out


def emulate_alpha(emit, time_mask, allow_skip, state_valid, k, W,
                  depth=DEPTH):
    T, B, S = emit.shape
    P = LANES * W * k
    s = torch.arange(P).reshape(W, LANES, k)
    sk = _lanes(allow_skip, k, W, False)
    sv = _lanes(state_valid, k, W, False)
    st = torch.where(s == 0, 0.0, NEG).to(emit.dtype).expand(B, W, LANES, k)

    # [B][parity][W][2]: warp w's last two states, written by the warps
    # below the row's last
    xch = torch.full((B, 2, W, 2), float("nan"), dtype=emit.dtype)

    def give(q):
        xch[:, q & 1, :-1] = st.reshape(B, W, LANES * k)[:, :-1, -2:]

    ring = _Ring(lambda t: _lanes(emit[t], k, W, 0.0), T, depth + 1)
    _prefetch([ring], depth)
    give(0)
    out = torch.empty_like(emit)
    for t in range(T):
        (e,) = _step_rows([ring], t, depth)
        m1 = _shfl_up(st[..., k - 1], 1)
        m2 = _shfl_up(st[..., k - 2], 1) if k >= 2 else _shfl_up(st[..., 0], 2)
        below = torch.full((B, W, 2), NEG, dtype=emit.dtype)
        below[:, 1:] = xch[:, t & 1, :-1]
        m1[..., 0], m2[..., 0] = below[..., 1], below[..., 0]
        if k == 1:
            m2[..., 1] = below[..., 1]
        a1 = torch.cat([m1[..., None], st[..., :-1]], -1)
        a2 = torch.cat([m2[..., None], m1[..., None], st[..., :-2]], -1)[..., :k]
        a2 = torch.where(sk, a2, NEG)
        if t == 0:
            new = torch.where((s <= 1) & sv, e, NEG)
        else:
            new = torch.where(sv, C._logsumexp3(st, a1, a2) + e, NEG)
        st = torch.where(time_mask[t].view(B, 1, 1, 1), new, st)
        out[t] = st.reshape(B, P)[:, :S]
        if W > 1:
            give(t + 1)
    return out


def emulate_beta_post(emit, time_mask, allow_skip, state_valid, last_state,
                      alpha, ll, k, W, depth=DEPTH):
    T, B, S = emit.shape
    skipf2, finalok, is_last = kernel_masks(time_mask, allow_skip, last_state)
    sk = _lanes(skipf2, k, W, False)
    sv = _lanes(state_valid, k, W, False)
    fok = _lanes(finalok, k, W, False)
    st = torch.full((B, W, LANES, k), NEG, dtype=emit.dtype)

    # warp w's first two states, written by the warps above the row's first
    xch = torch.full((B, 2, W, 2), float("nan"), dtype=emit.dtype)

    def give(q):
        xch[:, q & 1, 1:] = st.reshape(B, W, LANES * k)[:, 1:, :2]

    # step kk computes frame T-1-kk
    rings = [_Ring(lambda kk, tb=tb: _lanes(tb[T - 1 - kk], k, W, 0.0), T,
                   depth + 1) for tb in (emit, alpha)]
    _prefetch(rings, depth)
    give(0)
    llb = ll.view(B, 1, 1, 1)
    post = torch.empty_like(emit)
    for kk in range(T):
        t = T - 1 - kk
        e, al = _step_rows(rings, kk, depth)
        p1 = _shfl_down(st[..., 0], 1)
        p2 = _shfl_down(st[..., 1], 1) if k >= 2 else _shfl_down(st[..., 0], 2)
        above = torch.full((B, W, 2), NEG, dtype=emit.dtype)
        above[:, :-1] = xch[:, kk & 1, 1:]
        p1[..., -1], p2[..., -1] = above[..., 0], above[..., 1]
        if k == 1:
            p2[..., -2] = above[..., 0]
        b1 = torch.cat([st[..., 1:], p1[..., None]], -1)
        b2 = torch.cat([st[..., 2:], p1[..., None], p2[..., None]], -1)[..., -k:]
        b2 = torch.where(sk, b2, NEG)
        new = e + C._logsumexp3(st, b1, b2)
        new = torch.where(is_last[t].view(B, 1, 1, 1),
                          torch.where(fok, e, NEG), new)
        new = torch.where(sv, new, NEG)
        live = time_mask[t].view(B, 1, 1, 1)
        st = torch.where(live, new, st)
        gamma = al + st - e
        p = torch.exp(torch.clamp(gamma - llb, 2 * NEG, 0.0))
        post[t] = torch.where(sv & live, p, 0.0).reshape(B, -1)[:, :S]
        if W > 1:
            give(kk + 1)
    return post


def _hold_to_plain(got, ref, dead):
    """Dead cells exactly, live ones within 1e-6 of max(|ref|, 1)."""
    assert torch.equal(got[dead], ref[dead])
    err = ((got - ref).abs() / ref.abs().clamp(min=1.0))[~dead]
    assert err.numel() == 0 or float(err.max()) <= 1e-6, float(err.max())


@functools.lru_cache(maxsize=None)
def _case(S, T=None):
    T = _steps(S) if T is None else T
    emit, tmask, skip, svalid, last = lattice(T, B_CASE, S, seed=S)
    alpha = C._alpha_plain(emit, tmask, skip, svalid)
    ll = C._log_likelihood(alpha, last // 2)
    post = C._beta_post_plain(emit, tmask, skip, svalid, last, alpha, ll)
    return emit, tmask, skip, svalid, last, alpha, ll, post


@functools.lru_cache(maxsize=None)
def _jax(S):
    emit, tmask, skip, svalid, last, alpha, ll, _ = _case(S)
    j = lambda *ts: [jnp.asarray(t.numpy()) for t in ts]  # noqa: E731
    a = np.asarray(pallas_ctc.alpha_pallas(*j(emit, tmask, skip, svalid)))
    p = np.asarray(pallas_ctc.beta_post_pallas(
        *j(emit, tmask, skip, svalid, last, alpha, ll)))
    return a, p


def test_lattices_hold_the_hard_rows():
    emit, tmask, skip, svalid, last, alpha, ll, _ = _case(161)
    assert not tmask[:, 1].any()  # a row of length 0
    assert int(tmask[:, 2].sum()) < int(last[2]) // 2  # fewer frames than labels
    col = tmask[:, 3]
    assert col[0] and not col.all() and col[-1]  # a hole, not a prefix


@pytest.mark.parametrize("S,k,W", CASES)
def test_emulated_alpha_matches_plain_and_jax(S, k, W):
    emit, tmask, skip, svalid, _, alpha, _, _ = _case(S)
    got = emulate_alpha(emit, tmask, skip, svalid, k, W)
    _hold_to_plain(got, alpha, alpha <= -1e29)
    if S >= 3:  # the TPU kernel's lane shift by 2 needs 2 states to shift
        rows = tmask[0].numpy()
        np.testing.assert_allclose(got.numpy()[:, rows], _jax(S)[0][:, rows],
                                   rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,k,W", CASES)
def test_emulated_beta_post_matches_plain_and_jax(S, k, W):
    emit, tmask, skip, svalid, last, alpha, ll, post = _case(S)
    got = emulate_beta_post(emit, tmask, skip, svalid, last, alpha, ll, k, W)
    _hold_to_plain(got, post, post == 0)
    if S >= 3:
        np.testing.assert_allclose(got.numpy(), _jax(S)[1], rtol=0, atol=1e-6)


@pytest.mark.parametrize("T", [1, 2, 3, 4, 5, 8])
@pytest.mark.parametrize("k,W", [(6, 1), (2, 4)])
def test_ring_covers_short_and_ragged_time(T, k, W):
    """Fewer steps than the ring's slots, a ring exactly full, tails."""
    emit, tmask, skip, svalid, last, alpha, ll, post = _case(161, T)
    _hold_to_plain(emulate_alpha(emit, tmask, skip, svalid, k, W), alpha,
                   alpha <= -1e29)
    got = emulate_beta_post(emit, tmask, skip, svalid, last, alpha, ll, k, W)
    _hold_to_plain(got, post, post == 0)


@pytest.mark.parametrize("S,k,W", [(5, 1, 1), (65, 1, 4), (161, 1, 6),
                                   (161, 6, 1), (193, 2, 4), (641, 6, 4)])
def test_emulation_on_masks_no_lattice_has(S, k, W):
    """allow_skip drawn at random (a lattice never lets a blank skip, so
    its blanks hide a wrong neighbour two states on): the kernels take any
    mask."""
    emit, tmask, _, svalid, last, *_ = _case(S)
    skip = torch.from_numpy(np.random.RandomState(S).rand(B_CASE, S) < 0.5)
    alpha = C._alpha_plain(emit, tmask, skip, svalid)
    _hold_to_plain(emulate_alpha(emit, tmask, skip, svalid, k, W), alpha,
                   alpha <= -1e29)
    ll = C._log_likelihood(alpha, last // 2)
    post = C._beta_post_plain(emit, tmask, skip, svalid, last, alpha, ll)
    got = emulate_beta_post(emit, tmask, skip, svalid, last, alpha, ll, k, W)
    _hold_to_plain(got, post, post == 0)


@pytest.mark.parametrize("S", SIZES)
@pytest.mark.parametrize("T", [1, 6, 9])
def test_kernel_masks_match_beta_inputs(S, T):
    emit, tmask, skip, svalid, last = lattice(T, B_CASE, S, seed=S + T)
    rng = np.random.RandomState(S + T)
    for skip_ in (skip, torch.from_numpy(rng.rand(B_CASE, S) < 0.5)):
        for got, want in zip(kernel_masks(tmask, skip_, last),
                             C._beta_inputs(tmask, skip_, last)):
            assert torch.equal(got, want)


def _define(name):
    with open(CU) as f:
        return int(re.search(rf"^#define {name} (\d+)$", f.read(), re.M)[1])


# csrc/ctc.cu's ctc_warp_plan, as the C source has it ...
C_RULE = """constexpr int kRing = CTC_DEPTH + 1;  // slots of the prefetch ring

__host__ __device__ inline size_t ring_at(int W) { return 16 * (size_t)W; }

__host__ __device__ inline size_t tmask_at(int W, int k) {
  return ring_at(W) + 2 * kRing * 128 * (size_t)W * k;
}

Plan ctc_warp_plan(int T, int S) {
  Plan p;
  p.W = cdiv(S, 32 * CTC_KMAX);
  p.k = cdiv(S, 32 * p.W);
  p.smem = tmask_at(p.W, p.k) + (((size_t)T + 15) & ~(size_t)15);
  return p;
}"""


def c_rule(T, S, kmax, depth):
    """... and in Python, line for line (the boundary slots 16 W bytes,
    the ring 2 kRing 128 W k, kRing = CTC_DEPTH + 1, then T padded to
    16)."""
    cdiv = lambda a, b: (a + b - 1) // b  # noqa: E731
    W = cdiv(S, 32 * kmax)
    k = cdiv(S, 32 * W)
    return k, W, 16 * W + 2 * (depth + 1) * 128 * W * k + ((T + 15) & ~15)


def test_plan_mirror_matches_the_c_rule():
    with open(CU) as f:
        assert C_RULE in f.read()
    assert (C.KMAX, C.DEPTH) == (_define("CTC_KMAX"), _define("CTC_DEPTH"))
    rng = np.random.RandomState(0)
    shapes = [(int(rng.randint(1, 3000)), int(rng.randint(1, C.MAX_STATES + 1)))
              for _ in range(2000)]
    shapes += [(100, 161), (320, 193), (1, 1), (5, 1024)]
    for T, S in shapes:
        k, W, smem = C.warp_plan(T, S)
        assert (k, W, smem) == c_rule(T, S, C.KMAX, C.DEPTH)
        assert k <= C.KMAX and LANES * W * k >= S and W <= 32
    # two states a lane: the flagships' lattices take 3 and 4 warps a row
    assert C.warp_plan(100, 161)[:2] == (2, 3)
    assert C.warp_plan(320, 193)[:2] == (2, 4)
    assert C.warp_plan(100, 1024)[:2] == (2, 16)


def test_plan_mirror_follows_other_builds(monkeypatch):
    """A probe's build with other CTC_KMAX / CTC_DEPTH sets the mirror's
    constants to match: one warp a row, a deeper ring."""
    monkeypatch.setattr(C, "KMAX", 8)
    monkeypatch.setattr(C, "DEPTH", 8)
    assert C.warp_plan(100, 161) == c_rule(100, 161, 8, 8) \
        == (6, 1, 16 + 2 * 9 * 128 * 6 + 112)
    assert C.warp_plan(7, 1024)[:2] == (8, 4)


# The lines of csrc/ctc.cu whose indices the emulation copies: the ring's
# slots, the wait before a step reads, the slot a step reads and the copy
# it issues next (K2, then K3), and the boundary pair's slot written (q's
# parity) and read (the step's parity, the warp below or above).
SOURCE_LINES = (
    ("constexpr int kRing = CTC_DEPTH + 1;", 1),
    ("wait_fetches<CTC_DEPTH - 1>();", 2),
    ("read_slot<K>(e, l.ring + (t % kRing) * nl + l.s0, l.n);", 1),
    ("fetch(t + CTC_DEPTH);  // into the slot step t-1 read", 1),
    ("read_slot<K>(e, l.ring + (k % kRing) * nl + l.s0, l.n);", 1),
    ("read_slot<K>(al, aring + (k % kRing) * nl + l.s0, l.n);", 1),
    ("fetch(k + CTC_DEPTH);", 1),
    ("for (int j = 0; j < CTC_DEPTH; ++j) fetch(j);", 2),
    ("float* x = l.xch + ((q & 1) * W + l.w) * 2;", 2),
    ("const float* x = l.xch + ((t & 1) * W + l.w - 1) * 2;", 1),
    ("const float* x = l.xch + ((k & 1) * W + l.w + 1) * 2;", 1),
    ("give(0);", 2),
    ("give(t + 1);", 1),
    ("give(k + 1);", 1),
)


def test_emulation_copies_the_source():
    with open(CU) as f:
        src = f.read()
    for line, n in SOURCE_LINES:
        assert src.count(line) == n, line


@pytest.mark.parametrize("slots,wait,what", [
    (DEPTH + 1, DEPTH - 1, None),
    (DEPTH, DEPTH - 1, "overwrites"),  # the slot the step just read
    (DEPTH + 1, DEPTH, "before its row landed"),  # one wait too few
    (DEPTH - 1, DEPTH - 1, "joins one in flight"),
])
def test_ring_refuses_a_wrong_discipline(slots, wait, what):
    """The emulated ring would catch a kernel whose ring had a slot too
    few or whose wait let one group too many in flight."""
    T = 3 * DEPTH + 2
    ring = _Ring(lambda t: t, T, slots)

    def run():
        _prefetch([ring], DEPTH)
        for t in range(T):
            ring.wait(wait)
            assert ring.read(t) == t
            ring.fetch(t + DEPTH, t)

    if what is None:
        run()
    else:
        with pytest.raises(AssertionError, match=what):
            run()


def test_argument_builders_pass_bool_masks_as_views():
    emit, tmask, skip, svalid, last, alpha, ll, _ = _case(161)
    ops = C._beta_args(emit, tmask, skip, svalid, last, alpha, ll)
    assert [o.data_ptr() for o in ops[:4]] == [
        o.data_ptr() for o in C._alpha_args(emit, tmask, skip, svalid)]
    for got, given in zip(ops, (emit, tmask, skip, svalid, last, alpha, ll)):
        assert got.data_ptr() == given.data_ptr()  # no copy
        assert got.is_contiguous()
    assert [o.dtype for o in ops[1:4]] == [torch.uint8] * 3
    assert torch.equal(ops[2], skip.to(torch.uint8))
    assert ops[4].dtype == torch.int32
    with pytest.raises(ValueError, match="bool or uint8"):
        C._alpha_args(emit, tmask.float(), skip, svalid)
    with pytest.raises(ValueError, match="expected"):
        C._alpha_args(emit, tmask.T, skip, svalid)
    with pytest.raises(ValueError, match="do not match"):
        C._beta_args(emit, tmask, skip, svalid, last[:2], alpha, ll)
