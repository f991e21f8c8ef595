"""PyTorch port: CTC forced alignment (``ops/ctc.py::ctc_viterbi_align``
and ``spans_from_states``) against the JAX package on the CPU.

The same log-probabilities go through both: random ones, ones rounded
to a few values so that many predecessors tie (the backtrace is
tie-sensitive: ties go to stay, then advance, then skip, as
``jnp.argmax``), infeasible rows, ``label_len`` 0, ``input_len`` 0 and
repeated labels. The states must be equal and the scores within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gluon_e2e_asr_tpu.ops import ctc as JC
from gluon_e2e_asr_tpu_torch.ops import ctc as C

torch.set_num_threads(1)


def _case(seed, tied):
    rng = np.random.RandomState(seed)
    B, T, V, L = 7, 14, 6, 5
    logits = rng.randn(B, T, V).astype(np.float32)
    if tied:
        logits = np.round(logits * 0.7)  # a handful of values: many ties
    logp = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    labels = rng.randint(1, V, (B, L)).astype(np.int32)
    labels[1, 1:3] = labels[1, 0]  # repeats need a blank between them
    label_lens = np.array([5, 3, 0, 4, 5, 2, 1], np.int32)
    # row 3: feasible only in 7 frames, given 3 (infeasible); row 4: no
    # frame at all; row 6: one frame
    input_lens = np.array([14, 9, 6, 3, 0, 11, 1], np.int32)
    return logp, input_lens, labels, label_lens


def _both(logp, input_lens, labels, label_lens):
    want = JC.ctc_viterbi_align(*(jnp.asarray(a) for a in
                                  (logp, input_lens, labels, label_lens)))
    got = C.ctc_viterbi_align(*(torch.from_numpy(a) for a in
                                (logp, input_lens, labels, label_lens)))
    return [np.asarray(x) for x in want], [x.numpy() for x in got]


@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_viterbi_matches_jax(seed, tied):
    (w_states, w_score), (states, score) = _both(*_case(seed, tied))
    assert states.dtype == np.int32 and states.shape == w_states.shape
    np.testing.assert_array_equal(states, w_states)
    np.testing.assert_allclose(score, w_score, rtol=0, atol=1e-5)
    assert (states[3] == -1).all() and score[3] == C.NEG_INF  # infeasible
    assert (states[4] == -1).all() and score[4] == C.NEG_INF  # no frame
    assert (states[2, :6] == 0).all()  # label_len 0: blank throughout
    assert (states[0] >= 0).all()
    assert (states[1, 9:] == -1).all()  # frames past input_len


def test_ties_go_to_stay_then_advance_then_skip():
    """Uniform emissions: every path ties. The backtrace ends on the
    final blank (a tie with the last token) and takes "stay" wherever it
    can, so the path holds the final state from the earliest frame it can
    and the first frames advance (skipping the blank between the
    tokens); JAX takes the same path."""
    T, V = 6, 4
    logp = np.full((1, T, V), -np.log(V), np.float32)
    labels = np.array([[1, 2]], np.int32)
    args = (logp, np.array([T], np.int32), labels, np.array([2], np.int32))
    (w_states, _), (states, _) = _both(*args)
    np.testing.assert_array_equal(states, w_states)
    assert states[0].tolist() == [1, 3, 4, 4, 4, 4]


def test_spans_from_states_match_jax():
    logp, input_lens, labels, label_lens = _case(5, tied=True)
    _, (states, _) = _both(logp, input_lens, labels, label_lens)
    for row in range(len(states)):
        toks = [f"t{k}" for k in range(label_lens[row])]
        got = C.spans_from_states(states[row], toks, 0.04)
        assert got == JC.spans_from_states(states[row], toks, 0.04)
        ends = [s["end_s"] for s in got if s["start_s"] is not None]
        assert ends == sorted(ends)
    assert C.spans_from_states(np.array([0, 2, 2]), ["a"], 0.1) == [
        {"token": "a", "start_s": None, "end_s": None}]
