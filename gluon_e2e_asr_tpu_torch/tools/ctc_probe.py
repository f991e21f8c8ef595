"""K2 and K3 (``csrc/ctc.cu``) alone on one card: the warp design beside
the first design in one process.

Run from the root of a checkout on a machine with the card and nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.ctc_probe [--ablate] [--plans]
        [--only old]

At the flagship's 4.0 s bucket (T=100, B=96, S=161: 80 labels) and at
bench.py's shape (T=320, B=96, S=193: 96 labels), one JSON line for each
recursion and design: the time of a call by CUDA events (the wrapper's
host work included; median of 20 after a warm-up), the kernel's device
time (torch.profiler: its kernel alone), the host time of a call (the
wrapper returning, no synchronisation), the device operations a call launches (a
torch.profiler trace of five calls: the kernel and nothing else for the
warp design), and the largest difference between the two designs' outputs
(expected 0: the same arithmetic cell for cell). The first design is the
build variant ``CTC_WARP 0`` (one block per utterance, one thread per
state) driven through a copy of its wrapper, with its host-side mask
preparation. ``--only old`` times the first design alone.

``--ablate`` also times the warp design built with one piece cut (each
such build computes wrong results; only its time counts): the loads back
inside each step's chain (``CTC_CHAIN_LOADS 1``), and no stores
(``CTC_STORES 0``). ``--plans`` times other builds: at most 1 or 8 states
a lane (``CTC_KMAX``; 8 puts the flagships' rows on one warp) and 8 steps
in flight (``CTC_DEPTH``).

``lattice`` builds the seeded lattices the card tests and
``chip_smoke.py`` use too.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import os
import subprocess
import time

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch import _build
from gluon_e2e_asr_tpu_torch.ops import ctc as C

SHAPES = ((100, 96, 161, "4.0 s bucket"), (320, 96, 193, "bench.py"))
V = 32  # the flagships' character vocabulary
# name -> (text of csrc/ctc.cu, its replacement): the build variants
OLD_DESIGN = ("#define CTC_WARP 1", "#define CTC_WARP 0")
CUTS = {"loads in the chain": ("#define CTC_CHAIN_LOADS 0",
                               "#define CTC_CHAIN_LOADS 1"),
        "no stores": ("#define CTC_STORES 1", "#define CTC_STORES 0")}
# name -> (text, replacement, the plan mirror's constants in that build)
PLANS = {"kmax 1": ("#define CTC_KMAX 2", "#define CTC_KMAX 1", {"KMAX": 1}),
         "kmax 8": ("#define CTC_KMAX 2", "#define CTC_KMAX 8", {"KMAX": 8}),
         "depth 8": ("#define CTC_DEPTH 4", "#define CTC_DEPTH 8",
                     {"DEPTH": 8})}
KERNELS = ("ctc_alpha", "ctc_beta_post")  # both designs' kernel names


def lattice(T: int, B: int, S: int, seed: int = 0, dev="cpu"):
    """A seeded [T,B,S] lattice: (emit, time_mask, allow_skip,
    state_valid, last_state). The emissions gather log_softmax of
    random logits over a 32-symbol vocabulary; the labels draw from it
    (repeats included); label lengths lie in [L/2, L] and input lengths
    in [T/2, T], L = (S-1)//2. Row 0 is full; row 1 has no frames; row 2
    has too few frames for its labels (infeasible, where L >= 2); row 3's
    time mask is not a prefix (a hole after its first frame, where T >=
    4). An even S adds one invalid state past the lattice of S-1."""
    rng = np.random.RandomState(seed)
    L = (S - 1) // 2
    labels = rng.randint(1, V, size=(B, L)).astype(np.int32)
    label_len = rng.randint(L // 2, L + 1, size=B).astype(np.int32)
    input_len = rng.randint(max(T // 2, 1), T + 1, size=B).astype(np.int32)
    label_len[0], input_len[0] = L, T
    if B > 1:
        input_len[1] = 0
    if B > 2:
        label_len[2], input_len[2] = L, min(T, max(1, L // 2))
    if B > 3:
        input_len[3] = T
    for b in range(B):
        labels[b, label_len[b]:] = 0
    logits = torch.from_numpy((rng.randn(B, T, V) * 3).astype(np.float32))
    ext, skip, svalid, tmask = C._lattice(
        T, torch.from_numpy(input_len), torch.from_numpy(labels),
        torch.from_numpy(label_len), 0)
    if B > 3 and T >= 4:
        tmask[T // 3:T // 3 + max(1, T // 5), 3] = False
    emit = C._gather_states(torch.log_softmax(logits, -1), ext)
    if S % 2 == 0:
        emit = torch.nn.functional.pad(emit, (0, 1), value=-5.0)
        skip = torch.nn.functional.pad(skip, (0, 1))
        svalid = torch.nn.functional.pad(svalid, (0, 1))
    last = torch.from_numpy(2 * label_len)
    return tuple(t.to(dev) for t in (emit, tmask, skip, svalid, last))


def _u8(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.uint8).contiguous()


def old_alpha(lib, emit, time_mask, allow_skip, state_valid):
    """K2 through the first design's wrapper (``CTC_WARP 0``): its mask
    copies, then its kernel."""
    T, B, S = emit.shape
    alpha = torch.empty_like(emit)
    tm, sk, sv = _u8(time_mask), _u8(allow_skip), _u8(state_valid)
    rc = lib.ctc_alpha(emit.data_ptr(), tm.data_ptr(), sk.data_ptr(),
                       sv.data_ptr(), alpha.data_ptr(), T, B, S,
                       torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first design's ctc_alpha failed: {rc}")
    return alpha


def old_beta_post(lib, emit, time_mask, allow_skip, state_valid, last_state,
                  alpha, ll):
    """K3 through the first design's wrapper: skipf2, finalok and
    is_last on the host's stream (``_beta_inputs``), five mask copies,
    then its kernel."""
    T, B, S = emit.shape
    post = torch.empty_like(emit)
    skipf2, finalok, is_last = C._beta_inputs(time_mask, allow_skip,
                                              last_state)
    masks = [_u8(m) for m in (time_mask, is_last, skipf2, state_valid,
                              finalok)]
    alpha = alpha.to(torch.float32).contiguous()
    ll = ll.to(torch.float32).contiguous()
    rc = lib.ctc_beta_post(emit.data_ptr(), *(m.data_ptr() for m in masks),
                           alpha.data_ptr(), ll.data_ptr(), post.data_ptr(),
                           T, B, S, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"first design's ctc_beta_post failed: {rc}")
    return post


def build_variants(out_dir: str, variants):
    """name -> the library of csrc/ctc.cu with that variant's (text,
    replacement), one nvcc each, all started together."""
    libs = _build.build_variants("ctc", out_dir, variants)
    for name, lib in libs.items():
        if variants[name][:2] == OLD_DESIGN:
            lib.ctc_alpha.argtypes = [ctypes.c_void_p] * 5 \
                + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.ctc_beta_post.argtypes = [ctypes.c_void_p] * 9 \
                + [ctypes.c_int] * 3 + [ctypes.c_void_p]
            lib.ctc_alpha.restype = lib.ctc_beta_post.restype = ctypes.c_int
    return libs


@contextlib.contextmanager
def variant(lib, consts=None):
    """The port's wrappers on ``lib`` in place of the ctc library, with
    the plan mirror's constants (KMAX, DEPTH) set to its build's."""
    consts = dict(consts or {})
    saved = _build._libs["ctc"], {k: getattr(C, k) for k in consts}
    _build._libs["ctc"] = lib
    for k, v in consts.items():
        setattr(C, k, v)
    try:
        yield
    finally:
        _build._libs["ctc"] = saved[0]
        for k, v in saved[1].items():
            setattr(C, k, v)


def event_ms(fn, n: int = 20) -> float:
    """Median time of a call by CUDA events, after a warm-up."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def host_ms(fn, n: int = 20) -> float:
    """Host time a call takes to return (no synchronisation inside)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) * 1e3 / n


def _device_events(prof):
    """(name, device us) of every device event of a profile: kernels,
    copies and fills."""
    out = []
    for evt in prof.key_averages():
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if evt.device_type == torch.autograd.DeviceType.CUDA and us > 0:
            out.append((evt.key, us, evt.count))
    return out


def device_ms(fn, keys=KERNELS, n: int = 10) -> float:
    """Device time per call of fn's kernels whose names hold one of
    ``keys`` (torch.profiler), after a warm-up."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(u for k, u, _ in _device_events(prof) if any(x in k for x in keys))
    return us / 1e3 / n


def one_call(fn, n: int = 5):
    """[(name, count)] of the device operations (kernels, copies, fills)
    of ``n`` calls of fn under torch.profiler, after a warm-up: one call
    of a wrapper that launches its kernel and nothing else shows one name,
    counted n times. A long-lived process's trace may miss launches: a
    count may fall short of n, and a trace that holds no device operation
    at all (fn launches at least one) is taken again, after another
    unprofiled call, up to five times (three empty traces in a row have
    been seen)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        counts = {}
        for evt in prof.events():
            if evt.device_type == torch.autograd.DeviceType.CUDA:
                counts[evt.name[:80]] = counts.get(evt.name[:80], 0) + 1
        if counts:
            break
    return sorted(counts.items())


def _diff(a, b) -> dict:
    d = (a - b).abs()
    return {"max_abs": float(d.max()), "cells_differ": int((a != b).sum())}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--ablate", action="store_true")
    p.add_argument("--plans", action="store_true")
    p.add_argument("--only", choices=("old",))
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("ctc_probe needs a CUDA device")
    dev = torch.device("cuda", 0)
    variants = {"old design": OLD_DESIGN}
    if args.only is None:
        _build.load_library("ctc")
        if args.ablate:
            variants.update(CUTS)
        if args.plans:
            variants.update(PLANS)
    libs = build_variants(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                       "ctc_probe"), variants)
    old = libs["old design"]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps({"card": torch.cuda.get_device_name(0),
                      "nvidia_smi": card}), flush=True)
    for T, B, S, shape in SHAPES:
        emit, tmask, skip, svalid, last = lattice(T, B, S, dev=dev)
        alpha_p = C._alpha_plain(emit, tmask, skip, svalid)
        ll = C._log_likelihood(alpha_p, last // 2)
        calls = {
            "ctc_alpha": (
                lambda: C.ctc_alpha_kernel(emit, tmask, skip, svalid),
                lambda: old_alpha(old, emit, tmask, skip, svalid)),
            "ctc_beta_post": (
                lambda: C.ctc_beta_post_kernel(emit, tmask, skip, svalid,
                                               last, alpha_p, ll),
                lambda: old_beta_post(old, emit, tmask, skip, svalid, last,
                                      alpha_p, ll))}
        for name, (new_fn, old_fn) in calls.items():
            rec = {"kernel": name, "shape": shape, "T": T, "B": B, "S": S,
                   "plan": C.warp_plan(T, S), "card": card}
            rec["old"] = {"event_ms": event_ms(old_fn),
                          "device_ms": device_ms(old_fn),
                          "host_ms": host_ms(old_fn),
                          "one_call": one_call(old_fn)}
            if args.only is None:
                rec["new"] = {"event_ms": event_ms(new_fn),
                              "device_ms": device_ms(new_fn),
                              "host_ms": host_ms(new_fn),
                              "one_call": one_call(new_fn)}
                rec["new_again_event_ms"] = event_ms(new_fn)
                rec["old_again_event_ms"] = event_ms(old_fn)
                out = new_fn()
                rec["new_vs_old"] = _diff(out, old_fn())
                for cut in (CUTS if args.ablate else ()):
                    with variant(libs[cut]):
                        rec.setdefault("cut_device_ms", {})[cut] = \
                            device_ms(new_fn)
                for plan, (_, _, consts) in (PLANS.items() if args.plans
                                             else ()):
                    with variant(libs[plan], consts):
                        rec.setdefault("plans", {})[plan] = {
                            "plan": C.warp_plan(T, S),
                            "device_ms": device_ms(new_fn),
                            "event_ms": event_ms(new_fn),
                            "vs_warp_design": _diff(new_fn(), out)}
            print(json.dumps(rec), flush=True)


if __name__ == "__main__":
    main()
