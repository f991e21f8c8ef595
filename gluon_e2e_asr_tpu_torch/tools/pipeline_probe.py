"""P1 on Hopper: do independent LSTM chains overlap in one kernel?

Counterpart of ``tools/pipeline_probe.py`` (``make_probe``: its
``kernel`` runs N independent f32 LSTM chains interleaved in one kernel
over T steps, per chain per step one dependent [M,320]x[320,1280]
product and the gates, and writes each chain's final h). Here the
kernel is ``csrc/pipeline_probe.cu`` in two designs, whose header says
what bounds each:

- ``l2``: K1's recurrence design, W read from L2 every step, each block
  carrying all N chains (``pipeline_probe_l2_kernel``);
- ``cluster``: W resident in shared memory across a 16-CTA cluster, h
  exchanged through distributed shared memory, one cluster per chain and
  group of 48 rows (``pipeline_probe_cluster_kernel``).

``pipeline_probe`` dispatches on the device: the plain version
(``pipeline_probe_plain``) for CPU tensors, the chosen kernel for CUDA
tensors, nothing else. ``cudnn_chains`` computes the same chains with
``torch.nn.LSTM``, a yardstick for the tests and chip_smoke.py; the
port never calls it.

Run from the root of a checkout on a machine with the card and nvcc::

    python -m gluon_e2e_asr_tpu_torch.tools.pipeline_probe [--T 640] [--iters 20]
        [--M 96 128 192 256] [--ablate]

For each variant and each (M, N) of the TPU probe's sweep it prints one
JSON line (ms over ``--iters`` calls by CUDA events, TFLOP/s, the cost
against N=1, the blocks or clusters launched, the card's name and power
limit), then the TPU probe's verdict at M=96 and 128 for each variant.

``--ablate`` also builds the cluster kernel with one piece of its step
cut at a time (``CUTS``; each such build computes wrong results, only its
time counts) and times each at M=96, N=1 beside the kernel as it is, in
the same process: the time a piece costs is the difference.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from gluon_e2e_asr_tpu_torch import _build

H = 320  # the TPU probe's hidden size, fixed
VARIANTS = ("l2", "cluster")
MS = (96, 128, 192, 256)
NS = (1, 2, 3, 4)
VERDICT_MS = (96, 128)
MAX_CHAINS_L2 = 4  # csrc/pipeline_probe.cu: l2_kernel is unrolled over N
ROWS_L2 = 2  # rows per block of l2_kernel
ROWS_CLUSTER, CTAS = 48, 16  # rows and CTAs per cluster of cluster_kernel
# name -> [(text of csrc/pipeline_probe.cu, its replacement)]: each cuts one
# piece of the cluster kernel's step.
CUTS = {
    # h' goes to this CTA's own buffer only, not to the 15 others
    "exchange": [(
        "      *reinterpret_cast<float4*>(cluster.map_shared_rank(dst, r)) = hv;",
        "      if (r == rank) *reinterpret_cast<float4*>(dst) = hv;")],
    # a CTA barrier where the cluster barrier ends the step, and one
    # cluster barrier after the loop, so that no CTA exits while another
    # may still store into its shared memory
    "cluster barrier": [("    cluster.sync();\n    cur ^= 1;\n  }\n",
                         "    __syncthreads();\n    cur ^= 1;\n  }\n"
                         "  cluster.sync();\n")],
    "product": [("    for (int j = 0; j < kKBlock; ++j) {",
                 "    for (int j = 0; j < 0; ++j) {")],
    # 24 rows a cluster (twice the clusters): what a step costs per row
    "half the rows": [("constexpr int kRowsCl = 48;", "constexpr int kRowsCl = 24;"),
                      ("static_assert(kClSmem == 225520,",
                       "static_assert(kClSmem == 164080,")],
}
ABLATE_AT = (96, 1)  # (M, N)


def pipeline_probe_plain(h0, c0, w, T: int):
    """h0, c0 [N,M,H]; w [N,H,4H] with columns [i | f | o | g]. The TPU
    ``kernel``'s math over T steps (no forget bias); returns h [N,M,H]."""
    pipeline_probe_plain.calls += 1
    Hh = h0.shape[-1]
    h, c = h0, c0
    for _ in range(T):
        g = torch.bmm(h, w)
        s = torch.sigmoid(g[..., :3 * Hh])
        tg = torch.tanh(g[..., 3 * Hh:])
        c = s[..., Hh:2 * Hh] * c + s[..., :Hh] * tg
        h = s[..., 2 * Hh:] * torch.tanh(c)
    return h


pipeline_probe_plain.calls = 0


def _check(h0, c0, w, T: int, variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"variant must be one of {VARIANTS}, got {variant!r}")
    if h0.dim() != 3:
        raise ValueError(f"h0 must be [N,M,{H}], got {tuple(h0.shape)}")
    N, M, Hh = h0.shape
    if Hh != H or N < 1 or M < 1:
        raise ValueError(f"h0 must be [N,M,{H}] with N, M >= 1, got "
                         f"{tuple(h0.shape)}")
    if T < 0:
        raise ValueError(f"T must be >= 0, got {T}")
    for name, t, shape in (("h0", h0, (N, M, H)), ("c0", c0, (N, M, H)),
                           ("w", w, (N, H, 4 * H))):
        if t.device != h0.device:
            raise ValueError(f"{name} is on {t.device}, h0 on {h0.device}")
        if t.dtype != torch.float32:
            raise ValueError(f"{name} must be torch.float32, got {t.dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _interleave(w: torch.Tensor) -> torch.Tensor:
    """[N,H,4H] gate-major (i|f|o|g) -> column 4u+q holding gate q of unit
    u (the kernels' layout)."""
    N = w.shape[0]
    return w.reshape(N, H, 4, H).transpose(2, 3).reshape(N, H, 4 * H).contiguous()


def _lib() -> ctypes.CDLL:
    return _bind(_build.load_library("pipeline_probe"))


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    if lib.pipeline_probe_error_string.argtypes is None:
        # Without argtypes ctypes passes each pointer as a 32-bit int.
        for fn in (lib.pipeline_probe_l2, lib.pipeline_probe_cluster):
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 \
                + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        lib.pipeline_probe_max_clusters.argtypes = [ctypes.c_void_p] * 2
        lib.pipeline_probe_max_clusters.restype = ctypes.c_int
        lib.pipeline_probe_error_string.argtypes = [ctypes.c_int]
        lib.pipeline_probe_error_string.restype = ctypes.c_char_p
    return lib


def max_active_clusters(dev=None) -> int:
    """cudaOccupancyMaxActiveClusters of the cluster kernel on ``dev``:
    how many of its 16-CTA clusters the card holds at once."""
    dev = torch.device("cuda", torch.cuda.current_device()) if dev is None \
        else torch.device(dev)
    lib = _lib()
    n = ctypes.c_int(0)
    with torch.cuda.device(dev):
        rc = lib.pipeline_probe_max_clusters(
            ctypes.byref(n), torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError("cudaOccupancyMaxActiveClusters failed: "
                           f"{lib.pipeline_probe_error_string(rc).decode()}")
    return n.value


def _run(entry: str, h0, c0, w, T: int) -> torch.Tensor:
    if h0.device.type != "cuda":
        raise ValueError(f"{entry} needs CUDA tensors, got {h0.device}")
    N, M, _ = h0.shape
    wi = _interleave(w)
    out = torch.empty_like(h0)
    lib = _lib()
    dev = h0.device
    with torch.cuda.device(dev):
        rc = getattr(lib, entry)(h0.data_ptr(), c0.data_ptr(), wi.data_ptr(),
                                 out.data_ptr(), N, M, T,
                                 torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"{entry} launch failed: "
                           f"{lib.pipeline_probe_error_string(rc).decode()} "
                           f"(N={N} M={M} T={T})")
    return out


def pipeline_probe_l2_kernel(h0, c0, w, T: int) -> torch.Tensor:
    """Variant ``l2`` on the card; N at most 4."""
    _check(h0, c0, w, T, "l2")
    if h0.shape[0] > MAX_CHAINS_L2:
        raise ValueError(f"the l2 kernel carries at most {MAX_CHAINS_L2} "
                         f"chains, got N={h0.shape[0]}")
    out = _run("pipeline_probe_l2", h0, c0, w, T)
    pipeline_probe_l2_kernel.launches += 1
    return out


pipeline_probe_l2_kernel.launches = 0


def pipeline_probe_cluster_kernel(h0, c0, w, T: int) -> torch.Tensor:
    """Variant ``cluster`` on the card. Raises where the card holds no
    16-CTA cluster of it (the launch checks cudaOccupancyMaxActiveClusters
    and refuses)."""
    _check(h0, c0, w, T, "cluster")
    out = _run("pipeline_probe_cluster", h0, c0, w, T)
    pipeline_probe_cluster_kernel.launches += 1
    return out


pipeline_probe_cluster_kernel.launches = 0

KERNELS = {"l2": pipeline_probe_l2_kernel,
           "cluster": pipeline_probe_cluster_kernel}


def pipeline_probe(h0, c0, w, T: int, variant: str = "l2") -> torch.Tensor:
    """The final h [N,M,320] of N chains over T steps (the TPU ``probe``
    returns its sum): the plain version for CPU tensors, the kernel of
    ``variant`` for CUDA tensors. f32, contiguous, one device."""
    _check(h0, c0, w, T, variant)
    if h0.device.type == "cpu":
        return pipeline_probe_plain(h0, c0, w, T)
    if h0.device.type != "cuda":
        raise ValueError(f"pipeline_probe: no implementation for {h0.device}")
    return KERNELS[variant](h0, c0, w, T)


def cudnn_chains(h0, c0, w, T: int):
    """The same chains through ``torch.nn.LSTM(1, H)`` (cuDNN on the
    card), one call per chain: zero input, zero ``weight_ih`` and biases,
    ``weight_hh`` = W with its columns in torch's (i, f, g, o) order,
    transposed. Returns a function that runs them and returns h_n
    [N,M,H]. A yardstick: the port never calls it."""
    N, M, _ = h0.shape
    perm = torch.cat([torch.arange(0, 2 * H), torch.arange(3 * H, 4 * H),
                      torch.arange(2 * H, 3 * H)]).to(w.device)
    x = torch.zeros(T, M, 1, device=h0.device)
    lstms = []
    for n in range(N):
        lstm = torch.nn.LSTM(1, H).to(h0.device)
        with torch.no_grad():
            lstm.weight_ih_l0.zero_()
            lstm.bias_ih_l0.zero_()
            lstm.bias_hh_l0.zero_()
            lstm.weight_hh_l0.copy_(w[n][:, perm].T)
        lstms.append(lstm)

    def run():
        with torch.no_grad():
            return torch.stack([lstm(x, (h0[n][None], c0[n][None]))[1][0][0]
                                for n, lstm in enumerate(lstms)])

    return run


def probe_inputs(N: int, M: int, dev, seed: int = 0):
    """The TPU probe's inputs: h0 N(0, 0.1^2), c0 zero, W N(0, 0.02^2)."""
    rng = np.random.default_rng(seed)
    h0 = rng.standard_normal((N, M, H)) * 0.1
    w = rng.standard_normal((N, H, 4 * H)) * 0.02
    return (torch.tensor(h0, dtype=torch.float32, device=dev),
            torch.zeros(N, M, H, device=dev),
            torch.tensor(w, dtype=torch.float32, device=dev))


def live_inputs(N: int, M: int, dev, seed: int = 0):
    """Inputs whose state stays alive over hundreds of steps without
    amplifying rounding, for holding a kernel to the plain version: h0
    and c0 N(0, 0.5^2); each unit excites its own g gate (weight 4), so
    it settles at one of two states of |h| about 0.35, and the rest of W,
    N(0, 0.1^2 / H), couples the units weakly. (With the TPU probe's
    inputs h falls below 1e-24 within 100 steps and is 0 after about
    190, so a comparison after 640 steps would compare zeros.)"""
    rng = np.random.RandomState(seed)
    h0 = rng.randn(N, M, H) * 0.5
    c0 = rng.randn(N, M, H) * 0.5
    w = rng.randn(N, H, 4 * H) * 0.1 / np.sqrt(H)
    w[:, np.arange(H), 3 * H + np.arange(H)] += 4.0
    return tuple(torch.tensor(a, dtype=torch.float32, device=dev)
                 for a in (h0, c0, w))


def flops(N: int, M: int, T: int) -> float:
    return float(N) * T * 2 * M * H * 4 * H


def grid(variant: str, N: int, M: int) -> dict:
    """What a launch of ``variant`` runs on the card."""
    if variant == "l2":
        return {"blocks": -(-M // ROWS_L2)}
    clusters = N * -(-M // ROWS_CLUSTER)
    return {"clusters": clusters, "blocks": clusters * CTAS}


def verdict(variant: str, M: int, ms: dict) -> str:
    """The TPU probe's summary line at M (``ms`` maps (M, N) to ms): 4
    chains costing under 2.5x one chain is latency-bound."""
    r2 = ms[(M, 2)] / ms[(M, 1)]
    r4 = ms[(M, 4)] / ms[(M, 1)]
    return (f"# {variant} M={M}: 2 chains cost {r2:.2f}x one chain, "
            f"4 chains {r4:.2f}x — "
            + ("latency-bound: pipelining headroom EXISTS"
               if r4 < 2.5 else
               "throughput-bound: no pipelining headroom"))


def event_ms(fn, iters: int) -> float:
    """Mean ms of ``fn`` over ``iters`` back-to-back calls after one
    warm-up, by CUDA events."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def build_cuts(out_dir: str) -> dict:
    """name -> the library of csrc/pipeline_probe.cu with that cut, one
    nvcc each, all started together."""
    with open(os.path.join(_build.SRC_DIR, "pipeline_probe.cu")) as f:
        src = f.read()

    def build(name):
        text = src
        for old, new in CUTS[name]:
            if text.count(old) != 1:
                raise RuntimeError(f"cut {name!r}: {old!r} is not in the "
                                   "source once")
            text = text.replace(old, new)
        d = os.path.join(out_dir, name.replace(" ", "_"))
        os.makedirs(d, exist_ok=True)
        path = os.path.join(d, "pipeline_probe.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(d, "libpipeline_probe.so")
        proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                               _build.SRC_DIR, "-o", lib, path],
                              capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"cut {name!r}: nvcc failed\n{proc.stderr}")
        return lib

    with ThreadPoolExecutor(len(CUTS)) as pool:
        paths = dict(zip(CUTS, pool.map(build, CUTS)))
    return {name: _bind(ctypes.CDLL(p)) for name, p in paths.items()}


def ablate(cuts: dict, T: int, iters: int, card: str) -> dict:
    """The cluster kernel as it is and with each cut, at ABLATE_AT: ms and
    microseconds a step."""
    M, N = ABLATE_AT
    h0, c0, w = probe_inputs(N, M, torch.device("cuda", 0))
    run = lambda: pipeline_probe(h0, c0, w, T, "cluster")  # noqa: E731
    rec = {"ablate": "cluster", "M": M, "N": N, "T": T, "ms": event_ms(run, iters),
           "ms_without": {}, "card": card}
    kernel_lib = _build._libs["pipeline_probe"]
    for name, lib in cuts.items():
        _build._libs["pipeline_probe"] = lib
        try:
            rec["ms_without"][name] = event_ms(run, iters)
        finally:
            _build._libs["pipeline_probe"] = kernel_lib
    rec["us_per_step"] = {"all": rec["ms"] * 1e3 / T, **{
        f"without {k}": v * 1e3 / T for k, v in rec["ms_without"].items()}}
    print(json.dumps(rec), flush=True)
    return rec


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--T", type=int, default=640)
    p.add_argument("--iters", type=int, default=20)
    p.add_argument("--M", type=int, nargs="+", default=list(MS))
    p.add_argument("--ablate", action="store_true")
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("pipeline_probe needs a CUDA device")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    clusters = max_active_clusters(dev)
    cuts = build_cuts(os.path.join(os.path.dirname(_build.BUILD_DIR),
                                   "pipeline_probe_cuts")) if args.ablate else {}
    T = args.T
    results = {v: {} for v in VARIANTS}
    for variant in VARIANTS:
        for M in args.M:
            for N in NS:
                h0, c0, w = probe_inputs(N, M, dev)
                ms = event_ms(lambda: pipeline_probe(h0, c0, w, T, variant),
                              args.iters)
                results[variant][(M, N)] = ms
                rec = {"variant": variant, "M": M, "N": N, "T": T, "H": H,
                       "ms": ms, "tflops": flops(N, M, T) / (ms * 1e-3) / 1e12,
                       "cost_vs_n1": ms / results[variant][(M, 1)],
                       **grid(variant, N, M), "card": card}
                if variant == "cluster":
                    rec["max_active_clusters"] = clusters
                print(json.dumps(rec), flush=True)
    for variant in VARIANTS:
        for M in VERDICT_MS:
            if (M, 1) in results[variant]:
                print(verdict(variant, M, results[variant]), flush=True)
    if cuts:
        ablate(cuts, T, args.iters, card)
    return results


if __name__ == "__main__":
    main()
