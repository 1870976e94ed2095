#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, device count;
  2. build: compiles the CUDA kernels from genpc_tpu_torch/csrc into
     build/ and prints the build time;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main path gives it, with both times (CUDA events, warm-up
     then the median of 3);
  4. the main path: ``run_batched`` over 13 seeded synthetic objects at
     the Redwood protocol sizes (aligned-completion fast path), a warm-up
     and a timed pass, with the launch count of every kernel on the path.

The second-to-last line is a JSON object with one entry per kernel; the
last line is ``{"ok": true, "device": {...}}``.  The script imports no
JAX.  It exits non-zero without a CUDA device, and when run from a
directory that does not hold the genpc_tpu_torch package.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 3) -> float:
    """Median device time of fn() in ms: one warm-up, then reps timed runs."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


# ------------------------------------------------------------ phase 3 ---

def check_k1(dev, small=(2, 300, 500), big=(13, 16384, 16384), seed=0):
    """K1 (chamfer NN) against its plain version."""
    import numpy as np
    import torch
    from genpc_tpu_torch.ops.chamfer import _nn, _nn_plain
    r = np.random.default_rng(seed)
    b, n, m = small
    x = torch.tensor(r.random((b, n, 3)), dtype=torch.float32, device=dev)
    y = torch.tensor(r.random((b, m, 3)), dtype=torch.float32, device=dev)
    dk, ik = _nn(x, y)
    dp, ip = _nn_plain(x, y)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
        fail("K1 small: kernel differs from the plain version")
    b, n, m = big
    x = torch.tensor(r.random((b, n, 3)), dtype=torch.float32, device=dev)
    y = torch.tensor(r.random((b, m, 3)), dtype=torch.float32, device=dev)
    dk, ik = _nn(x, y)
    dp, ip = _nn_plain(x, y)
    torch.cuda.synchronize()
    agree = ik == ip
    frac = agree.float().mean().item()
    exact = torch.equal(dk[agree], dp[agree])
    err = (dk - dp).abs().max().item()
    log(f"K1 chamfer_nn {big}: index agreement {frac:.6f}, distances exact "
        f"where agreeing: {exact}, max |d| err {err:.3e}")
    if frac < 0.999 or not exact:
        fail("K1 big: below the 99.9% / exact-distance contract")
    ms = cuda_ms(lambda: _nn(x, y))
    plain_ms = cuda_ms(lambda: _nn_plain(x, y))
    log(f"K1 time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_k2(dev, small=(2, 1000, 256), big=(13, 163840, 16384), seed=1):
    """K2 (FPS) against its plain version."""
    import numpy as np
    import torch
    from genpc_tpu_torch.ops.fps_kernel import fps_batched, fps_batched_plain
    r = np.random.default_rng(seed)
    b, n, k = small
    p = torch.tensor(r.uniform(-1, 1, (b, n, 3)), dtype=torch.float32,
                     device=dev)
    ik = fps_batched(p, k)
    ip = fps_batched_plain(p, k)
    torch.cuda.synchronize()
    if not torch.equal(ik, ip):
        fail("K2 small: sequence differs from the plain version")
    rows = torch.arange(b, device=dev)[:, None]
    err = (p[rows, ik.long()] - p[rows, ip.long()]).abs().max().item()
    b, n, k = big
    p = torch.tensor(r.uniform(-0.5, 0.5, (b, n, 3)), dtype=torch.float32,
                     device=dev)
    ik = fps_batched(p, k).cpu().numpy()
    ip = fps_batched_plain(p, k).cpu().numpy()
    frac = min(len(set(ik[i].tolist()) & set(ip[i].tolist())) / k
               for i in range(b))
    log(f"K2 fps {big}: exact at {small}, selected-set agreement "
        f"(worst object) {frac:.6f}")
    if frac < 0.999:
        fail("K2 big: below the 99.9% selected-set contract")
    ms = cuda_ms(lambda: fps_batched(p, k))
    plain_ms = cuda_ms(lambda: fps_batched_plain(p, k))
    log(f"K2 time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def check_k3(dev, big=(13, 16384, 16384), seed=2):
    """K3 (EMD bid phase) against its plain version."""
    import numpy as np
    import torch
    from genpc_tpu_torch.ops.emd_kernel import bid, bid_plain
    r = np.random.default_rng(seed)
    b, n, m = big
    x1 = torch.tensor(r.random((b, n, 3)), dtype=torch.float32, device=dev)
    x2 = torch.tensor(r.random((b, m, 3)), dtype=torch.float32, device=dev)
    pr = torch.tensor(r.random((b, m)) * 0.1, dtype=torch.float32,
                      device=dev)
    bk, bestk, betk = bid(x1, x2, pr)
    bp, bestp, betp = bid_plain(x1, x2, pr)
    torch.cuda.synchronize()
    frac = (bk == bp).float().mean().item()
    err = max((bestk - bestp).abs().max().item(),
              (betk - betp).abs().max().item())
    log(f"K3 emd_bid {big}: bid agreement {frac:.6f}, max |best|,|better| "
        f"err {err:.3e}")
    if frac < 0.995 or err > 2e-4:
        fail("K3: below the 99.5% / 2e-4 contract")
    ms = cuda_ms(lambda: bid(x1, x2, pr))
    plain_ms = cuda_ms(lambda: bid_plain(x1, x2, pr))
    log(f"K3 time: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


KERNELS = [
    # name, wrapper (module, attribute), source, replaced Pallas kernel
    ("chamfer_nn", ("genpc_tpu_torch.ops.chamfer", "_nn"),
     "genpc_tpu_torch/csrc/chamfer_nn.cu", "genpc_tpu/ops/chamfer.py:47",
     check_k1),
    ("fps", ("genpc_tpu_torch.ops.fps_kernel", "fps_batched"),
     "genpc_tpu_torch/csrc/fps.cu", "genpc_tpu/ops/fps_kernel.py:44",
     check_k2),
    ("emd_bid", ("genpc_tpu_torch.ops.emd_kernel", "bid"),
     "genpc_tpu_torch/csrc/emd_bid.cu", "genpc_tpu/ops/emd_kernel.py:48",
     check_k3),
]


def wrapper(spec):
    import importlib
    mod, attr = spec
    return getattr(importlib.import_module(mod), attr)


# ------------------------------------------------------------ phase 4 ---

#: configs/redwood.yaml and the Redwood protocol, as keyword overrides
REDWOOD = dict(
    save=False, trust_aligned_completion=True, input_points=65536,
    view_num=1024, downsample_num=10000, res=256, cam_res=256,
    inpaint_iters=250, generate_res=512, glb_sample_points=163840,
    fused_points=20000, metric_points=16384, emd_eps=0.005, emd_iters=50,
    point_size=1, mask_pixel_rate=3, padding=0.15, fovy=49.1, distance=1.6,
    inpainter="jax", rembg_model="synthetic", control_model="synthetic",
    generative_model="synthetic", visibility="zbuffer")

#: a two-object config small enough for the plain versions on the host
TINY = dict(
    save=False, trust_aligned_completion=True, view_num=16,
    downsample_num=256, res=64, cam_res=64, generate_res=64,
    input_points=4096, inpaint_iters=10, glb_sample_points=512,
    fused_points=256, metric_points=256, emd_eps=0.005)


def small_input_check(tmp: str) -> None:
    """The whole path at a tiny size on the card and on the host (plain
    versions): per-object CD within 1e-5; EMD within emd_eps absolute.
    The bid kernel uses the direct distance form and the plain version
    the expansion, so near-tied bids can flip and send the auction down
    another path; both ends are eps-optimal assignments, whose mean
    distances differ by at most about eps."""
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.io.synthetic_data import write_dataset
    from genpc_tpu_torch.parallel.batched_runner import run_batched
    flags = ["01184", "05117"]
    root = os.path.join(tmp, "tiny")
    write_dataset(root, flags, seed=1, n_gt=8192)
    got = run_batched(load_config(device="cuda", **TINY), flags, root)
    ref = run_batched(load_config(device="cpu", **TINY), flags, root)
    for f in flags:
        log(f"small input {f}: cuda CD {got[f]['cd']:.7f} EMD "
            f"{got[f]['emd']:.7f} | cpu CD {ref[f]['cd']:.7f} EMD "
            f"{ref[f]['emd']:.7f}")
        if abs(got[f]["cd"] - ref[f]["cd"]) > 1e-5 or \
                abs(got[f]["emd"] - ref[f]["emd"]) > TINY["emd_eps"]:
            fail(f"small input {f}: card and host disagree")


def main_path(tmp: str, counters) -> dict:
    """run_batched over 13 synthetic objects at the Redwood sizes: a
    warm-up pass, then the timed pass whose kernel launches are counted."""
    import numpy as np
    import torch
    from genpc_tpu_torch.categories import REDWOOD_FLAGS
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.io.synthetic_data import write_dataset
    from genpc_tpu_torch.ops.chamfer import _nn_plain
    from genpc_tpu_torch.parallel import batched_runner
    flags = list(REDWOOD_FLAGS)
    root = os.path.join(tmp, "redwood_synthetic")
    t0 = time.time()
    write_dataset(root, flags, seed=0)
    log(f"data: {len(flags)} synthetic objects written in "
        f"{time.time() - t0:.1f} s")
    cfg = load_config(device="cuda", **REDWOOD)

    # record the metric's FPS samples to recompute CD independently
    seen = {}
    metric = batched_runner.batched_metric_sampled

    def recording_metric(p, g, **kw):
        seen["p"], seen["g"] = p, g
        return metric(p, g, **kw)

    batched_runner.batched_metric_sampled = recording_metric
    try:
        t0 = time.time()
        batched_runner.run_batched(cfg, flags, root)
        log(f"warm-up pass: {time.time() - t0:.2f} s")
        for fn in counters:
            fn.launches = 0
        timings = {}
        t0 = time.time()
        results = batched_runner.run_batched(cfg, flags, root,
                                             timings=timings)
        wall = time.time() - t0
        launches = {fn: fn.launches for fn in counters}
    finally:
        batched_runner.batched_metric_sampled = metric

    log(f"timed pass: {wall:.3f} s, {len(flags) / wall * 60:.3f} objects/min")
    log("stage walls (s): " + json.dumps(timings))
    log("launches in the timed pass: " + json.dumps(
        {f"{fn.__module__}.{fn.__name__}": n for fn, n in launches.items()}))
    for f in flags:
        m = results[f]
        log(f"  {f}: CD x100 {m['cd'] * 100:.4f}, EMD x100 "
            f"{m['emd'] * 100:.4f}")
    cds = np.array([results[f]["cd"] for f in flags])
    emds = np.array([results[f]["emd"] for f in flags])
    log(f"mean CD x100 {cds.mean() * 100:.4f}, mean EMD x100 "
        f"{emds.mean() * 100:.4f}")
    if set(results) != set(flags):
        fail("main path: missing objects in the results")
    if not (np.isfinite(cds).all() and np.isfinite(emds).all()):
        fail("main path: non-finite CD/EMD")
    if any(n == 0 for n in launches.values()):
        fail("main path: a kernel of the path was never launched")
    p, g = seen["p"], seen["g"]
    if p.shape != (len(flags), cfg.metric_points, 3) or p.shape != g.shape:
        fail(f"main path: metric samples of shape {tuple(p.shape)}")
    d1, _ = _nn_plain(p, g)
    d2, _ = _nn_plain(g, p)
    cd_plain = ((d1.clamp_min(0).sqrt().mean(1)
                 + d2.clamp_min(0).sqrt().mean(1)) / 2).cpu().numpy()
    rel = np.abs(cd_plain - cds) / cds
    log(f"CD recomputed with the plain NN: max relative difference "
        f"{rel.max():.3e}")
    if rel.max() > 1e-5:
        fail("main path: reported CD disagrees with the plain recompute")
    # every fused cloud was non-empty: a [13, 16384] metric sample exists
    torch.cuda.synchronize()
    return {fn: n for fn, n in launches.items()}


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "genpc_tpu_torch")):
        print("chip_smoke.py must run from a checkout of the repository "
              "(genpc_tpu_torch/ not found beside it)", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this smoke run needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(smi)
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"devices {torch.cuda.device_count()}")
    dev = torch.device("cuda", 0)

    # 2. build
    from genpc_tpu_torch import _kernels
    t0 = time.time()
    path = _kernels.build(verbose=True)
    _kernels.lib()
    log(f"build: {path.name} in {time.time() - t0:.1f} s")

    # 3. kernels against their plain versions
    report = {}
    for name, _spec, _src, _rep, check in KERNELS:
        report[name] = check(dev)

    # 4. the main path
    counters = [wrapper(spec) for _, spec, _, _, _ in KERNELS]
    with tempfile.TemporaryDirectory(prefix="genpc_smoke_") as tmp:
        small_input_check(tmp)
        launches = main_path(tmp, counters)

    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[wrapper(spec)], **report[name]}
        for name, spec, src, rep, _ in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
