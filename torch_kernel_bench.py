#!/usr/bin/env python3
"""Time kernels K1 (chamfer nearest neighbour), K3 (EMD bid), K4 and K5
(slot-splat forward and backward) of a checkout of the PyTorch port at
the launch shapes of the registration pass, on one NVIDIA GPU.

    python3 torch_kernel_bench.py [--root DIR] [--variants]

--root names the checkout whose genpc_tpu_torch is timed (default: the
directory of this script), so two commits compare in one call on one
card: unpack the other commit into a git-ignored directory and run
parent, change, change, parent.  The shapes and inputs are those of
chip_smoke.py phase 3 (``K1_SHAPES``, ``K3_SHAPE``, the pose tables at
res 224 and 112, seeded).  K4 and K5 run on the contiguous copy of the
table, so that no copy of it is inside their times; K5 is
``assemble_bwd_points`` where the checkout has it, else the dense
``assemble_bwd`` (its cotangent buffer included), and "K5+gather" is
what the renderer's backward spends to get each point's gradients (the
dense table and the 7 gathers, or the per-point call).  Each result
is one JSON line: kernel, class, shape, ms (CUDA events around one call,
the median of 5 after a warm-up, chip_smoke.cuda_ms), ms_b2b (the same
around 20 calls issued back to back behind a device sleep, divided by
20, the median of 3: the launches' own device time, with the host ahead
of the card), the card's name and power limit.

--variants (a checkout with ``nn_plan`` and ``bid_plan``) also times each
kernel under other plans (rows a thread, threads a block, M splits) and
checks that every variant's outputs are bitwise those of the default
plan.  The script imports no JAX.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def back_to_back_ms(fn, calls: int = 20, reps: int = 3,
                    sleep_cycles: int = 40_000_000) -> float:
    """Median over reps of the device time of `calls` calls of fn()
    issued back to back, per call, in ms; all of them are enqueued behind
    a device sleep (~20 ms) so that the card runs them without waiting
    for the host."""
    import statistics
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(sleep_cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def splat(emit, cs, sk, dev, seed=4) -> None:
    """K4 and K5 at the pose path's two resolutions (R = 52, S = 6,
    f = 2) on the contiguous copy of chip_smoke's pose tables."""
    import numpy as np
    import torch
    g = np.random.default_rng(seed)
    for res, n_pts in ((224, 2048), (112, 512)):
        table, slot_orig, order, _ = cs._pose_tables(dev, res, n_pts)
        table = table.contiguous()
        r = table.shape[0]
        cots = (torch.tensor(g.normal(size=(r, 3, res, res)),
                             dtype=torch.float32, device=dev),
                torch.tensor(g.normal(size=(r, res, res)),
                             dtype=torch.float32, device=dev))
        _, dmax = sk.assemble(table, res, 2, 1e-2)
        if hasattr(sk, "assemble_bwd_points"):
            def k5():
                return sk.assemble_bwd_points(table, slot_orig, cots, dmax,
                                              res, 2, 6, 1e-2, order)
            k5_gather = k5
        else:
            def k5():
                return sk.assemble_bwd(table, cots, dmax, res, 2, 1e-2)

            def k5_gather():
                npix = res * res
                valid = slot_orig < 6 * npix
                rank = torch.div(slot_orig, npix, rounding_mode="floor")
                pos = torch.where(valid, rank * (7 * npix) + slot_orig % npix,
                                  0)
                flat = k5().reshape(r, -1)
                return [torch.where(valid, torch.gather(flat, 1,
                                                        pos + c * npix), 0.0)
                        for c in range(7)]
        for name, fn in (("K4", lambda: sk.assemble(table, res, 2, 1e-2)),
                         ("K5", k5), ("K5+gather", k5_gather)):
            emit(kernel=name, cls=f"pose_{res}", shape=(r, 6, res),
                 plan="default", ms=cs.cuda_ms(fn, reps=5),
                 ms_b2b=back_to_back_ms(fn))
        del table, slot_orig, order, cots, dmax
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=HERE)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    # the shapes and inputs of this checkout's chip_smoke.py, whatever the
    # root
    spec = importlib.util.spec_from_file_location(
        "smoke_shapes", os.path.join(HERE, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    from genpc_tpu_torch import _kernels
    from genpc_tpu_torch.ops import chamfer, emd_kernel
    from genpc_tpu_torch.render import splat_kernel
    if not _kernels.__file__.startswith(root):
        print(f"genpc_tpu_torch imported from {_kernels.__file__}, not "
              f"{root}", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    dev = torch.device("cuda", 0)
    _kernels.lib()

    def emit(**rec):
        print(json.dumps({"root": root, "card": card, **rec}), flush=True)

    for i, (name, shape, shared) in enumerate(cs.K1_SHAPES):
        x, y, yi = cs.k1_inputs(dev, shape, shared, seed=i)
        ref = chamfer._nn(x, y, yi)
        emit(kernel="K1", cls=name, shape=shape, plan="default",
             ms=cs.cuda_ms(lambda: chamfer._nn(x, y, yi), reps=5),
             ms_b2b=back_to_back_ms(lambda: chamfer._nn(x, y, yi)))
        if args.variants:
            b, n, m = shape
            for rows, threads in itertools.product((2, 4), (64, 128, 256)):
                for splits in (1, 2, 4, 8):
                    if m // splits < 256:
                        continue
                    plan = chamfer.nn_plan(b, n, m, rows, threads, splits)
                    got = chamfer._launch(x, y, yi, plan)
                    same = all(torch.equal(a, r) for a, r in zip(got, ref))
                    emit(kernel="K1", cls=name, shape=shape, plan=plan,
                         bitwise_default=same,
                         ms=cs.cuda_ms(lambda: chamfer._launch(x, y, yi,
                                                               plan),
                                       reps=5))
        del x, y, yi, ref
        torch.cuda.empty_cache()

    x1, x2, pr = cs.k3_inputs(dev)
    ref = emd_kernel.bid(x1, x2, pr)
    emit(kernel="K3", cls="metric", shape=cs.K3_SHAPE, plan="default",
         ms=cs.cuda_ms(lambda: emd_kernel.bid(x1, x2, pr), reps=5),
         ms_b2b=back_to_back_ms(lambda: emd_kernel.bid(x1, x2, pr)))
    if hasattr(emd_kernel, "spatial_order"):     # rows in the auction's order
        order = emd_kernel.spatial_order(x1)
        got = emd_kernel.bid(x1, x2, pr, order=order)
        emit(kernel="K3", cls="metric", shape=cs.K3_SHAPE,
             plan="default, spatial row order",
             bitwise_default=all(torch.equal(a, r) for a, r in zip(got, ref)),
             ms=cs.cuda_ms(lambda: emd_kernel.bid(x1, x2, pr, order=order),
                           reps=5),
             ms_b2b=back_to_back_ms(lambda: emd_kernel.bid(x1, x2, pr,
                                                           order=order)))
    splat(emit, cs, splat_kernel, dev)
    if args.variants:
        for threads in (64, 128, 256):
            plan = emd_kernel.bid_plan(*cs.K3_SHAPE, threads)
            got = emd_kernel._launch(x1, x2, pr, order, plan)
            same = all(torch.equal(a, r) for a, r in zip(got, ref))
            emit(kernel="K3", cls="metric", shape=cs.K3_SHAPE, plan=plan,
                 order="spatial", bitwise_default=same,
                 ms=cs.cuda_ms(lambda: emd_kernel._launch(x1, x2, pr, order,
                                                          plan), reps=5))
    return 0


if __name__ == "__main__":
    sys.exit(main())
