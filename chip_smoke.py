#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (genpc_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py [--profile]

Phases (any failure exits non-zero; nothing is caught):
  1. environment: the card's name and power limit (nvidia-smi), torch and
     CUDA versions, device count;
  2. build: compiles the CUDA kernels from genpc_tpu_torch/csrc into
     build/ (one nvcc per source, in parallel) and prints the build time;
  3. each kernel against its plain PyTorch version on the card, at the
     shapes the main paths give it: K1 at every launch class of the
     batched registration pass, of the per-object pass, of the Waymo
     pass over LIDAR_SCANS scans and of its UHD, of the image-to-3D pass
     over IM_OBJECTS objects, of config 4 over CONFIG4_OBJECTS and of
     config 5's UHD over one scan (K1_SHAPES), with its launch plan,
     distances
     bit-equal, argmins the first index, and the count of tied minima;
     K2 at the batched metric's and fusion's shapes, at a 13-object
     pass's stage 1, metric prediction and pose subsample and the Qwen
     and FLUX passes' fusions, at one object's, at the image-to-3D
     pass's and config 4's and 5's, at the Waymo pass's, and at the PED
     shape
     (65,536 draws of 400 points, a tie at every late pick), the
     exact sequence, with its cluster size and how many clusters fit at
     once; K3 at 13 objects, at one and at IM_OBJECTS, bitwise equal to
     bid_plain_direct and within the reference contract of bid_plain; K4
     and K5 bit-equal at both pose resolutions for R = 52, 4, 4
     LIDAR_SCANS and 4 IM_OBJECTS renders, on the table as _build_table returns it, on its
     contiguous copy and on a table with every entry present, timed on
     the contiguous one: parity, the kernel's, the plain version's and
     (where one exists) a library call's times (CUDA events, warm-up
     then the median of 1-5, each run enqueued behind a device sleep so
     that the host's enqueue stays outside the interval), and the least
     time the card could take for the same work (bytes at 3.35 TB/s or
     fp32 operations at 67 TFLOP/s, whichever is larger: the H100 SXM
     data sheet); K6 (the int4 weight-only matmul) at every launch class
     of the FLUX, T5 and Qwen2.5-VL int4 layers (K6_CLASSES) against its
     plain twin, with its time, the plain twin's, cuBLAS's bf16 GEMM on
     the weight dequantised beforehand (the library's yardstick) and its
     bound (bf16 tensor-core flops, or the packed weight's bytes on the
     CUDA-core path);
  4. the main paths: first small-input checks, card against host, on two
     data seeds (run_batched on both of its paths, run_pipeline, and
     run_batched_lidar over PED scans with a held-out wedge; the
     registration steps held step by step); then run_batched over 13
     seeded synthetic objects at the Redwood protocol sizes, the
     aligned-completion fast path and the registration path (pose
     optimisation through K4/K5, ICP sweeps), each a warm-up and a timed
     pass (K2 must launch FPS_LAUNCHES times: one fusion launch over all
     objects; the registration passes must give bit-identical CD);
     run_pipeline (per object, registration on) over PER_OBJECT_FLAGS of
     them, a warm-up and a timed pass that must repeat bitwise;
     run_batched_lidar over LIDAR_SCANS generated CAR and PED scans at
     configs/lidar.yaml's and lidar_ped.yaml's values (CAR: a warm-up, a
     timed and a held-out pass; PED: a timed, a held-out and a pass
     with the fusion attribution of batched_reg's fusion_debug); and
     main_lidar.run_lidar over 2 CAR scans.  Every timed pass counts the
     launches of each kernel (the counts set to 0 just before it and read
     just after; each kernel of the path must launch) and prints a
     histogram of the K1-K5 launches by shape (K1/K3 (B, N, M), K2 (B, N,
     k), K4 (R, S, res), K5 (R, N, res)): launches and summed time (CUDA
     events around each call).
     --profile adds torch.profiler passes of the batched registration
     path and of the per-object path (one object) and prints device time
     by kernel (kernel rows only), the device's busy share, and K1-K5's
     sums.
  5. generation: ControlNetDepth and its T2I-Adapter variant at the
     tiny preset on the host and on the card with one state dict, the
     pure denoise on the same draws (images within GEN_IMAGE_TOL); then
     run_batched on the registration path over the 13 objects with the
     full-width SDXL depth ControlNet generating every image at 512²
     (30 steps, guidance 5.0): a warm-up and a timed pass, the images
     bitwise equal between them, the generation stage split into weight
     initialisation, prompt encoding, denoise loop and VAE decode, ms a
     denoise step (CUDA events), the peak memory allocated, CD/EMD and
     the K1-K5 launches; then standalone generate calls (the ControlNet
     at 1024², the adapter at 512²), the FLOPs of one denoise step
     (FlopCounterMode) at 512² and 1024² over its time against the bf16
     peak, and the memory allocated before the backend against after
     its release().
  6. image-to-3D: InstantMeshBackend at the tiny preset on the host and on
     the card with one state dict, the pure multiview denoise on the same
     draws and the density grid (views within IM_VIEW_TOL at most and
     IM_VIEW_MEAN_TOL on average, SDF grids within IM_SDF_TOL of the
     largest |sdf|); then run_batched on the
     registration path over the first IM_OBJECTS objects with the
     full-width InstantMesh backend (zero123plus, 75 multiview steps,
     guidance 4.0, a 96³ SDF grid, marching tetrahedra, 163,840 surface
     samples), all objects in one image23d_batch chunk: a warm-up and a
     timed pass, the decoded views bitwise equal between them, the
     image-to-3D stage split into the backend's spans (init, context,
     denoise, decode, grid, marching, colors, release), ms a multiview
     step (CUDA events), the peak memory, each mesh's vertices and faces,
     CD/EMD and the K1-K5 launches; the host cost of a real surface (each
     object's 96³ shell around its GT cloud: marching, sampling and
     batched_reg); at image23d_batch IM_OBJECTS and at 13 (one chunk
     over every object, the largest batch a run of the 13 can use): one
     step's FLOPs (FlopCounterMode) over its CUDA graph's time against
     the bf16 peak, and the peak memory of the stage's device work (the
     context, the step, the decode, the density grids and the colours at
     as many points as the pass's largest mesh has vertices); the memory
     back after release(); and the parameter count on the meta device.
  7. Qwen-Image-Edit: DiTDepthEdit at the tiny preset on the host and on
     the card with one state dict, generate_batch on the same draws
     (images within GEN_IMAGE_TOL); then run_batched on the registration
     path over the 13 objects with the full-width backend (the
     Qwen2.5-VL towers, the 60-block MMDiT, the 16-channel VAE; bf16
     weights; 8 steps, true CFG 4.0, 512²; all objects in one
     generate_obj_batch chunk): a warm-up and a timed pass, the images
     bitwise equal between them, the generation stage's spans (VL
     weights, encode, MMDiT weights, denoise, decode, release), each
     sampler step's time (CUDA events: the first, which captures its
     graph, and the replays), the peak memory and the memory back after
     release(), CD/EMD and the K1-K5 launches; the parameter counts and
     one step's FLOPs on the meta device, over the replays' time against
     the bf16 peak; then BASELINE config 4 once (Qwen-Image-Edit, then
     InstantMesh, both at full width, over CONFIG4_OBJECTS objects), the
     memory after each backend's release(), CD and EMD finite.
  8. FLUX: DiTDepthEdit("flux") at the tiny preset on the host and on the
     card with one state dict at quant_bits 0, 8 and 4 (generate_batch on
     the same draws, images within GEN_IMAGE_TOL), FluxInpainter.paint
     (within GEN_IMAGE_TOL, the known pixels exact) and
     T5PromptEncoder.encode (within T5_TOL); the parameter counts on the
     meta device against the reference's; then run_batched on the
     registration path over the first FLUX_OBJECTS objects with the
     reference's full-size FLUX deployment at its defaults (FLUX: the FLUX
     inpainter paints stage 1's depths at res², 30 steps each, and is
     freed; FLUX.1-Depth-dev generates the images at 512² in one chunk, 30
     steps, guidance 10.0; int4 MMDiT and int4 T5-XXL in both): a
     warm-up and a timed pass, the painted depths and the images
     bitwise equal between them, the spans of both backends, each
     sampler step's time (CUDA events: the first, then the replays) and
     each paint's, the weight bytes, the pass's peak memory and the
     memory after each release(), CD/EMD and the K1-K5 launches; then
     one sampler step over FLUX_OBJECTS objects of the FLUX MMDiT in bf16
     and int8
     and of the Qwen MMDiT in int4, each as a graph replay, with its
     FLOPs over its time against the bf16 peak, its peak memory and its
     weight bytes.
  9. BASELINE config 5 and the rest of its slice: RMBGMatting, the
     TRELLIS and SF3D backends and the DDNM inpainter at their tiny
     presets on the host and on the card with one state dict and the
     same draws (the matte and the DDNM paint within GEN_IMAGE_TOL, the
     paint's known pixels exact; TRELLIS's occupancy, SDF volume and
     voxel colours and SF3D's SDF grid and vertex colours within
     IM_SDF_TOL), the cv2 inpainter through batched_stage1 on both
     devices (the stage-1 arrays bitwise equal), trellis_2 from the
     registry on the card; the parameter counts on the meta device
     against the reference's; then run_batched_lidar over CONFIG5_SCANS
     generated CAR scan(s) at configs/lidar.yaml's values with a
     60-degree held-out wedge, as the reference deploys config 5: FLUX
     (int4) generates the image at 512², RMBG-2.0 (Swin-v1-Large) mattes
     it at 1024², TRELLIS (25 steps in each flow, a 128³ SDF volume)
     lifts it to a mesh, then registration and fusion; a warm-up and a
     timed pass, the images, mattes and SDF volumes bitwise equal
     between them, the spans of each backend, each TRELLIS flow loop's
     time (CUDA events), the peak memory and the memory after each
     release(), the meshes' sizes, UHD and held-out UHD finite, the
     K1-K5 launches; then, outside the pass at full width, one TRELLIS
     structure and SLAT flow step as graph replays and one RMBG forward
     (times, FLOPs against the bf16 peak), SF3DBackend over the pass's
     matted image (the device program's time, the 96³ marching, the
     mesh) and one DDNM paint of the pass's stage-1 depth at res² (50
     steps: a step's time and FLOPs, the known pixels exact).  One scan:
     the pass was sized for the host marching of a random-weight 128³
     volume (tens of seconds a pass); the marching now runs on the card
     (bitwise equal to the host's, held in this phase), and one scan
     keeps the whole script within its time limit.
 10. the multi-device path (one process drives every shard,
     genpc_tpu_torch/parallel/mesh.py) and the last toolkit modules:
     run_batched over the 13 objects with cfg.mesh_shape, the aligned
     path at dp = 4 (padded to 16) and the registration path at dp = 2
     (padded to 14), every shard on cuda:0 (and, on a machine with two or
     more cards, the registration path over cuda:0 and cuda:1): one pass
     each, its launches counted under mesh_aligned / mesh_registration,
     each object's CD×100 / EMD×100 within MESH_TOL of phase 4's unsharded
     pass (max |d| and bitwise equality printed); make_mesh and its
     error; evaluate_pair at 16,384 points with sp = 4 and
     sharded_chamfer_l1 at 16,384 × 16,384 against the unsharded chamfer
     (1e-5); the tp = 2 tiny MMDiT forward against the unsharded one
     (1e-5); batched_pose_step at dp = 4 over 8 objects, card against
     host; the footprint-scatter renderer at the pose size (224², N =
     2,048, footprint 3) card against host, its deterministic sums
     repeating bitwise, its times against the slots renderer's K4/K5; and
     card against host for apml_loss, eval_sh, the morphology, edge and
     bilateral filters and SSIM at 1024², densify and estimate_normals at
     16,384 points and poisson_reconstruct at 96³.  Phase 3 checks the
     kernels at the mesh passes' shard classes (K1/K3 at B = 4 and 7, K2
     at 4 and 7 clouds, K4/K5 at R = 28, K1 at a shard of the sp = 4
     chamfer).

Cut for the time limit (1,200 s, the kernels' build included), when
phase 8 came: config 4 runs over CONFIG4_OBJECTS = 1 object (was 3), the
Waymo passes over LIDAR_SCANS = 4 scans a category (was 8), and the
image-to-3D pass over IM_OBJECTS = 2 objects (was 3), phase 3 checking
the kernels at the launch classes these give.  No path was dropped and
no kernel check weakened.  Phase 9 came with no further cut.  When
phase 10 came (1,132 s in all): the FLUX pass runs over FLUX_OBJECTS =
7 objects (was 13; its launch classes are then those of phase 10's
registration shards, plus its symmetry sweep's and fusion's, held in
phase 3) and the per-object pass over PER_OBJECT_FLAGS = 2 (was 3).

The second-to-last line is a JSON object with one entry per kernel (its
launches in the batched registration pass, and by path); the last line
is ``{"ok": true, "device": {...}}``.  The script imports no JAX.  It
exits non-zero without a CUDA device, and when run from a directory
that does not hold the genpc_tpu_torch package.
"""

from __future__ import annotations

import inspect
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3
FP32_FLOPS = 67e12             # H100 SXM fp32 outside the tensor cores
SLEEP_CYCLES = 4_000_000       # ~2 ms at the H100's 1.98 GHz boost clock


def log(msg: str) -> None:
    print(msg, flush=True)


def _with_spans(fn):
    """fn() inside a span recorder (``tracing.recording``): (its result,
    {span: seconds, "span:counter": count})."""
    from genpc_tpu_torch.tracing import recording
    with recording() as rec:
        out = fn()
    return out, rec.flat()


def cuda_ms(fn, reps: int = 3) -> float:
    """Median device time of fn() in ms: one warm-up, then reps timed runs.
    Each run is enqueued behind a device sleep of about 2 ms, so that the
    host's enqueue of fn (a wrapper's checks and allocations take tens of
    microseconds) finishes before the card reaches the start event: the
    interval holds the device's work, and host time only where fn makes
    the card wait for the host again (the many launches of a plain
    version)."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(n_bytes: float, flops: float) -> dict:
    """The least time for the work: bytes moved once at the memory rate or
    fp32 operations at the peak rate, whichever is larger."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def fail(msg: str) -> None:
    raise SystemExit(f"FAILED: {msg}")


# ------------------------------------------------------------ phase 3 ---

#: objects of the image-to-3D pass (phase 6): a random-weight mesh has
#: millions of faces, whose marching took tens of seconds an object a
#: pass while it ran on the host, so the pass runs over the first
#: IM_OBJECTS of the 13 objects (cut for the time limit, from 3 to 2 when
#: phase 8 came; widths, steps and grid unchanged; the marching now runs
#: on the card in a fraction of a second).  Its launch classes at
#: B = IM_OBJECTS are checked here.
IM_OBJECTS = 2
#: objects of BASELINE config 4's pass in phase 7 (Qwen-Image-Edit, then
#: InstantMesh): one (cut from 3 for the time limit when phase 8 came,
#: when the marching of a shattered random-weight mesh took ~24 s an
#: object on the host).
#: Its launch classes are one object's (below: the per-object pass's,
#: and "fine_c4")
CONFIG4_OBJECTS = 1
#: scans a category in the Waymo passes of phase 4 (bench_waymo.py takes
#: 20: cut for the time limit, to 8 and then, when phase 8 came, to 4)
LIDAR_SCANS = 4

#: K1 launch classes of the registration pass: name, (B, N, M), and the
#: number of y batches x shares through y_index (0: one y per x batch).
#: From the launch-shape histogram of phase 4: the metric (both
#: directions), the per-object dedup (completion samples against the
#: input partial), the mirror dedup of the symmetry completion, the
#: symmetry sweep (13 objects x 24 azimuths x 13 offsets) and its fine
#: sweep (x 9 azimuths), the fine scale grid (13 x 250 candidates), the
#: coarse ICP (13 x 11 scales), the final refine and fine-grid ICP (13),
#: the pose loss (52 renders, 512 and 2,048 points).
K1_SHAPES = [
    ("metric", (13, 16384, 16384), 0),
    ("dedup", (1, 163840, 65536), 0),
    ("mirror", (1, 65536, 65536), 0),
    ("sweep", (4056, 4096, 4096), 13),
    ("sweep_fine", (1521, 4096, 4096), 13),
    ("fine", (3250, 2048, 2048), 13),
    ("icp", (143, 2048, 2048), 13),
    ("refine", (13, 2048, 2048), 0),
    ("pose_512", (52, 512, 512), 13),
    ("pose_2048", (52, 2048, 2048), 13),
    # one object (run_pipeline, run_lidar): the metric, the symmetry sweep
    # (24 azimuths x 13 offsets) and its fine sweep (x 9), a chunk of the
    # fine grid (125 candidates), the coarse ICP (11 scales), the final
    # refine, the pose loss (4 renders)
    ("metric_1", (1, 16384, 16384), 0),
    ("sweep_1", (312, 4096, 4096), 1),
    ("sweep_fine_1", (117, 4096, 4096), 1),
    ("fine_1", (125, 2048, 2048), 1),
    ("icp_1", (11, 2048, 2048), 1),
    ("refine_1", (1, 2048, 2048), 0),
    ("pose1_512", (4, 512, 512), 1),
    ("pose1_2048", (4, 2048, 2048), 1),
    # run_batched_lidar over LIDAR_SCANS scans: the registration classes
    # at B = LIDAR_SCANS (the sweeps, 250 fine candidates and 11 coarse ICP
    # problems a scan, the refine, 4 pose renders a scan), each partial
    # against its fused cloud (padded by repetition to the longest), and
    # the held-out wedges
    ("sweep_lidar", (312 * LIDAR_SCANS, 4096, 4096), LIDAR_SCANS),
    ("sweep_fine_lidar", (117 * LIDAR_SCANS, 4096, 4096), LIDAR_SCANS),
    ("fine_lidar", (250 * LIDAR_SCANS, 2048, 2048), LIDAR_SCANS),
    ("icp_lidar", (11 * LIDAR_SCANS, 2048, 2048), LIDAR_SCANS),
    ("refine_lidar", (LIDAR_SCANS, 2048, 2048), 0),
    ("pose_lidar_512", (4 * LIDAR_SCANS, 512, 512), LIDAR_SCANS),
    ("pose_lidar_2048", (4 * LIDAR_SCANS, 2048, 2048), LIDAR_SCANS),
    ("uhd", (LIDAR_SCANS, 65536, 20000), 0),
    ("holdout", (LIDAR_SCANS, 1400, 20000), 0),
    # run_lidar: one scan's UHD
    ("uhd_1", (1, 65536, 20000), 0),
    # the image-to-3D pass over IM_OBJECTS objects (a mesh gets no
    # symmetry sweep): the metric, the fine grid (250 candidates an
    # object), the coarse ICP (11 scales), the final refine, the pose
    # loss (4 renders an object)
    ("metric_im", (IM_OBJECTS, 16384, 16384), 0),
    ("fine_im", (250 * IM_OBJECTS, 2048, 2048), IM_OBJECTS),
    ("icp_im", (11 * IM_OBJECTS, 2048, 2048), IM_OBJECTS),
    ("refine_im", (IM_OBJECTS, 2048, 2048), 0),
    ("pose_im_512", (4 * IM_OBJECTS, 512, 512), IM_OBJECTS),
    ("pose_im_2048", (4 * IM_OBJECTS, 2048, 2048), IM_OBJECTS),
    # config 4 over CONFIG4_OBJECTS: the batched fine grid (250 candidates
    # an object; the other classes are the per-object pass's)
    ("fine_c4", (250 * CONFIG4_OBJECTS, 2048, 2048), CONFIG4_OBJECTS),
    # config 5 over one scan (phase 9): its UHD and held-out UHD against
    # the fused cloud the outlier mask left (the others are the
    # per-object pass's and config 4's: the dedup, fine grid, ICP,
    # refine and pose classes at one object)
    ("uhd_c5", (1, 65536, 19612), 0),
    ("holdout_c5", (1, 935, 19612), 0),
    # the mesh passes of phase 10 (the dp shards: 4 of the aligned pass's
    # 16 objects, 7 of the registration pass's 14; the symmetry sweeps run
    # over the 13 real objects): the metric and the registration classes
    # at a shard's B, and a shard of the sp = 4 chamfer
    ("metric_dp4", (4, 16384, 16384), 0),
    ("metric_dp2", (7, 16384, 16384), 0),
    ("fine_dp2", (250 * 7, 2048, 2048), 7),
    ("icp_dp2", (11 * 7, 2048, 2048), 7),
    ("refine_dp2", (7, 2048, 2048), 0),
    ("pose_dp2_512", (28, 512, 512), 7),
    ("pose_dp2_2048", (28, 2048, 2048), 7),
    ("sp4", (1, 4096, 16384), 0),
    # the FLUX pass over FLUX_OBJECTS = 7 objects: its symmetry sweeps (its
    # other classes are the registration shards' above)
    ("sweep_7", (312 * 7, 4096, 4096), 7),
    ("sweep_fine_7", (117 * 7, 4096, 4096), 7),
]
K3_SHAPE = (13, 16384, 16384)
#: K3 for one object (the per-object metric) and for the image-to-3D pass
K3_SHAPE_1 = (1, 16384, 16384)
K3_SHAPE_IM = (IM_OBJECTS, 16384, 16384)
#: K3 at the dp shards of phase 10's mesh passes
K3_SHAPES_DP = ((4, 16384, 16384), (7, 16384, 16384))


def k1_inputs(dev, shape, shared, seed=0):
    """Seeded x [B,N,3], y and y_index (None when shared == 0)."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    b, n, m = shape
    by = shared or b
    x = torch.tensor(r.random((b, n, 3), dtype=np.float32), device=dev)
    y = torch.tensor(r.random((by, m, 3), dtype=np.float32), device=dev)
    yi = (torch.tensor(np.arange(b) * by // b, dtype=torch.int32, device=dev)
          if shared else None)
    return x, y, yi


def k3_inputs(dev, shape=K3_SHAPE, seed=2):
    """Seeded sources, targets and prices (uniform in [0, 0.1))."""
    import numpy as np
    import torch
    r = np.random.default_rng(seed)
    b, n, m = shape
    x1 = torch.tensor(r.random((b, n, 3), dtype=np.float32), device=dev)
    x2 = torch.tensor(r.random((b, m, 3), dtype=np.float32), device=dev)
    pr = torch.tensor(r.random((b, m), dtype=np.float32) * 0.1, device=dev)
    return x1, x2, pr


def _chunks(b, n, m, elems=1 << 28):
    """(batch slice, row slice) pieces of a [b, n, m] pair matrix, each of
    at most ~elems pairs."""
    rows = max(1, min(n, elems // m))
    objs = max(1, min(b, elems // (rows * m)))
    for b0 in range(0, b, objs):
        for r0 in range(0, n, rows):
            yield slice(b0, b0 + objs), slice(r0, r0 + rows)


def _y_of(y, yi, bs):
    return y[bs] if yi is None else y[yi[bs].long()]


def first_argmin(x, y, yi):
    """The exact first-index argmin of every x row (the direct fp32 form)
    and the rows that attain their minimum more than once."""
    import torch
    from genpc_tpu_torch.ops.chamfer import _sq_dist
    b, n, _ = x.shape
    m = y.shape[1]
    cols = torch.arange(m, device=x.device)
    first = torch.empty((b, n), dtype=torch.int64, device=x.device)
    tied = torch.empty((b, n), dtype=torch.bool, device=x.device)
    for bs, rs in _chunks(b, n, m, 1 << 26):
        d = _sq_dist(x[bs, rs], _y_of(y, yi, bs))
        eq = d == d.amin(dim=2, keepdim=True)
        first[bs, rs] = torch.where(eq, cols, m).amin(dim=2)
        tied[bs, rs] = eq.sum(dim=2) > 1
    return first, tied


def cdist_min(x, y, yi):
    """The library yardstick of K1: torch.cdist + min, in pieces of at
    most 2^28 pairs (a [13,16384,16384] matrix alone is 14 GB)."""
    import torch
    b, n, _ = x.shape
    dist = torch.empty((b, n), device=x.device)
    idx = torch.empty((b, n), dtype=torch.int64, device=x.device)
    for bs, rs in _chunks(b, n, y.shape[1]):
        dist[bs, rs], idx[bs, rs] = torch.cdist(
            x[bs, rs], _y_of(y, yi, bs)).min(dim=2)
    return dist, idx


def check_k1(dev):
    """K1 (chamfer NN) against its plain version at every launch class of
    the registration pass: distances bit-equal, every argmin the exact
    first index, and equal to the plain version's wherever the minimum is
    unique (torch's CUDA min does not promise the first index on ties).
    Returns the metric class's numbers, and every class's by name."""
    import torch
    from genpc_tpu_torch.ops.chamfer import _nn, _nn_plain, nn_plan
    x, y, _ = k1_inputs(dev, (2, 300, 500), 0)
    dk, ik = _nn(x, y)
    dp, ip = _nn_plain(x, y)
    torch.cuda.synchronize()
    if not (torch.equal(ik, ip) and torch.equal(dk, dp)):
        fail("K1 small: kernel differs from the plain version")
    out = {}
    for name, shape, shared in K1_SHAPES:
        x, y, yi = k1_inputs(dev, shape, shared, seed=len(out))
        plan = nn_plan(*shape)
        dk, ik = _nn(x, y, yi)
        dp, ip = _nn_plain(x, y, yi)
        first, tied = first_argmin(x, y, yi)
        torch.cuda.synchronize()
        exact = torch.equal(dk, dp)
        lowest = torch.equal(ik.long(), first)
        unique_agree = bool(((ik == ip) | tied).all())
        ties, differ = int(tied.sum()), int((ik != ip).sum())
        log(f"K1 {name} {shape}{' y_index' if shared else ''}: plan "
            f"rows {plan['rows']} threads {plan['threads']} splits "
            f"{plan['splits']} ({plan['blocks']} blocks); distances "
            f"bit-equal: {exact}; argmin the first index: {lowest}; "
            f"{ties} rows with tied minima; {differ} indices differ from "
            f"the plain version's, all on tied rows: {unique_agree}")
        if not (exact and lowest and unique_agree):
            fail(f"K1 {name}: not bit-equal / not the first index")
        b, n, m = shape
        ms = cuda_ms(lambda: _nn(x, y, yi), reps=5)
        plain_ms = cuda_ms(lambda: _nn_plain(x, y, yi), reps=1)
        library_ms = cuda_ms(lambda: cdist_min(x, y, yi), reps=1)
        # 3 sub + 3 mul + 2 add per pair; x, y read, dist and idx written
        bd = bound(nbytes(x, y, dk, ik), 8.0 * b * n * m)
        log(f"K1 time {name}: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"cdist+min {library_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
            f"({bd['bound_by']})")
        out[name] = {"max_abs_err": (dk - dp).abs().max().item(), "ms": ms,
                     "plain_ms": plain_ms, "library_ms": library_ms, **bd}
        del x, y, yi, dk, ik, dp, ip, first
        torch.cuda.empty_cache()
    return out["metric"], out


def check_k2(dev, small=(2, 1000, 256), metric=(13, 163840, 16384),
             fusion=(13, 229376, 20000), seed=1):
    """K2 (FPS) against its plain version: the exact sequence at a small
    shape, at the metric's ([13,163840] -> 16,384), at the fusion's (13
    clouds of the fusion's sizes, up to 65,536 partial + 163,840
    completion points, padded by repetition as ``fuse_clouds_batched``
    pads them, -> 20,000), at a 13-object pass's stage 1, metric
    prediction and pose subsample and the Qwen and FLUX passes' fusions,
    at one
    object's stage 1, metric (GT and prediction), fusion and pose
    subsample, at the same over the
    image-to-3D pass's IM_OBJECTS objects, at the Waymo stage 1 and
    fusion (LIDAR_SCANS scans, the fusion's clouds ragged) and at the PED
    shape
    (65,536 points drawn with replacement from 400, -> 10,000: after 400
    picks every minimum distance is 0, a tie at every pick).  Returns the
    metric shape's numbers and every shape's by name."""
    import numpy as np
    import torch
    from genpc_tpu_torch.ops.fps import pad_repeat
    from genpc_tpu_torch.ops.fps_kernel import (
        _launch, active_clusters, fps_batched, fps_batched_plain, fps_plan)
    r = np.random.default_rng(seed)
    b, n, k = small
    p = torch.tensor(r.uniform(-1, 1, (b, n, 3)), dtype=torch.float32,
                     device=dev)
    if not torch.equal(fps_batched(p, k), fps_batched_plain(p, k)):
        fail("K2 small: sequence differs from the plain version")
    b, n, _ = fusion
    fusion_sizes = n - r.integers(0, 32768, b)
    fusion_sizes[0] = n
    lidar_sizes = 108925 - r.integers(0, 20000, LIDAR_SCANS)
    lidar_sizes[0] = 108925
    shapes = {"metric": ([metric[1]] * metric[0], metric[2]),
              "fusion": (fusion_sizes.tolist(), fusion[2]),
              "stage1_1": ([65536], 10000), "metric_1": ([163840], 16384),
              "metric_pred_1": ([19728], 16384),
              "fusion_1": ([125719], 20000), "pose_1": ([2048], 512),
              "stage1_lidar": ([65536] * LIDAR_SCANS, 10000),
              "fusion_lidar": (lidar_sizes.tolist(), 20000),
              "ped": (None, 10000)}
    # the image-to-3D pass over IM_OBJECTS objects: stage 1, the metric
    # (GT, and the prediction's clouds of up to 19,514 points), the fusion
    # (each partial with the 163,840 points sampled from its mesh, up to
    # 218,361) and the pose subsample; sizes from their own draw, so that
    # the classes above keep their clouds
    ri = np.random.default_rng(seed + 1)
    pred_sizes = 19514 - ri.integers(0, 4000, IM_OBJECTS)
    pred_sizes[0] = 19514
    im_fusion_sizes = 218361 - ri.integers(0, 32768, IM_OBJECTS)
    im_fusion_sizes[0] = 218361
    # config 4's fusion over one object: its partial with the 163,840
    # points sampled from its mesh
    shapes["fusion_c4"] = ([219388] * CONFIG4_OBJECTS, 20000)
    shapes.update({"stage1_im": ([65536] * IM_OBJECTS, 10000),
                   "metric_im": ([163840] * IM_OBJECTS, 16384),
                   "metric_pred_im": (pred_sizes.tolist(), 16384),
                   "fusion_im": (im_fusion_sizes.tolist(), 20000),
                   "pose_im": ([2048] * IM_OBJECTS, 512)})
    # the other launches of a 13-object pass: stage 1, the metric's
    # prediction side (clouds of up to 19,765 points), the pose subsample,
    # and the fusion of the Qwen pass (phase 7), whose completions leave
    # clouds of up to 126,300 points (a smaller cluster than the fusion
    # above); from their own draw
    rq = np.random.default_rng(seed + 2)
    q_pred = 19765 - rq.integers(0, 4000, 13)
    q_pred[0] = 19765
    q_fusion = 126300 - rq.integers(0, 32768, 13)
    q_fusion[0] = 126300
    shapes.update({"stage1": ([65536] * 13, 10000),
                   "metric_pred": (q_pred.tolist(), 16384),
                   "pose": ([2048] * 13, 512),
                   "fusion_qwen": (q_fusion.tolist(), 20000)})
    # the fusion of the FLUX pass (phase 8): clouds of up to 140,394
    # points, from their own draw
    rf = np.random.default_rng(seed + 3)
    f_fusion = 140394 - rf.integers(0, 32768, FLUX_OBJECTS)
    f_fusion[0] = 140394
    shapes["fusion_flux"] = (f_fusion.tolist(), 20000)
    # config 5's fusion over one scan (phase 9): its partial with the
    # 163,840 points sampled from its TRELLIS mesh
    shapes["fusion_c5"] = ([226852], 20000)
    # the dp shards of phase 10's mesh passes (4 objects a shard on the
    # aligned path, 7 on the registration path): stage 1, the metric's GT
    # and prediction sides, the fusion and the pose subsample; from their
    # own draw.  One plain run each, timed by events (the plain version
    # takes seconds at these shapes), and no half-cluster timing.
    rm = np.random.default_rng(seed + 4)
    for b_dp in (4, 7):
        m_pred = 19765 - rm.integers(0, 4000, b_dp)
        m_pred[0] = 19765
        m_fus = fusion[1] - rm.integers(0, 32768, b_dp)
        m_fus[0] = fusion[1]
        shapes.update({f"stage1_dp{b_dp}": ([65536] * b_dp, 10000),
                       f"metric_dp{b_dp}": ([163840] * b_dp, 16384),
                       f"metric_pred_dp{b_dp}": (m_pred.tolist(), 16384),
                       f"fusion_dp{b_dp}": (m_fus.tolist(), 20000)})
    shapes["pose_dp7"] = ([2048] * 7, 512)
    # the aligned path's fusion over a dp = 4 shard: clouds of up to
    # 126,458 points (phase 4's aligned pass)
    m_al = 126458 - rm.integers(0, 32768, 4)
    m_al[0] = 126458
    shapes["fusion_aligned_dp4"] = (m_al.tolist(), 20000)
    out = {}
    for name, (sizes, k) in shapes.items():
        if sizes is None:
            base = r.uniform(-0.5, 0.5, (400, 3))
            clouds = [base[r.choice(400, 65536, replace=True)]]
            sizes = [400]       # the unique points: the real work
        else:
            clouds = [r.uniform(-0.5, 0.5, (m, 3)) for m in sizes]
        p = torch.tensor(pad_repeat(clouds), dtype=torch.float32, device=dev)
        b, n, _ = p.shape
        plan = fps_plan(n)
        active = active_clusters(dev.index or 0, plan["cluster"],
                                 plan["ppt"])
        quick = "_dp" in name
        ik = fps_batched(p, k)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        ip = fps_batched_plain(p, k)
        end.record()
        torch.cuda.synchronize()
        exact = torch.equal(ik, ip)
        rows = torch.arange(b, device=dev)[:, None]
        err = (p[rows, ik.long()] - p[rows, ip.long()]).abs().max().item()
        log(f"K2 fps {name} [{b},{n}] -> {k} (clouds of {min(sizes)}-"
            f"{max(sizes)} points): C {plan['cluster']}, slice "
            f"{plan['slice']} ({plan['on_chip']} on-chip), "
            f"{active} clusters active at once; sequence equal to the "
            f"plain version: {exact}")
        if not exact:
            fail(f"K2 {name}: sequence differs from the plain version")
        ms = cuda_ms(lambda: fps_batched(p, k))
        plain_ms = start.elapsed_time(end) if quick else \
            cuda_ms(lambda: fps_batched_plain(p, k))
        # each of the k-1 picks updates every real point's distance (8
        # flops); the real points read once, the indices written once (at
        # the PED shape the 400 unique points are the real work)
        real = sum(sizes)
        bd = bound(real * 12 + nbytes(ik), 8.0 * real * (k - 1))
        log(f"K2 time {name}: kernel {ms:.3f} ms ({ms / (k - 1) * 1e3:.3f} "
            f"us a pick), plain {plain_ms:.3f} ms, bound "
            f"{bd['bound_ms']:.4f} ms ({bd['bound_by']}); no library call")
        # the trade the plan makes: half the cluster fits twice as many
        # objects on the card at once, but streams part of each slice
        half = max(1, plan["cluster"] // 2)
        alt = fps_plan(n, half)
        if not quick:
            alt_ms = cuda_ms(lambda: _launch(p, k, 0, alt))
            log(f"K2 time {name} at C {half} (slice {alt['slice']}, "
                f"{alt['on_chip']} on-chip, "
                f"{active_clusters(dev.index or 0, half, alt['ppt'])} "
                f"clusters active at once): {alt_ms:.3f} ms")
        out[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": None, **bd}
        del p, ik, ip
        torch.cuda.empty_cache()
    return out["metric"], out


def topk_yardstick(x1, x2, pr):
    """The library yardstick of K3: (3 - cdist - price).topk(2) in row
    pieces of at most 2^28 pairs."""
    import torch
    b, n, _ = x1.shape
    vals = torch.empty((b, n, 2), device=x1.device)
    idx = torch.empty((b, n, 2), dtype=torch.int64, device=x1.device)
    for bs, rs in _chunks(b, n, x2.shape[1]):
        vals[bs, rs], idx[bs, rs] = (3.0 - torch.cdist(x1[bs, rs], x2[bs])
                                     - pr[bs, None]).topk(2, dim=2)
    return vals, idx


def check_k3(dev, shape=K3_SHAPE):
    """K3 (EMD bid phase): bitwise equal to bid_plain_direct (the same
    function in the same fp32 order) and within the reference contract of
    bid_plain (the reference's XLA expansion: >= 99.5 % identical bids,
    values within 2e-4)."""
    import torch
    from genpc_tpu_torch.ops.emd_kernel import (bid, bid_plain,
                                                bid_plain_direct, bid_plan,
                                                spatial_order)
    x1, x2, pr = k3_inputs(dev, shape)
    b, n, m = shape
    plan = bid_plan(b, n, m)
    order = spatial_order(x1)
    out_k = bid(x1, x2, pr, order=order)
    out_u = bid(x1, x2, pr)
    out_d = bid_plain_direct(x1, x2, pr)
    out_p = bid_plain(x1, x2, pr)
    torch.cuda.synchronize()
    bitwise = all(torch.equal(k, d) and torch.equal(u, d)
                  for k, u, d in zip(out_k, out_u, out_d))
    frac = (out_k[0] == out_p[0]).float().mean().item()
    err = max((out_k[1] - out_p[1]).abs().max().item(),
              (out_k[2] - out_p[2]).abs().max().item())
    log(f"K3 emd_bid {shape}: plan rows {plan['rows']} threads "
        f"{plan['threads']} ({plan['blocks']} blocks); bitwise equal to "
        f"bid_plain_direct, with the auction's spatial row order and "
        f"without: {bitwise}; against bid_plain: bid agreement "
        f"{frac:.6f}, max |best|,|better| err {err:.3e}")
    if not bitwise:
        fail("K3: not bitwise equal to bid_plain_direct")
    if frac < 0.995 or err > 2e-4:
        fail("K3: below the 99.5% / 2e-4 contract against bid_plain")
    ms = cuda_ms(lambda: bid(x1, x2, pr, order=order), reps=5)
    unordered_ms = cuda_ms(lambda: bid(x1, x2, pr), reps=5)
    plain_ms = cuda_ms(lambda: bid_plain_direct(x1, x2, pr), reps=1)
    xla_ms = cuda_ms(lambda: bid_plain(x1, x2, pr), reps=1)
    library_ms = cuda_ms(lambda: topk_yardstick(x1, x2, pr), reps=1)
    # the distance, 8 fp32 ops a pair: what every pair needs once the
    # filter leaves the root and the subtractions to the few pairs that
    # can enter the top two
    bd = bound(nbytes(x1, x2, pr, *out_k), 8.0 * b * n * m)
    log(f"K3 time {shape}: kernel {ms:.3f} ms (rows in the caller's order: "
        f"{unordered_ms:.3f} ms), plain (direct) {plain_ms:.3f} ms, "
        f"plain (expansion) {xla_ms:.3f} ms, (3 - cdist - price).topk(2) "
        f"{library_ms:.3f} ms, bound {bd['bound_ms']:.4f} ms "
        f"({bd['bound_by']})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, **bd}


#: K6's launch classes (rows M, in K, out N, compute dtype): the FLUX
#: MMDiT's int4 block matmuls (attention projections, MLP in and out, the
#: single blocks' output projection) at a paint's image and text streams
#: and single blocks (256, 512, 768 rows) and the B = 3 generation's
#: (3,072, 1,536, 4,608); the fp32 AdaLN modulations at B = 1 and 3;
#: T5-XXL at 512 tokens; Qwen2.5-VL's vision MLP (K or N 3,420: ragged)
K6_CLASSES = (
    [(m, k, n, "bf16") for k, n in ((3072, 3072), (3072, 12288),
                                    (12288, 3072), (15360, 3072))
     for m in (256, 512, 768, 1536, 3072, 4608)]
    + [(m, 3072, n, "fp32") for n in (18432, 9216) for m in (1, 3)]
    + [(512, k, n, "bf16") for k, n in ((4096, 4096), (4096, 10240),
                                       (10240, 4096))]
    + [(1000, 1280, 3420, "bf16"), (1000, 3420, 1280, "bf16")])
#: the card's dense bf16 tensor-core peak (H100 SXM data sheet)
BF16_TC_FLOPS = 989.4e12


def check_k6(dev, classes=K6_CLASSES):
    """K6 (int4 weight-only matmul) against its plain twin at every launch
    class: bf16 outputs within one bf16 ulp of the plain result, or within
    the fp32 summation bound (4·K·2^-24·Σ|x c|·scale) of it where that
    result is itself within the bound of 0; fp32 outputs within that
    bound.  Times: the kernel, the plain twin, and as the library's
    yardstick cuBLAS on the weight dequantised beforehand (timed here
    only: the port never calls it); the bound is 2MNK flops at the bf16
    tensor-core peak on the tensor-core path, the packed weight's N·K/2
    bytes at the memory rate on the CUDA-core path (fp32)."""
    import torch
    from genpc_tpu_torch.models.quant import (_scale_bias, matmul_f32,
                                              pack_int4, unpack_int4,
                                              w4_linear, w4_linear_plain)
    out = []
    for m, k, n, dt in classes:
        dtype = torch.float32 if dt == "fp32" else torch.bfloat16
        g = torch.Generator(device=dev).manual_seed(m + k + n)
        x = torch.randn((m, k), generator=g, device=dev).to(dtype)
        w = pack_int4(torch.randint(-7, 8, (n, k), generator=g, device=dev,
                                    dtype=torch.int8))
        scale = torch.rand(n, generator=g, device=dev) * 2e-3 + 1e-4
        bias = torch.randn(n, generator=g, device=dev) * 0.1
        got = w4_linear(x, w, scale, bias)
        y32 = _scale_bias(matmul_f32(x, unpack_int4(w, dtype)), scale, bias)
        sabs = (x.float().abs() @ unpack_int4(w, torch.float32).abs().T) \
            * scale
        tol = 4 * k * 2.0 ** -24 * sabs + 2 * 2.0 ** -24 * y32.abs()
        diff = (got.float() - y32.to(dtype).float()).abs()
        if dtype == torch.float32:
            ok = diff <= tol
        else:
            _, e = torch.frexp(torch.maximum(got.float().abs(),
                                             y32.to(dtype).float().abs()))
            ulp = torch.ldexp(torch.ones_like(diff), e - 8)
            ok = (diff <= ulp) | ((y32.abs() <= tol) & (diff <= tol + ulp))
        bad = int((~ok).sum())
        del sabs, tol, y32
        ms = cuda_ms(lambda: w4_linear(x, w, scale, bias), reps=5)
        plain_ms = cuda_ms(lambda: w4_linear_plain(x, w, scale, bias),
                           reps=3)
        wd = unpack_int4(w, dtype)
        library_ms = cuda_ms(lambda: torch.mm(x, wd.t()), reps=5)
        del wd
        core = dtype == torch.float32
        bound_ms = (n * k / 2 / HBM_BYTES_PER_S if core
                    else 2.0 * m * n * k / BF16_TC_FLOPS) * 1e3
        rec = {"shape": (m, k, n, dt), "path": "cuda_core" if core
               else "tensor_core", "max_abs_err": float(diff.max()),
               "outside": bad, "ms": ms, "plain_ms": plain_ms,
               "library_ms": library_ms, "bound_ms": bound_ms,
               "bound_by": "bytes" if core else "operations"}
        log(f"K6 w4_gemm M={m} K={k} N={n} {dt} ({rec['path']}): max |err| "
            f"{rec['max_abs_err']:.3e}, {bad} outside the tolerance; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, cuBLAS on the "
            f"dequantised weight {library_ms:.4f} ms, bound {bound_ms:.4f} "
            f"ms ({rec['bound_by']})")
        if bad:
            fail(f"K6 {rec['shape']}: {bad} outputs outside the tolerance")
        out.append(rec)
        del x, w, got, diff
        torch.cuda.empty_cache()
    return out


def _pose_tables(dev, res, n_pts, n_obj=13, seed=3):
    """Slot tables of the pose path: n_obj synthetic objects' completions
    (voxel 0.02, resampled to n_pts) under the 4 start rotations about y,
    R = 4 n_obj renders (52 batched, 4 for one object), built by the
    port's _build_table: (table, slot_orig, build order, points kept)."""
    import numpy as np
    import torch
    from genpc_tpu_torch.geometry.transforms import rotation_6d_to_matrix
    from genpc_tpu_torch.geometry.transforms import rot6d_from_axis_angle
    from genpc_tpu_torch.io.synthetic_data import make_object
    from genpc_tpu_torch.ops.voxel import voxel_down_sample
    from genpc_tpu_torch.pipeline.registration import resample_fixed
    from genpc_tpu_torch.render.point_renderer import (
        RenderCamera, _build_table, _project_attrs)
    clouds, cols = [], []
    for i in range(n_obj):
        _, _, gt, gt_rgb = make_object(seed + i, n_gt=40000)
        v, vc = voxel_down_sample(gt, 0.02, gt_rgb)
        v, vc = resample_fixed(v, n_pts, vc)
        clouds.append(v)
        cols.append(vc)
    pts = torch.tensor(np.stack(clouds), dtype=torch.float32, device=dev)
    col = torch.tensor(np.stack(cols), dtype=torch.float32, device=dev)
    R = rotation_6d_to_matrix(torch.stack(
        [rot6d_from_axis_angle("y", 90.0 * s, dev) for s in range(4)]))
    r = 4 * n_obj
    pts = torch.einsum("bnj,kij->bkni", pts, R).reshape(r, n_pts, 3)
    col = col[:, None].expand(n_obj, 4, n_pts, 3).reshape(r, n_pts, 3)
    attrs = _project_attrs(pts, 0.02 * (2048 / n_pts) ** 0.5,
                           RenderCamera.default(res), 2)
    # a checkout before the build order returned three values
    table, keep, slot_orig, *order = _build_table(*attrs[:4], col, attrs[4],
                                                  res, 2, 6)
    return table, slot_orig, (order or [None])[0], int(keep.sum())


def _full_table(dev, res, seed=5, r=52, f=2, slots=6):
    """A table with every entry of every slot present: centres within
    2f + 1 pixels of the entry's own, random depths, sigma2 in [0.05,
    2.05) and colours; slot_orig names every interior entry once."""
    import numpy as np
    import torch
    g = np.random.default_rng(seed)
    h = res + 2 * f
    t = g.random((r, slots, 7, h, h), dtype=np.float32)
    yy, xx = np.meshgrid(np.arange(h) - f, np.arange(h) - f, indexing="ij")
    t[:, :, 0] = xx + (t[:, :, 0] - 0.5) * (4 * f + 2)
    t[:, :, 1] = yy + (t[:, :, 1] - 0.5) * (4 * f + 2)
    t[:, :, 3] = 0.05 + 2.0 * t[:, :, 3]
    so = torch.arange(slots * res * res, device=dev)
    return torch.tensor(t, device=dev), so.expand(r, -1).contiguous()


def k5_bound(slot_orig, kept, res, f=2, slots=6):
    """K5's least work: each point's slot_orig read, each kept entry's 7
    channels read, 7 gradients a point written, and the 5 cotangent planes
    (g_acc, g_wacc, dmax) read at the pixels within f of a kept entry's
    pixel; ~30 flops a visit of each of the (2f+1)^2 offsets."""
    import torch
    r, n = slot_orig.shape
    npix = res * res
    occ = torch.zeros((r, slots * npix + 1), device=slot_orig.device)
    occ.scatter_(1, slot_orig.clamp_max(slots * npix), 1.0)
    occ = occ[:, :-1].reshape(r, slots, res, res).amax(1, keepdim=True)
    near = torch.nn.functional.max_pool2d(occ, 2 * f + 1, 1, f)
    n_bytes = r * n * (8 + 7 * 4) + kept * 7 * 4 + int(near.sum()) * 5 * 4
    return bound(n_bytes, 30.0 * (2 * f + 1) ** 2 * kept)


def check_k4_k5(dev, shapes=((224, 2048, 13), (112, 512, 13),
                            (224, 2048, 1), (112, 512, 1),
                            (224, 2048, LIDAR_SCANS),
                            (112, 512, LIDAR_SCANS),
                            (224, 2048, IM_OBJECTS), (112, 512, IM_OBJECTS),
                            (224, 2048, 7), (112, 512, 7)),
                seed=4):
    """K4 (splat forward) and K5 (splat backward, per point) against their
    plain versions at the pose path's shapes (R = 52 for 13 objects, R = 4
    for one, R = 4 LIDAR_SCANS for the Waymo scans, R = 4 IM_OBJECTS for the
    image-to-3D pass, R = 28 for a dp shard of phase 10's registration
    mesh pass; S = 6, f = 2, gamma 1e-2):
    bit-equal on the table _build_table returns (a view with render
    stride size + 1), on its
    contiguous copy and on a table with every entry present, and bitwise
    repeatable.  Times on the contiguous table, so that no copy is inside
    them.  Returns the main shape's numbers and prints all."""
    import numpy as np
    import torch
    from genpc_tpu_torch.render.splat_kernel import (
        assemble, assemble_bwd_points, assemble_bwd_points_plain,
        assemble_plain, splat_plan)
    out = {}
    g = np.random.default_rng(seed)

    def k4(t):
        return assemble(t, res, 2, 1e-2)

    def k5(t, so, dm, order=None):
        return assemble_bwd_points(t, so, cots, dm, res, 2, 6, 1e-2, order)

    def k5_plain(t, so, dm):
        return assemble_bwd_points_plain(t, so, cots, dm, res, 2, 6, 1e-2)

    def parity(name, t, so, order=None):
        (acc, wacc), dmax = k4(t)
        (acc_p, wacc_p), dmax_p = assemble_plain(t, res, 2, 1e-2)
        (acc2, wacc2), dmax2 = k4(t)
        d = k5(t, so, dmax, order)
        d_p = k5_plain(t, so, dmax)
        d2 = k5(t, so, dmax, order)
        d_caller = k5(t, so, dmax)
        torch.cuda.synchronize()
        err4 = max((acc - acc_p).abs().max().item(),
                   (wacc - wacc_p).abs().max().item(),
                   (dmax - dmax_p).abs().max().item())
        err5 = (d - d_p).abs().max().item()
        rep = (torch.equal(acc, acc2) and torch.equal(wacc, wacc2)
               and torch.equal(dmax, dmax2) and torch.equal(d, d2)
               and torch.equal(d, d_caller))
        log(f"K4/K5 res {res} R {t.shape[0]} {name}: K4 max err vs plain "
            f"{err4:.3e}, K5 {err5:.3e}; bitwise repeat (K5 also in the "
            f"caller's point order) {rep}")
        # the twins sum in the kernels' order with the same roundings:
        # the contract is bit-equality
        if err4 != 0.0 or err5 != 0.0 or not rep:
            fail(f"K4/K5 res {res} R {t.shape[0]} {name}: not bit-equal "
                 f"to the plain versions or not repeatable")
        return dmax, err4, err5

    for res, n_pts, n_obj in shapes:
        table, slot_orig, order, kept = _pose_tables(dev, res, n_pts, n_obj)
        r = table.shape[0]
        cots = (torch.tensor(g.normal(size=(r, 3, res, res)),
                             dtype=torch.float32, device=dev),
                torch.tensor(g.normal(size=(r, res, res)),
                             dtype=torch.float32, device=dev))
        plan = splat_plan(res, 2)
        log(f"K4/K5 res {res}, R {r}, {kept} of {r * n_pts} points in the "
            f"table; K4 plan: tiles {plan['tile_w']} x {plan['tile_h']}, "
            f"{plan['blocks']} a render, {plan['smem']} B of shared memory")
        dense = table.contiguous()
        dmax, err4, err5 = parity("strided view", table, slot_orig, order)
        parity("contiguous", dense, slot_orig, order)
        full, full_so = _full_table(dev, res, r=r)
        dmax_full = parity("every entry present", full, full_so)[0]
        ms4 = cuda_ms(lambda: k4(dense))
        plain4 = cuda_ms(lambda: assemble_plain(dense, res, 2, 1e-2))
        ms5 = cuda_ms(lambda: k5(dense, slot_orig, dmax, order))
        caller5 = cuda_ms(lambda: k5(dense, slot_orig, dmax))
        plain5 = cuda_ms(lambda: k5_plain(dense, slot_orig, dmax))
        full4 = cuda_ms(lambda: k4(full))
        full5 = cuda_ms(lambda: k5(full, full_so, dmax_full))
        # K4: operations, every present entry visited from its 25 window
        # pixels, ~30 flops per visit; bytes, what this table needs: the
        # sigma2 plane of every slot (it marks presence), the other 6
        # channels of the present entries only, each once, and the
        # outputs written once.  K5: k5_bound, per point
        (acc, wacc), _ = k4(dense)
        b4 = bound(nbytes(dense) // 7 + kept * 6 * 4
                   + nbytes(acc, wacc, dmax), 30.0 * 25 * kept)
        b5 = k5_bound(slot_orig, kept, res)
        log(f"K4 time res {res}, R {r} (contiguous table): kernel "
            f"{ms4:.4f} ms, "
            f"plain {plain4:.3f} ms, bound {b4['bound_ms']:.4f} ms "
            f"({b4['bound_by']}); K5 (per point): kernel {ms5:.4f} ms "
            f"(points in the caller's order {caller5:.4f} ms), "
            f"plain {plain5:.3f} ms, bound {b5['bound_ms']:.4f} ms "
            f"({b5['bound_by']}, per-point bytes); no library call for "
            f"either; every entry present: K4 {full4:.4f} ms, K5 "
            f"{full5:.4f} ms ({full_so.shape[1]} points a render)")
        out[res, r] = ({"max_abs_err": err4, "ms": ms4, "plain_ms": plain4,
                        "library_ms": None, **b4},
                       {"max_abs_err": err5, "ms": ms5, "plain_ms": plain5,
                        "library_ms": None, **b5})
        del table, dense, full, full_so, cots, order
        torch.cuda.empty_cache()
    main = out[shapes[0][0], 4 * shapes[0][2]]
    return {"splat_fwd": main[0], "splat_bwd": main[1]}


KERNELS = [
    # name, wrapper (module, attribute), source, replaced Pallas kernel
    ("chamfer_nn", ("genpc_tpu_torch.ops.chamfer", "_nn"),
     "genpc_tpu_torch/csrc/chamfer_nn.cu", "genpc_tpu/ops/chamfer.py:47"),
    ("fps", ("genpc_tpu_torch.ops.fps_kernel", "fps_batched"),
     "genpc_tpu_torch/csrc/fps.cu", "genpc_tpu/ops/fps_kernel.py:44"),
    ("emd_bid", ("genpc_tpu_torch.ops.emd_kernel", "bid"),
     "genpc_tpu_torch/csrc/emd_bid.cu", "genpc_tpu/ops/emd_kernel.py:48"),
    ("splat_fwd", ("genpc_tpu_torch.render.splat_kernel", "assemble"),
     "genpc_tpu_torch/csrc/splat.cu", "genpc_tpu/render/splat_kernel.py:77"),
    ("splat_bwd", ("genpc_tpu_torch.render.splat_kernel",
                   "assemble_bwd_points"),
     "genpc_tpu_torch/csrc/splat.cu",
     "genpc_tpu/render/splat_kernel.py:201"),
    # K6's two paths (its C entries), replacing no Pallas kernel
    ("w4_gemm", ("genpc_tpu_torch.models.quant", "_w4_gemm"),
     "genpc_tpu_torch/csrc/w4_gemm.cu", None),
    ("w4_gemv", ("genpc_tpu_torch.models.quant", "_w4_gemv"),
     "genpc_tpu_torch/csrc/w4_gemm.cu", None),
]
#: the point-cloud kernels, K1-K5
CLOUD = ("chamfer_nn", "fps", "emd_bid", "splat_fwd", "splat_bwd")
#: K6, on the paths with int4 layers: the FLUX MMDiT and T5 (the Qwen
#: paths run bf16 weights)
INT4 = ("w4_gemm", "w4_gemv")
#: the kernels each main path must launch (the Waymo paths score by UHD,
#: with no EMD)
PATH_KERNELS = {"aligned": ("chamfer_nn", "fps", "emd_bid"),
                "registration": CLOUD,
                "per_object": CLOUD,
                "lidar_car": ("chamfer_nn", "fps", "splat_fwd", "splat_bwd"),
                "lidar_ped": ("chamfer_nn", "fps", "splat_fwd", "splat_bwd"),
                "run_lidar": ("chamfer_nn", "fps", "splat_fwd", "splat_bwd"),
                "controlnet": CLOUD,
                "instantmesh": CLOUD,
                "qwen": CLOUD,
                "config4": CLOUD,
                "flux": CLOUD + INT4,
                "config5": ("chamfer_nn", "fps", "splat_fwd", "splat_bwd")
                + INT4,
                "mesh_aligned": ("chamfer_nn", "fps", "emd_bid"),
                "mesh_registration": CLOUD}
#: K2 launches in a timed pass: stage 1, the fusion tail (one launch over
#: all objects) and the metric's prediction side (the GT side is cached
#: from the warm-up), plus the pose path's two subsamples on registration
FPS_LAUNCHES = {"aligned": 3, "registration": 5}


def wrapper(spec):
    import importlib
    mod, attr = spec
    return getattr(importlib.import_module(mod), attr)


# ------------------------------------------------------------ phase 4 ---

#: configs/redwood.yaml and the Redwood protocol, as keyword overrides;
#: the pose and ICP settings are the config defaults (4 starts x 200 Adam
#: steps at 224², 2,048 points; ICP on 2,048 points, 11 coarse scales, a
#: 10³ fine grid, the anisotropic final refine)
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
    fused_points=256, metric_points=256, emd_eps=0.005,
    pose_complete_points=64, icp_points=64, pose_iters=3,
    pose_render_size=32, fine_scale_steps=2)

#: the registration steps whose card result is replayed on the host
REG_STEPS = ("batched_pose_optim", "batched_coarse_sweep",
             "batched_fine_search", "batched_similarity_refine")
#: card-vs-host tolerance of each replayed step's transforms: the same
#: algorithm on the same inputs, different roundings (expf vs the host's
#: exp, cuBLAS vs host BLAS sums, cuSOLVER vs LAPACK SVD)
REG_STEP_TOL = 1e-4


def _to(x, dev):
    if isinstance(x, (tuple, list)):
        return type(x)(_to(v, dev) for v in x)
    return x.to(dev) if hasattr(x, "to") and hasattr(x, "device") else x


def _np(x):
    import numpy as np
    return np.asarray(x.cpu() if hasattr(x, "cpu") else x)


def _arrays(x):
    """The numeric arrays in a step's arguments or result, in order."""
    import numpy as np
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _arrays(v)]
    if x is None or isinstance(x, (str, bool)):
        return []
    return [np.asarray(_np(x), np.float64)]


def _step_err(a, b) -> float:
    pairs = list(zip(_arrays(a), _arrays(b)))
    return max(float(abs(x.reshape(y.shape) - y).max()) for x, y in pairs)


class patched:
    """Set attributes (or dict items) for the duration of a with block:
    (owner, name, value) triples."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = []
        for owner, name, value in self.triples:
            if isinstance(owner, dict):
                self.saved.append((owner, name, owner[name]))
                owner[name] = value
            else:
                # the raw attribute: a class keeps its staticmethod
                self.saved.append((owner, name,
                                   inspect.getattr_static(owner, name)))
                setattr(owner, name, value)
        return self

    def __exit__(self, *exc):
        for owner, name, value in reversed(self.saved):
            if isinstance(owner, dict):
                owner[name] = value
            else:
                setattr(owner, name, value)


def _tape(fn, tape):
    """fn recording its results onto an empty tape, or replaying a full
    tape in call order without calling fn."""
    replay = list(tape)

    def call(*a, **k):
        if replay:
            return replay.pop(0)
        out = fn(*a, **k)
        tape.append(out)
        return out
    return call


def _recorded(calls, name, fn):
    def call(*a, **k):
        out = fn(*a, **k)
        calls.append((name, a, k, out))
        return out
    return call


def _hold_steps(label, calls, orig) -> None:
    """Replay each step the card ran on the host, from the same inputs;
    its transforms must agree within REG_STEP_TOL."""
    for name, a, k, out in calls:
        k = {kk: ("cpu" if kk == "device" else v) for kk, v in k.items()}
        host = orig[name](*_to(a, "cpu"), **k)
        err = _step_err(out, host)
        log(f"{label} {name}: card vs host on the same inputs, max |dT| "
            f"{err:.3e}")
        if err > REG_STEP_TOL:
            fail(f"{label} {name}: card and host disagree")


def small_input_check(tmp: str, seed: int) -> None:
    """Both paths at a tiny size, card against host (plain versions).

    Aligned path: per-object CD within 1e-5 (the NN is bit-equal on
    both); EMD within emd_eps absolute (the bid kernel uses the direct
    distance form and the plain version the expansion, so a near-tied
    bid can send the auction down another path; both ends are
    eps-optimal).  Registration path: every registration step the card
    ran is replayed on the host from the same inputs, and its transforms
    must agree within REG_STEP_TOL.  Its end-to-end CD/EMD gap is printed
    and held to no limit: between steps the host prep voxel-bins the
    moved clouds, so a rounding-level change of a transform can move a
    point across a voxel edge and resample another subset (ROADMAP
    queue 3), which moves CD by percents on a two-object input."""
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.io.synthetic_data import write_dataset
    from genpc_tpu_torch.parallel import batched_runner
    flags = ["01184", "05117"]
    root = os.path.join(tmp, f"tiny_{seed}")
    write_dataset(root, flags, seed=seed, n_gt=8192)
    for path, aligned in (("aligned", True), ("registration", False)):
        kw = dict(TINY, trust_aligned_completion=aligned)
        calls = []
        orig = {n: getattr(batched_runner, n) for n in REG_STEPS}
        with patched(*[(batched_runner, n, _recorded(calls, n, orig[n]))
                       for n in REG_STEPS]):
            got = batched_runner.run_batched(
                load_config(device="cuda", **kw), flags, root)
        ref = batched_runner.run_batched(load_config(device="cpu", **kw),
                                         flags, root)
        _hold_steps(f"small input seed {seed} {path}", calls, orig)
        for f in flags:
            dcd = abs(got[f]["cd"] - ref[f]["cd"])
            demd = abs(got[f]["emd"] - ref[f]["emd"])
            log(f"small input seed {seed} {path} {f}: cuda CD "
                f"{got[f]['cd']:.8f} EMD {got[f]['emd']:.7f} | cpu CD "
                f"{ref[f]['cd']:.8f} EMD {ref[f]['emd']:.7f} | |dCD| "
                f"{dcd:.3e} ({dcd / ref[f]['cd']:.4f} rel), |dEMD| "
                f"{demd:.3e} ({demd / ref[f]['emd']:.4f} rel)")
            if not all(map(math.isfinite, (got[f]["cd"], got[f]["emd"]))):
                fail(f"small input {path} {f}: non-finite CD/EMD")
            if aligned and not (dcd <= 1e-5 and demd <= TINY["emd_eps"]):
                fail(f"small input {path} {f}: card and host disagree")


#: configs/lidar.yaml and configs/lidar_ped.yaml as keyword overrides (on
#: the Redwood protocol sizes of REDWOOD), with registration on and no
#: saving, as bench_waymo.py runs them
LIDAR = dict(REDWOOD, trust_aligned_completion=False, point_size=2,
             mask_pixel_rate=2, removal_radius=100, edge_point_size=1)
LIDAR_PED = dict(LIDAR, point_size=3, removal_radius=800)
#: objects of the per-object Redwood pass (cut from 3 when phase 10 came)
PER_OBJECT_FLAGS = 2
#: the per-object tiny config: TINY with registration, small pose inputs
#: on both sides, and more fused points than the metric samples (the
#: per-object metric, unlike the batched one, does not pad a fused cloud
#: that the outlier mask left short)
TINY_OBJ = dict(TINY, trust_aligned_completion=False, pose_partial_points=64,
                fused_points=512)


def small_input_check_per_object(tmp: str, seed: int) -> None:
    """run_pipeline and run_batched_lidar (PED scans, a 60-degree
    held-out wedge, registration on) at the tiny size, card against host.

    The card's symmetry plans are replayed on the host (the search itself
    is held card against host by small_input_check, and its K1 launches
    in phase 3).  Every registration step the card ran is replayed on the
    host from the same inputs and held to REG_STEP_TOL; where the two
    runs' fused clouds are equal, UHD and held-out UHD are held within
    1e-5; the end-to-end gaps are printed (see small_input_check)."""
    import numpy as np
    from genpc_tpu_torch import main as tmain
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.io.synthetic_data import (write_dataset,
                                                   write_lidar_dataset)
    from genpc_tpu_torch.models.synthetic import SyntheticImage23D
    from genpc_tpu_torch.parallel import batched_runner
    from genpc_tpu_torch.pipeline import registration as treg
    from genpc_tpu_torch.registration import icp as ticp
    flags = ["01184", "05117"]
    root = os.path.join(tmp, f"tiny_obj_{seed}")
    write_dataset(root, flags, seed=seed, n_gt=8192)
    search = SyntheticImage23D.plan_symmetry_batched

    # run_pipeline
    targets = {"object_pose_optimization": (treg, "object_pose_optimization"),
               "coarse_scale_sweep": (ticp, "coarse_scale_sweep"),
               "iterative_scale_search": (ticp, "iterative_scale_search"),
               "anisotropic": (treg._REFINE, "anisotropic")}
    orig = {n: (o[a] if isinstance(o, dict) else getattr(o, a))
            for n, (o, a) in targets.items()}
    got, ref, plans, calls = {}, {}, [], []
    for dev, out in (("cuda", got), ("cpu", ref)):
        rec = [(o, a, _recorded(calls, n, orig[n]))
               for n, (o, a) in targets.items()] if dev == "cuda" else []
        with patched((SyntheticImage23D, "plan_symmetry_batched",
                      staticmethod(_tape(search, plans))), *rec):
            out.update(tmain.run_pipeline(load_config(device=dev, **TINY_OBJ),
                                          flags, root))
    _hold_steps(f"small input seed {seed} run_pipeline", calls, orig)
    for f in flags:
        log(f"small input seed {seed} run_pipeline {f}: cuda CD "
            f"{got[f]['cd']:.8f} EMD {got[f]['emd']:.7f} | cpu CD "
            f"{ref[f]['cd']:.8f} EMD {ref[f]['emd']:.7f}")
        if not all(map(math.isfinite, (got[f]["cd"], got[f]["emd"]))):
            fail(f"small input run_pipeline {f}: non-finite CD/EMD")

    # run_batched_lidar over PED scans with the held-out wedge
    lflags = write_lidar_dataset(root, {"PED": 2}, seed=seed)["PED"]
    bsteps = {n: getattr(batched_runner, n) for n in REG_STEPS}
    reg = batched_runner.batched_reg
    got, ref, plans, calls, fused = {}, {}, [], [], {}
    for dev, out in (("cuda", got), ("cpu", ref)):
        fused[dev] = {}

        def rec_reg(cfg, arts, *a, _dev=dev, **k):
            reg(cfg, arts, *a, **k)
            fused[_dev].update({x.flag: x.fused_xyz for x in arts})

        rec = [(batched_runner, n, _recorded(calls, n, bsteps[n]))
               for n in REG_STEPS] if dev == "cuda" else []
        with patched((SyntheticImage23D, "plan_symmetry_batched",
                      staticmethod(_tape(search, plans))),
                     (batched_runner, "batched_reg", rec_reg), *rec):
            out.update(batched_runner.run_batched_lidar(
                load_config(device=dev, **dict(
                    TINY, downsample_num=1024,
                    trust_aligned_completion=False)),
                lflags, root, "PED", holdout_wedge_deg=60.0))
    _hold_steps(f"small input seed {seed} run_batched_lidar PED", calls,
                bsteps)
    for f in lflags:
        a, b = fused["cuda"][f], fused["cpu"][f]
        same = a.shape == b.shape and np.allclose(a, b, rtol=0, atol=1e-5)
        log(f"small input seed {seed} run_batched_lidar PED {f}: fused "
            f"clouds equal within 1e-5 {same}; cuda {json.dumps(got[f])} | "
            f"cpu {json.dumps(ref[f])}")
        if set(got[f]) != set(ref[f]) or "holdout_uhd" not in got[f]:
            fail(f"small input run_batched_lidar {f}: held-out flags differ "
                 f"or the wedge was not held out")
        if not all(map(math.isfinite, got[f].values())):
            fail(f"small input run_batched_lidar {f}: non-finite UHD")
        if same and any(abs(got[f][k] - ref[f][k]) > 1e-5 for k in got[f]):
            fail(f"small input run_batched_lidar {f}: UHD differs on "
                 f"agreeing fused clouds")


def _counted(label: str, counters, fn):
    """Run fn with every launch count set to 0 just before and read just
    after, each traced wrapper recording its launches by shape; prints
    the counts and the histogram.  Returns (fn's result, wall, counts)."""
    import torch
    for c in counters.values():
        c.launches = 0
    for name in TRACED:
        counters[name].trace = []
    try:
        torch.cuda.synchronize()
        t0 = time.time()
        out = fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = {name: c.launches for name, c in counters.items()}
    finally:
        traces = {name: counters[name].trace for name in TRACED}
        for name in TRACED:
            counters[name].trace = None
    log(f"{label}: launches: " + json.dumps(launches))
    launch_histogram(label, traces)
    missing = [k for k in PATH_KERNELS[label.split(" ")[0]]
               if launches[k] == 0]
    if missing:
        fail(f"{label}: kernels of the path never launched: {missing}")
    return out, wall, launches


def drive_per_object(root: str, flags, counters) -> dict:
    """run_pipeline (per object, registration on) at the Redwood widths:
    a warm-up pass, then the timed pass whose launches are counted; the
    two must give bit-identical CD."""
    import numpy as np
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.main import run_pipeline
    cfg = load_config(device="cuda", **dict(REDWOOD,
                                            trust_aligned_completion=False))
    t0 = time.time()
    warm = run_pipeline(cfg, flags, root)
    log(f"per_object: warm-up pass {time.time() - t0:.2f} s")
    (results, wall, launches), spans = _with_spans(lambda: _counted(
        "per_object", counters, lambda: run_pipeline(cfg, flags, root)))
    log(f"per_object: timed pass {wall:.3f} s, "
        f"{len(flags) / wall * 60:.3f} objects/min; spans (s; counters): "
        + json.dumps({k: round(v, 4) for k, v in spans.items()}))
    if set(results) != set(flags):
        fail("per_object: missing objects in the results")
    if not all(np.isfinite([m[k] for m in results.values()
                            for k in ("cd", "emd")])):
        fail("per_object: non-finite CD/EMD")
    repeat = all(warm[f]["cd"] == results[f]["cd"] for f in flags)
    log(f"per_object: warm-up and timed passes give bit-identical CD: "
        f"{repeat}")
    for f in flags:
        log(f"  {f}: CD x100 {results[f]['cd'] * 100:.4f} / EMD x100 "
            f"{results[f]['emd'] * 100:.4f}")
    if not repeat:
        fail("per_object: the two passes disagree: the path is not bitwise "
             "repeatable")
    return {"results": results, "launches": launches, "wall": wall}


def drive_lidar(root: str, flags, category: str, cfg_kw: dict, counters,
                warm: bool, attribute: bool = False) -> dict:
    """run_batched_lidar over one category of generated scans at its
    config's values, registration on: an optional warm-up pass, the timed
    pass (launches counted), a pass with a 60-degree held-out wedge, and
    with attribute a pass with ``fusion_debug`` whose means over the
    scans say where the partial->fused UHD arises (the registration
    residual, the UHD to the concatenation, after the FPS and after the
    outlier mask, and the share of partial and generated points each
    step kept)."""
    import numpy as np
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.parallel.batched_runner import run_batched_lidar
    label = f"lidar_{category.lower()}"
    cfg = load_config(device="cuda", **cfg_kw)
    if warm:
        t0 = time.time()
        run_batched_lidar(cfg, flags, root, category)
        log(f"{label}: warm-up pass {time.time() - t0:.2f} s")
    res, wall, launches = _counted(
        label, counters, lambda: run_batched_lidar(cfg, flags, root,
                                                   category))
    t0 = time.time()
    held = run_batched_lidar(cfg, flags, root, category,
                             holdout_wedge_deg=60.0)
    held_wall = time.time() - t0
    uhds = [res[f]["uhd"] for f in flags]
    hvals = [held[f]["holdout_uhd"] for f in flags
             if "holdout_uhd" in held[f]]
    log(f"{label}: timed pass {wall:.3f} s, {len(flags) / wall * 60:.3f} "
        f"objects/min, mean UHD x100 {np.mean(uhds) * 100:.4f}; held-out "
        f"pass {held_wall:.3f} s, mean held-out UHD x100 "
        f"{np.mean(hvals) * 100 if hvals else float('nan'):.4f} over "
        f"{len(hvals)} of {len(flags)} scans")
    for f in flags:
        log(f"  {f}: UHD x100 {res[f]['uhd'] * 100:.4f} | held out: "
            + json.dumps({k: round(v * 100, 4) for k, v in held[f].items()}))
    if not (np.isfinite(uhds).all() and np.isfinite(hvals).all()
            and hvals):
        fail(f"{label}: non-finite UHD or no scan held out")
    if attribute:
        dbg = {}
        run_batched_lidar(cfg, flags, root, category, fusion_debug=dbg)
        keys = next(iter(dbg.values()))
        log(f"{label}: fusion attribution, mean over {len(dbg)} scans: "
            + json.dumps({k: round(float(np.mean(
                [d[k] for d in dbg.values() if d[k] is not None])), 4)
                for k in keys}))
    return {"launches": launches, "wall": wall, "held_wall": held_wall}


def drive_run_lidar(root: str, flags, counters) -> dict:
    """main_lidar.run_lidar (per object: diff_init, reg_fine_xyz) over CAR
    scans at configs/lidar.yaml's values."""
    import numpy as np
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.main_lidar import run_lidar
    cfg = load_config(device="cuda", **LIDAR)
    res, wall, launches = _counted(
        "run_lidar", counters, lambda: run_lidar(cfg, flags, root, "CAR"))
    log(f"run_lidar: {len(flags)} CAR scans in {wall:.3f} s; UHD x100 "
        + json.dumps({f: round(v * 100, 4) for f, v in res.items()}))
    if set(res) != set(flags) or not np.isfinite(list(res.values())).all():
        fail("run_lidar: missing or non-finite UHD")
    return {"launches": launches, "wall": wall}


def drive(path: str, root: str, flags, counters) -> dict:
    """run_batched of one path over the synthetic objects: a warm-up
    pass, then the timed pass whose kernel launches are counted."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.ops.chamfer import _nn_plain
    from genpc_tpu_torch.parallel import batched_runner
    from genpc_tpu_torch.registration import fusion
    cfg = load_config(device="cuda", **dict(
        REDWOOD, trust_aligned_completion=(path == "aligned")))

    # record the metric's FPS samples to recompute CD independently, and
    # the sizes of the clouds the fusion FPS pads into one batch
    seen = {}
    metric = batched_runner.batched_metric_sampled
    pad = fusion.pad_repeat

    def recording_metric(p, g, **kw):
        seen["p"], seen["g"] = p, g
        return metric(p, g, **kw)

    def recording_pad(clouds):
        seen["fusion_sizes"] = [len(c) for c in clouds]
        return pad(clouds)

    batched_runner.batched_metric_sampled = recording_metric
    fusion.pad_repeat = recording_pad
    try:
        t0 = time.time()
        warm = batched_runner.run_batched(cfg, flags, root)
        log(f"{path}: warm-up pass {time.time() - t0:.2f} s")
        for fn in counters.values():
            fn.launches = 0
        for name in TRACED:
            counters[name].trace = []
        timings = {}
        t0 = time.time()
        results = batched_runner.run_batched(cfg, flags, root,
                                             timings=timings)
        wall = time.time() - t0
        launches = {name: fn.launches for name, fn in counters.items()}
    finally:
        batched_runner.batched_metric_sampled = metric
        fusion.pad_repeat = pad
        traces = {name: counters[name].trace for name in TRACED}
        for name in TRACED:
            counters[name].trace = None

    log(f"{path}: timed pass {wall:.3f} s, "
        f"{len(flags) / wall * 60:.3f} objects/min")
    log(f"{path}: stage walls (s): " + json.dumps(
        {k: round(v, 4) for k, v in timings.items()}))
    log(f"{path}: launches in the timed pass: " + json.dumps(launches))
    launch_histogram(path, traces)
    sizes = seen.get("fusion_sizes")
    if sizes:
        log(f"{path}: fusion FPS over {len(sizes)} clouds of {min(sizes)}-"
            f"{max(sizes)} points in one launch")
    if set(results) != set(flags):
        fail(f"{path}: missing objects in the results")
    cds = np.array([results[f]["cd"] for f in flags])
    emds = np.array([results[f]["emd"] for f in flags])
    if not (np.isfinite(cds).all() and np.isfinite(emds).all()):
        fail(f"{path}: non-finite CD/EMD")
    missing = [k for k in PATH_KERNELS[path] if launches[k] == 0]
    if missing:
        fail(f"{path}: kernels of the path never launched: {missing}")
    if launches["fps"] != FPS_LAUNCHES[path]:
        fail(f"{path}: {launches['fps']} K2 launches, expected "
             f"{FPS_LAUNCHES[path]}")
    p, g = seen["p"], seen["g"]
    if p.shape != (len(flags), cfg.metric_points, 3) or p.shape != g.shape:
        fail(f"{path}: metric samples of shape {tuple(p.shape)}")
    d1, _ = _nn_plain(p, g)
    d2, _ = _nn_plain(g, p)
    cd_plain = ((d1.clamp_min(0).sqrt().mean(1)
                 + d2.clamp_min(0).sqrt().mean(1)) / 2).cpu().numpy()
    rel = np.abs(cd_plain - cds) / cds
    log(f"{path}: CD recomputed with the plain NN: max relative "
        f"difference {rel.max():.3e}")
    if rel.max() > 1e-5:
        fail(f"{path}: reported CD disagrees with the plain recompute")
    repeat = all(warm[f]["cd"] == results[f]["cd"] for f in flags)
    log(f"{path}: warm-up and timed passes give bit-identical CD: {repeat}")
    torch.cuda.synchronize()
    return {"results": results, "launches": launches, "wall": wall,
            "timings": timings, "repeat": repeat}


#: wrappers whose launches the timed passes record by shape, and what
#: the shape holds
TRACED = {"chamfer_nn": "(B, N, M)", "fps": "(B, N, k)",
          "emd_bid": "(B, N, M)", "splat_fwd": "(R, S, res)",
          "splat_bwd": "(R, N, res)"}


def launch_histogram(path: str, traces: dict) -> None:
    """Launches and summed time (CUDA events around each wrapper call,
    the merge of M splits included) by launch shape (B, N, M)."""
    import torch
    torch.cuda.synchronize()
    for name, trace in traces.items():
        rows = {}
        for shape, start, end in trace:
            n, ms = rows.get(shape, (0, 0.0))
            rows[shape] = (n + 1, ms + start.elapsed_time(end))
        total = sum(ms for _, ms in rows.values())
        log(f"{path}: {name} launch shapes {TRACED[name]}: {len(trace)} "
            f"launches, {total:.3f} ms")
        for shape, (n, ms) in sorted(rows.items(), key=lambda kv: -kv[1][1]):
            log(f"  {str(shape):24s} {n:5d}x {ms:10.3f} ms "
                f"({ms / n:.4f} ms each)")


def profile_pass(root: str, flags) -> None:
    """One traced pass of the batched registration path over all flags
    and one of the per-object path over the first: device time by kernel
    (kernel rows only, summed per name) and the device's busy share of
    the wall."""
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.main import run_pipeline
    from genpc_tpu_torch.parallel import batched_runner
    cfg = load_config(device="cuda", **dict(REDWOOD,
                                            trust_aligned_completion=False))
    _profiled("registration", lambda: batched_runner.run_batched(
        cfg, flags, root))
    _profiled("per_object", lambda: run_pipeline(cfg, flags[:1], root))


def _profiled(label: str, fn) -> None:
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    rows = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            ms, n = rows.get(evt.name, (0.0, 0))
            rows[evt.name] = (ms + evt.device_time / 1e3, n + 1)
    busy = sum(ms for ms, _ in rows.values())
    log(f"profile: traced {label} pass {wall:.3f} s, device busy "
        f"{busy / 1e3:.3f} s ({busy / 1e3 / wall:.4f} of the wall), "
        f"{sum(n for _, n in rows.values())} kernel launches")
    for name, (ms, n) in sorted(rows.items(), key=lambda kv: -kv[1][0])[:25]:
        log(f"  {ms:10.3f} ms {n:7d}x  {name[:100]}")
    for kernel, names in (("K1", ("nn_kernel", "nn_merge_kernel")),
                          ("K2", ("fps_cluster_kernel",)),
                          ("K3", ("bid_kernel",)),
                          ("K4", ("splat_fwd_kernel",)),
                          ("K5", ("splat_bwd_points_kernel",))):
        pat = re.compile(r"(?<![A-Za-z_])(%s)\b" % "|".join(names))
        hits = [v for k, v in rows.items() if pat.search(k)]
        log(f"profile {label}: {kernel} ({', '.join(names)}) "
            f"{sum(ms for ms, _ in hits):.3f} ms over "
            f"{sum(n for _, n in hits)} launches")


# ------------------------------------------------------------ phase 5 ---

#: the generation pass: configs/redwood.yaml's sizes with the SDXL depth
#: ControlNet at full width (generate's defaults: 30 Euler-ancestral
#: steps, guidance 5.0, 512² images), registration on
CONTROLNET = dict(REDWOOD, trust_aligned_completion=False,
                  control_model="controlnet", model_size="full")
GEN_STEPS = 30
#: card against host at the tiny preset: tests/test_torch_generate.py's
#: IMAGE_TOL["bf16"] (max |d| over [0, 1] images; bf16 rounds at other
#: points in the card's and the host's kernels, and guidance 5.0
#: multiplies the gap between the branches)
GEN_IMAGE_TOL = 0.08
BF16_PEAK = 989e12             # H100 SXM bf16 dense (NVIDIA data sheet)
RELEASE_SLACK = 256 << 20      # bytes release() may leave allocated


def _depth_image(seed: int = 0, res: int = 256):
    """A [3, res, res] depth image in [0, 1] like stage 1's: an inverted
    height field on a black background."""
    import numpy as np
    r = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:res, 0:res] / (res - 1.0)
    d = np.clip(0.9 - (xx - 0.5) ** 2 - (yy - 0.45) ** 2
                + 0.02 * r.random((res, res)), 0, 1)
    d[(xx - 0.5) ** 2 + (yy - 0.45) ** 2 > 0.12] = 0.0
    return np.repeat(d[None], 3, 0).astype(np.float32)


def generation_card_vs_host() -> None:
    """ControlNetDepth and its adapter variant at the tiny preset, on the
    host and on the card with the same state dict: the pure denoise over
    3 steps on the same draws gives images within GEN_IMAGE_TOL."""
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.controlnet_depth import ControlNetDepth
    depth = _depth_image(res=32)
    g = torch.Generator().manual_seed(0)
    lat = torch.randn((1, 4, 8, 8), generator=g)
    noises = torch.randn((3, 1, 4, 8, 8), generator=g)
    for adapter in (False, True):
        host = ControlNetDepth(load_config(device="cpu", model_size="tiny"),
                               adapter=adapter)
        host.init_params()
        card = ControlNetDepth(load_config(device="cuda",
                                           model_size="tiny"),
                               adapter=adapter)
        card.init_params({k: m.state_dict()
                          for k, m in host.models().items()})
        imgs = [b.denoise(b.prepare_depth(depth, 64),
                          *b.encode_prompts("chair", 64),
                          lat.to(b.device), noises.to(b.device)).cpu()
                for b in (host, card)]
        gap = float((imgs[0] - imgs[1]).abs().max())
        label = "adapter" if adapter else "controlnet"
        log(f"generation card vs host, tiny {label}, 64², 3 steps: max "
            f"|d| {gap:.3e} (tolerance {GEN_IMAGE_TOL})")
        if not (torch.isfinite(imgs[1]).all() and gap <= GEN_IMAGE_TOL):
            fail(f"generation card vs host ({label}): the images disagree")


class _LoopEvents:
    """CUDA events around each call of a backend's denoise loop
    (``cls.denoise_latents``, or another ``method``), for the
    milliseconds of one step; ``steps_of(args)`` reads a call's step
    count from its arguments."""

    def __init__(self, cls, steps_of, method: str = "denoise_latents"):
        self.cls, self.steps_of, self.calls = cls, steps_of, []
        self.method = method
        self.orig = getattr(cls, method)

    def __enter__(self):
        import torch
        orig, calls, steps_of = self.orig, self.calls, self.steps_of

        def timed(backend, *a, **k):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = orig(backend, *a, **k)
            end.record()
            calls.append((start, end, steps_of(a)))
            return out
        setattr(self.cls, self.method, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.cls, self.method, self.orig)

    def call_ms(self):
        """The milliseconds of each call, in order."""
        import torch
        torch.cuda.synchronize()
        return [s.elapsed_time(e) for s, e, _ in self.calls]

    def ms_per_step(self) -> float:
        return sum(self.call_ms()) / sum(n for _, _, n in self.calls)


def _step_events():
    """ControlNetDepth's loop: ControlNet + two UNet passes a step (or
    adapter + two), one noise a step."""
    from genpc_tpu_torch.models.controlnet_depth import ControlNetDepth
    return _LoopEvents(ControlNetDepth, lambda a: len(a[6]))


def drive_controlnet(root: str, flags, counters) -> dict:
    """run_batched (registration path) with the full-width ControlNet
    generator: a warm-up pass, then the timed pass whose launches are
    counted.  The generated images of the two passes must be bitwise
    equal (each pass builds its backend from the same seed)."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.parallel import batched_runner
    cfg = load_config(device="cuda", **CONTROLNET)
    gen = batched_runner._generate_images
    stages = []

    def recording(cfg, dp, arts):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.time()
        _, spans = _with_spans(lambda: gen(cfg, dp, arts))
        torch.cuda.synchronize()
        stages.append(dict(
            wall=time.time() - t0, base=base,
            peak=torch.cuda.max_memory_allocated(),
            images=[np.array(a.image) for a in arts], spans=spans))

    with patched((batched_runner, "_generate_images", recording)):
        t0 = time.time()
        batched_runner.run_batched(cfg, flags, root)
        log(f"controlnet: warm-up pass {time.time() - t0:.2f} s")
        timings = {}
        with _step_events() as ev:
            results, wall, launches = _counted(
                "controlnet", counters,
                lambda: batched_runner.run_batched(cfg, flags, root,
                                                   timings=timings))
    warm, timed = stages
    log(f"controlnet: timed pass {wall:.3f} s, "
        f"{len(flags) / wall * 60:.3f} objects/min; stage walls (s): "
        + json.dumps({k: round(v, 4) for k, v in timings.items()}))
    log(f"controlnet: generation stage {timed['wall']:.3f} s for "
        f"{len(flags)} images at {CONTROLNET['generate_res']}², "
        f"{GEN_STEPS} steps: spans (s; counters) " + json.dumps(
            {k: round(v, 4) for k, v in timed["spans"].items()})
        + f"; {ev.ms_per_step():.3f} ms per denoise step (CUDA events); "
        f"peak allocated {timed['peak'] / 2**30:.3f} GiB ("
        f"{(timed['peak'] - timed['base']) / 2**30:.3f} GiB above the "
        f"stage's start)")
    cds = np.array([results[f]["cd"] for f in flags])
    emds = np.array([results[f]["emd"] for f in flags])
    for f in flags:
        log(f"  {f}: CD x100 {results[f]['cd'] * 100:.4f} / EMD x100 "
            f"{results[f]['emd'] * 100:.4f}")
    log(f"controlnet: mean CD x100 {cds.mean() * 100:.4f}, mean EMD x100 "
        f"{emds.mean() * 100:.4f} over {len(flags)} objects")
    if set(results) != set(flags) or not (np.isfinite(cds).all()
                                          and np.isfinite(emds).all()):
        fail("controlnet: missing objects or non-finite CD/EMD")
    if not all(np.isfinite(im).all() for im in timed["images"]):
        fail("controlnet: a non-finite generated image")
    same = all(np.array_equal(a, b)
               for a, b in zip(warm["images"], timed["images"]))
    log(f"controlnet: warm-up and timed passes generate bitwise equal "
        f"images: {same}")
    if not same:
        fail("controlnet: the two passes generate different images")
    return {"results": results, "launches": launches, "wall": wall}


def drive_generate_standalone() -> None:
    """generate outside run_batched: the full ControlNet at 1024² (the
    reference bench's size) and the adapter at 512², 30 steps each, with
    ms per step; the FLOPs of one denoise step at 512² and 1024²
    (FlopCounterMode) over its time; and the memory back after
    release()."""
    import gc
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.controlnet_depth import ControlNetDepth
    depth = _depth_image()
    cfg = load_config(device="cuda", model_size="full")
    gc.collect()
    base = torch.cuda.memory_allocated()
    b = ControlNetDepth(cfg)
    with _step_events() as ev:
        t0 = time.time()
        img, spans = _with_spans(lambda: b.generate(
            depth, "chair", size=1024, num_inference_steps=GEN_STEPS))
        wall = time.time() - t0
    log(f"generate ControlNet 1024², {GEN_STEPS} steps: {wall:.3f} s, "
        f"{ev.ms_per_step():.3f} ms per denoise step (CUDA events); spans "
        f"(s; counters) " + json.dumps({k: round(v, 4)
                                        for k, v in spans.items()}))
    if img.shape != (1024, 1024, 3) or not np.isfinite(img).all():
        fail("generate 1024²: bad image")
    g = torch.Generator(device="cuda").manual_seed(0)
    for size in (512, 1024):
        h = size // 8
        with torch.inference_mode():
            conds = b.encode_prompts("chair", size)
            cond = b.prepare_depth(depth, size)
            x = torch.randn((1, 4, h, h), generator=g, device="cuda")
            t = torch.full((1,), 500.0, device="cuda")

            with FlopCounterMode(display=False) as fc:
                b.guided_eps(x, t, cond, *conds)
            flops = fc.get_total_flops()
            ms = cuda_ms(lambda: b.step_eps(x, t, cond, *conds), reps=5)
            eager_ms = cuda_ms(lambda: b.guided_eps(x, t, cond, *conds),
                               reps=3)
        log(f"denoise step FLOPs at {size}²: {flops / 1e12:.4f} TFLOP "
            f"(FlopCounterMode: ControlNet + two UNet passes) in {ms:.3f} "
            f"ms (its CUDA graph; CUDA events, median of 5) = "
            f"{flops / ms / 1e9:.2f} TFLOP/s, "
            f"{flops / ms / 1e-3 / BF16_PEAK:.4f} of the H100 SXM's "
            f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16 dense peak (data sheet); "
            f"eager, behind a device sleep: {eager_ms:.3f} ms")
    b.release()
    del b
    gc.collect()
    after = torch.cuda.memory_allocated()
    log(f"release(): memory allocated {base / 2**20:.1f} MiB before the "
        f"backend, {after / 2**20:.1f} MiB after release()")
    if after - base > RELEASE_SLACK:
        fail("release() left the backend's memory allocated")
    a = ControlNetDepth(cfg, adapter=True)
    with _step_events() as ev:
        t0 = time.time()
        img, spans = _with_spans(lambda: a.generate(
            depth, "chair", size=512, num_inference_steps=GEN_STEPS))
        wall = time.time() - t0
    log(f"generate T2I-Adapter 512², {GEN_STEPS} steps: {wall:.3f} s, "
        f"{ev.ms_per_step():.3f} ms per denoise step (CUDA events); spans "
        f"(s; counters) " + json.dumps({k: round(v, 4)
                                        for k, v in spans.items()}))
    if img.shape != (512, 512, 3) or not np.isfinite(img).all():
        fail("generate adapter 512²: bad image")
    a.release()


# ------------------------------------------------------------ phase 6 ---

#: the image-to-3D pass: configs/redwood.yaml's sizes with the InstantMesh
#: backend at full width (zero123plus: 75 multiview steps, guidance 4.0;
#: a 96³ SDF grid; 163,840 surface samples), synthetic depth->image and
#: rembg, registration on
INSTANTMESH = dict(REDWOOD, trust_aligned_completion=False,
                   generative_model="instantmesh", model_size="full")
#: card against host at the tiny preset: tests/test_torch_instantmesh.py's
#: VIEW_TOL["bf16"] and VIEW_MEAN_TOL["bf16"] (max and mean |d| over [0,
#: 1] views: bf16 rounds at other points in the card's and the host's
#: kernels, through 4 guided steps of a write and a read pass), and
#: tests/torch_models_ref.py's TOL["bf16"] of the host's largest |sdf|
#: for the SDF grids
IM_VIEW_TOL = 0.12
IM_VIEW_MEAN_TOL = 0.015
IM_SDF_TOL = 3e-2
#: the shell around a GT cloud whose boundary is the real surface of the
#: host-cost measurement: SDF = IM_SHELL - distance to the cloud
IM_SHELL = 0.03


def instantmesh_card_vs_host() -> None:
    """InstantMeshBackend at the tiny preset on the host and on the card
    with one state dict: context, condition latents, the pure multiview
    denoise (4 steps, a CUDA graph a step on the card) on the same draws,
    the decode and the density grid."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.lrm import InstantMeshBackend
    host = InstantMeshBackend(load_config(device="cpu", model_size="tiny"))
    host.init_params()
    card = InstantMeshBackend(load_config(device="cuda", model_size="tiny"))
    card.init_params({k: m.state_dict() for k, m in host.models().items()})
    r = np.random.default_rng(0)
    imgs01 = np.stack([host.prep_image(r.random((64, 64, 4)).astype(
        np.float32)) for _ in range(2)])
    draws = host.draws(2)
    outs = []
    for b in (host, card):
        x = torch.from_numpy(imgs01.transpose(0, 3, 1, 2).copy())
        cond = b.encode_condition(x.to(b.device) * 2 - 1)
        lat, cn, sn = (d.to(b.device) for d in draws)
        views = b.decode(b.denoise_latents(cond, b.encode_context(imgs01),
                                           lat, cn, sn))
        _, sdf = b.density_grid(views, b.cameras(2))
        outs.append((views.cpu(), sdf.cpu()))
    vd = (outs[0][0] - outs[1][0]).abs()
    vgap, vmean = float(vd.max()), float(vd.mean())
    sgap = float((outs[0][1] - outs[1][1]).abs().max())
    smax = float(outs[0][1].abs().max())
    log(f"instantmesh card vs host, tiny, 2 objects, 4 steps: views max "
        f"|d| {vgap:.3e} (tolerance {IM_VIEW_TOL}), mean |d| {vmean:.3e} "
        f"(tolerance {IM_VIEW_MEAN_TOL}); SDF max |d| {sgap:.3e} of max "
        f"|sdf| {smax:.3e} (tolerance {IM_SDF_TOL} of it)")
    if not (torch.isfinite(outs[1][0]).all() and vgap <= IM_VIEW_TOL
            and vmean <= IM_VIEW_MEAN_TOL and sgap <= IM_SDF_TOL * smax):
        fail("instantmesh card vs host: views or SDF grids disagree")


def drive_instantmesh(root: str, flags, counters) -> dict:
    """run_batched (registration path) with the full-width InstantMesh
    backend over ``flags``, all in one image23d_batch chunk: a warm-up
    pass, then the timed pass whose launches are counted.  Each pass
    builds its backend from the same seed, so the decoded views of the
    two passes must be bitwise equal; the memory allocated after the
    backend's release() must be back at its level before the stage."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.lrm import InstantMeshBackend
    from genpc_tpu_torch.parallel import batched_runner
    from genpc_tpu_torch.pipeline.scale_adapter import ScaleAdapter
    # one multiview step: a write and a guided read pass and the scheduler
    # step, over the call's objects
    events = _LoopEvents(InstantMeshBackend, lambda a: len(a[4]))
    cfg = load_config(device="cuda", image23d_batch=len(flags),
                      **INSTANTMESH)
    stage2 = ScaleAdapter.scale_adapter_batch
    decode = InstantMeshBackend.decode
    release = batched_runner._release_backend
    passes = []

    def rec_stage2(self, arts):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = dict(base=torch.cuda.memory_allocated(), views=[], arts=arts,
                   t0=time.time())
        passes.append(rec)
        _, spans = _with_spans(lambda: stage2(self, arts))
        torch.cuda.synchronize()
        rec.update(wall=time.time() - rec["t0"],
                   peak=torch.cuda.max_memory_allocated(),
                   backend=self.image23d, spans=spans,
                   meshes=[(len(a.complete_mesh.vertices),
                            len(a.complete_mesh.faces)) for a in arts])

    def rec_decode(self, latents):
        out = decode(self, latents)
        passes[-1]["views"].append(out.cpu().numpy())
        return out

    def rec_release(owner, attr):
        release(owner, attr)
        if attr == "image23d":
            torch.cuda.synchronize()
            passes[-1]["after_release"] = torch.cuda.memory_allocated()

    with patched((ScaleAdapter, "scale_adapter_batch", rec_stage2),
                 (InstantMeshBackend, "decode", rec_decode),
                 (batched_runner, "_release_backend", rec_release)):
        t0 = time.time()
        batched_runner.run_batched(cfg, flags, root)
        log(f"instantmesh: warm-up pass {time.time() - t0:.2f} s")
        timings = {}
        with events as ev:
            results, wall, launches = _counted(
                "instantmesh", counters,
                lambda: batched_runner.run_batched(cfg, flags, root,
                                                   timings=timings))
    warm, timed = passes
    b = len(flags)
    log(f"instantmesh: timed pass {wall:.3f} s, {b / wall * 60:.3f} "
        f"objects/min; stage walls (s): " + json.dumps(
            {k: round(v, 4) for k, v in timings.items()}))
    step_ms = ev.ms_per_step()
    above = timed["peak"] - timed["base"]
    log(f"instantmesh: image-to-3D stage {timed['wall']:.3f} s for {b} "
        f"objects in one chunk (image23d_batch {b}), "
        f"{timed['backend'].mv_steps} multiview steps, a "
        f"{timed['backend'].lrm_cfg.grid_res}³ grid: spans (s; counters) "
        + json.dumps({k: round(v, 4) for k, v in timed["spans"].items()})
        + f"; {step_ms:.3f} ms per multiview step over {b} objects "
        f"({step_ms / b:.3f} an object; CUDA events); peak allocated "
        f"{timed['peak'] / 2**30:.3f} GiB ({above / 2**30:.3f} GiB above "
        f"the stage's start)")
    log(f"instantmesh: memory allocated {timed['base'] / 2**20:.1f} MiB "
        f"before the backend's weights, {timed['after_release'] / 2**20:.1f}"
        f" MiB after its release()")
    log("instantmesh: meshes (vertices, faces) by object, warm-up | timed: "
        + json.dumps({f: [list(w), list(t)] for f, w, t in zip(
            flags, warm["meshes"], timed["meshes"])}))
    for f in flags:
        log(f"  {f}: CD x100 {results[f]['cd'] * 100:.4f} / EMD x100 "
            f"{results[f]['emd'] * 100:.4f}")
    cds = np.array([results[f]["cd"] for f in flags])
    emds = np.array([results[f]["emd"] for f in flags])
    log(f"instantmesh: mean CD x100 {cds.mean() * 100:.4f}, mean EMD x100 "
        f"{emds.mean() * 100:.4f} over {b} objects")
    if set(results) != set(flags) or not (np.isfinite(cds).all()
                                          and np.isfinite(emds).all()):
        fail("instantmesh: missing objects or non-finite CD/EMD")
    vs = timed["backend"].lrm_cfg.view_size
    views = [np.concatenate(p["views"]) for p in passes]
    if views[1].shape != (b, 6, 3, vs, vs) or \
            not np.isfinite(views[1]).all():
        fail(f"instantmesh: views of shape {views[1].shape}")
    same = np.array_equal(views[0], views[1])
    log(f"instantmesh: warm-up and timed passes decode bitwise equal "
        f"views: {same}")
    if not same:
        fail("instantmesh: the two passes decode different views")
    if timed["after_release"] - timed["base"] > RELEASE_SLACK:
        fail("instantmesh: release() left the backend's memory allocated")
    return {"results": results, "launches": launches, "wall": wall,
            "arts": timed["arts"], "cfg": cfg,
            "max_verts": max(v for v, _ in timed["meshes"])}


def instantmesh_step_flops(batches, n_verts: int) -> None:
    """The parameter count on the meta device; then, for each B of
    ``batches``, the image-to-3D stage's device work at image23d_batch B
    on seeded inputs with the full-width backend: the context and
    condition latents, one multiview step (its FLOPs by FlopCounterMode,
    eager, over its CUDA graph replay's time against the bf16 peak, the
    eager time beside it), the decode, the density grids and the colour
    query at n_verts points (the pass's largest mesh), with the peak
    memory allocated; then the memory back after release()."""
    import gc
    import numpy as np
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.lrm import InstantMeshBackend
    from genpc_tpu_torch.models.schedulers import EulerAncestral
    cfg = load_config(device="cuda", model_size=INSTANTMESH["model_size"])
    meta = InstantMeshBackend(cfg)
    count = sum(p.numel() for m in meta.models().values()
                for p in m.parameters())
    log(f"instantmesh parameters (meta device): {count:,} in the models, "
        f"{count + meta.txt_cfg.max_len:,} with the 77 ramping "
        f"coefficients: " + json.dumps({k: sum(
            p.numel() for p in m.parameters())
            for k, m in meta.models().items()}))
    gc.collect()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    total = torch.cuda.get_device_properties(0).total_memory
    b = InstantMeshBackend(cfg)
    b.init_params()
    r = np.random.default_rng(0)
    for n in batches:
        b._graphs.clear()
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        imgs01 = np.stack([b.prep_image(r.random((512, 512, 4)).astype(
            np.float32)) for _ in range(n)])
        sched = EulerAncestral(b.mv_steps, spacing="trailing",
                               prediction="v", device="cuda")
        with torch.inference_mode():
            ctx = b.encode_context(imgs01)
            x = torch.from_numpy(imgs01.transpose(0, 3, 1, 2).copy())
            cond = b.encode_condition(x.to(b.device) * 2 - 1)
            lat, cn, sn = b.draws(n)
            i = b.mv_steps // 2
            tensors = [lat, cond, ctx, torch.tensor([i], device=b.device),
                       cn[i], sn[i]]
            with FlopCounterMode(display=False) as fc:
                b.mv_step(*tensors, sched)
            flops = fc.get_total_flops()
            ms = cuda_ms(lambda: b._step(sched, tensors), reps=5)
            eager_ms = cuda_ms(lambda: b.mv_step(*tensors, sched), reps=3)
            views = b.decode(b._step(sched, tensors))
            planes, sdf = b.density_grid(views, b.cameras(n))
            b.vertex_colors(planes[0], r.uniform(-1, 1, (n_verts, 3)).astype(
                np.float32))
            torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        h, (gh, gw) = cond.shape[-1], b.grid_hw()
        log(f"instantmesh at image23d_batch {n}: multiview step FLOPs "
            f"{flops / 1e12:.4f} TFLOP (FlopCounterMode: a write pass over "
            f"{2 * n} {h}x{h} condition latents, a read pass over {2 * n} "
            f"{gh}x{gw} samples) in {ms:.3f} ms (its CUDA graph; CUDA "
            f"events, median of 5) = {flops / ms / 1e9:.2f} TFLOP/s, "
            f"{flops / ms / 1e-3 / BF16_PEAK:.4f} of the H100 SXM's "
            f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16 dense peak (data sheet); "
            f"eager, behind a device sleep: {eager_ms:.3f} ms; peak "
            f"allocated {peak / 2**30:.3f} GiB of the card's "
            f"{total / 2**30:.3f} GiB (weights, context, condition "
            f"latents, {b.mv_steps} steps' draws, the step eager and as a "
            f"graph, the decode, {n} {b.lrm_cfg.grid_res}³ SDF grids, "
            f"colours at {n_verts:,} points)")
        del ctx, cond, lat, cn, sn, tensors, views, planes, sdf
    b.release()
    del b
    gc.collect()
    torch.cuda.synchronize()
    after = torch.cuda.memory_allocated()
    log(f"instantmesh release(): memory allocated {base / 2**20:.1f} MiB "
        f"before the backend was built, {after / 2**20:.1f} MiB after "
        f"release()")
    if after - base > RELEASE_SLACK:
        fail("instantmesh release() left the backend's memory allocated")


def instantmesh_real_surface(root: str, run: dict) -> None:
    """The host cost of a real surface: for each object of the timed
    pass, a 96³ SDF grid IM_SHELL - (distance to its GT cloud) (the
    distances from K1 on the card), marching tetrahedra at level 0,
    163,840 surface samples, then batched_reg over all of them with those
    meshes as the completions.  Fed here only: nothing in the program
    changes."""
    import numpy as np
    import torch
    from genpc_tpu_torch.io.glb import Mesh, sample_mesh_surface
    from genpc_tpu_torch.io.ply import load_xyz
    from genpc_tpu_torch.ops.chamfer import nearest_neighbor
    from genpc_tpu_torch.ops.marching import marching_tetrahedra
    from genpc_tpu_torch.parallel.batched_runner import batched_reg
    from genpc_tpu_torch.pipeline.artifacts import ObjectArtifacts
    cfg, arts = run["cfg"], run["arts"]
    res = 96
    g = torch.linspace(-1.0, 1.0, res, device="cuda")
    grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"),
                       dim=-1).reshape(-1, 3)
    n = int(cfg.glb_sample_points)
    t_march = t_sample = 0.0
    sizes, new = [], []
    for art in arts:
        gt, _ = load_xyz(os.path.join(root, "GT", f"{art.flag}.ply"))
        d2, _ = nearest_neighbor(grid, torch.as_tensor(gt, device="cuda"))
        sdf = (IM_SHELL - d2.clamp_min(0).sqrt()).reshape(res, res, res)
        sdf = sdf.cpu().numpy()
        t0 = time.time()
        v, f = marching_tetrahedra(sdf, level=0.0)
        t1 = time.time()
        mesh = Mesh(v, f, np.full(v.shape, 0.5, np.float32))
        sample_mesh_surface(mesh, n)
        t_march += t1 - t0
        t_sample += time.time() - t1
        sizes.append((len(v), len(f)))
        new.append(ObjectArtifacts(
            flag=art.flag, color_xyz=art.color_xyz,
            color_rgb=art.color_rgb, complete_mesh=mesh))
    torch.cuda.synchronize()
    t0 = time.time()
    _, timings = _with_spans(lambda: batched_reg(cfg, new))
    torch.cuda.synchronize()
    wall = time.time() - t0
    log(f"instantmesh real surface ({res}³ grid of {IM_SHELL} minus the "
        f"distance to each GT cloud): meshes (vertices, faces) "
        + json.dumps([list(x) for x in sizes])
        + f"; marching {t_march:.3f} s and {n:,}-point sampling "
        f"{t_sample:.3f} s for {len(new)} objects (host); batched_reg "
        f"{wall:.3f} s (its sampling included): " + json.dumps(
            {k: round(v, 4) for k, v in timings.items()}))
    if not all(a.fused_xyz is not None and np.isfinite(a.fused_xyz).all()
               for a in new):
        fail("instantmesh real surface: a fused cloud is missing")


# ------------------------------------------------------------ phase 7 ---

#: the Qwen pass: configs/redwood.yaml's sizes with the full-width
#: Qwen-Image-Edit depth->image backend (the Qwen2.5-VL text and vision
#: towers, the 60-block MMDiT, the 16-channel VAE; 8 rectified-flow steps
#: with true CFG 4.0 at 512²), its weights in bf16 (quant_bits 0: int8
#: and int4 are not ported), all 13 objects in one generate_obj_batch
#: chunk, registration on
QWEN = dict(REDWOOD, trust_aligned_completion=False, control_model="qwen",
            model_size="full", quant_bits=0, tower_quant_bits=0,
            generate_obj_batch=13)
#: the reference's parameter counts (jax.eval_shape of its full presets;
#: tests/test_torch_dit.py and test_torch_qwen_vl.py hold the port's to
#: them)
QWEN_PARAMS = {"dit": 20_430_401_088, "qwen_vl_text": 7_070_619_136,
               "qwen_vl_vision": 676_550_144}
#: BASELINE config 4: Qwen-Image-Edit, then InstantMesh, both at full
#: width, over CONFIG4_OBJECTS objects
CONFIG4 = dict(QWEN, generative_model="instantmesh",
               image23d_batch=CONFIG4_OBJECTS)


def qwen_card_vs_host() -> None:
    """DiTDepthEdit at the tiny preset (tiny_qwen MMDiT, tiny Qwen2.5-VL
    towers, tiny VAE) on the host and on the card with one state dict:
    generate_batch over two objects at 64² (8 steps, true CFG 4.0, a CUDA
    graph a step on the card) on the host's draws; the images within
    GEN_IMAGE_TOL."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    host = DiTDepthEdit(load_config(device="cpu", model_size="tiny"))
    host.init_params()
    card = DiTDepthEdit(load_config(device="cuda", model_size="tiny"))
    card.init_params({k: m.state_dict() for k, m in host.models().items()})
    depths = [_depth_image(seed=s, res=32) for s in (0, 1)]
    lat = host.draws(2, 64 // host.factor)
    imgs = []
    for b in (host, card):
        b.draws = lambda n, hw, b=b: lat.to(b.device)
        imgs.append(b.generate_batch(depths, ["01184", "05117"], size=64))
    d = np.abs(imgs[0] - imgs[1])
    log(f"qwen card vs host, tiny, 2 objects at 64², 8 steps: max |d| "
        f"{float(d.max()):.3e}, mean |d| {float(d.mean()):.3e} (tolerance "
        f"{GEN_IMAGE_TOL} on the max)")
    if not (np.isfinite(imgs[1]).all() and d.max() <= GEN_IMAGE_TOL):
        fail("qwen card vs host: the images disagree")


def _qwen_events():
    """Each sampler step of DiTDepthEdit (a conditional and an
    unconditional MMDiT pass, cfg_combine and the Euler step, over the
    call's objects): a loop's first step also warms up and captures its
    CUDA graph, the others replay it."""
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    return _LoopEvents(DiTDepthEdit, lambda a: 1, method="_step")


def drive_qwen(root: str, flags, counters) -> dict:
    """run_batched (registration path) with the full-width Qwen-Image-Edit
    generator, all objects in one generate_obj_batch chunk: a warm-up
    pass, then the timed pass whose launches are counted.  Each pass
    builds its backend from the same seed, so the images of the two
    passes must be bitwise equal; the memory allocated after the
    backend's release() must be back at its level before the stage."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.parallel import batched_runner
    cfg = load_config(device="cuda", **QWEN)
    gen = batched_runner._generate_images
    release = batched_runner._release_backend
    passes = []

    def recording(cfg, dp, arts):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = dict(base=torch.cuda.memory_allocated(), t0=time.time())
        passes.append(rec)
        _, spans = _with_spans(lambda: gen(cfg, dp, arts))
        torch.cuda.synchronize()
        rec.update(wall=time.time() - rec["t0"],
                   peak=torch.cuda.max_memory_allocated(),
                   images=[np.array(a.image) for a in arts], spans=spans)

    def rec_release(owner, attr):
        release(owner, attr)
        if attr == "depth2image":
            torch.cuda.synchronize()
            passes[-1].update(after_release=torch.cuda.memory_allocated())

    with patched((batched_runner, "_generate_images", recording),
                 (batched_runner, "_release_backend", rec_release)):
        t0 = time.time()
        batched_runner.run_batched(cfg, flags, root)
        log(f"qwen: warm-up pass {time.time() - t0:.2f} s")
        timings = {}
        with _qwen_events() as ev:
            results, wall, launches = _counted(
                "qwen", counters,
                lambda: batched_runner.run_batched(cfg, flags, root,
                                                   timings=timings))
    warm, timed = passes
    b = len(flags)
    first, *replays = ev.call_ms()
    step_ms = statistics.median(replays)
    log(f"qwen: timed pass {wall:.3f} s, {b / wall * 60:.3f} objects/min; "
        f"stage walls (s): " + json.dumps(
            {k: round(v, 4) for k, v in timings.items()}))
    log(f"qwen: generation stage {timed['wall']:.3f} s for {b} images at "
        f"{QWEN['generate_res']}² in generate_obj_batch "
        f"{QWEN['generate_obj_batch']} chunks: spans (s; counters) "
        + json.dumps({k: round(v, 4) for k, v in timed["spans"].items()})
        + f"; a sampler step over {b} objects (two MMDiT passes; CUDA "
        f"events) {step_ms:.3f} ms as a CUDA graph replay (median of "
        f"{len(replays)}), {first:.3f} ms for the first (eager warm-up, "
        f"capture, replay); peak allocated "
        f"{timed['peak'] / 2**30:.3f} GiB ("
        f"{(timed['peak'] - timed['base']) / 2**30:.3f} GiB above the "
        f"stage's start) of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / 2**30:.3f} "
        f"GiB; memory allocated {timed['base'] / 2**20:.1f} MiB before the "
        f"backend, {timed['after_release'] / 2**20:.1f} MiB after its "
        f"release()")
    cds = np.array([results[f]["cd"] for f in flags])
    emds = np.array([results[f]["emd"] for f in flags])
    for f in flags:
        log(f"  {f}: CD x100 {results[f]['cd'] * 100:.4f} / EMD x100 "
            f"{results[f]['emd'] * 100:.4f}")
    log(f"qwen: mean CD x100 {cds.mean() * 100:.4f}, mean EMD x100 "
        f"{emds.mean() * 100:.4f} over {b} objects")
    if set(results) != set(flags) or not (np.isfinite(cds).all()
                                          and np.isfinite(emds).all()):
        fail("qwen: missing objects or non-finite CD/EMD")
    size = QWEN["generate_res"]
    if not all(im.shape == (size, size, 3) and np.isfinite(im).all()
               for im in timed["images"]):
        fail("qwen: a bad generated image")
    same = all(np.array_equal(x, y)
               for x, y in zip(warm["images"], timed["images"]))
    log(f"qwen: warm-up and timed passes generate bitwise equal images: "
        f"{same}")
    if not same:
        fail("qwen: the two passes generate different images")
    if timed["after_release"] - timed["base"] > RELEASE_SLACK:
        fail("qwen: release() left the backend's memory allocated")
    return {"results": results, "launches": launches, "wall": wall,
            "step_ms": step_ms}


def qwen_step_flops(n: int, step_ms: float) -> None:
    """The parameter counts and one sampler step's FLOPs over n objects,
    both on the meta device (FlopCounterMode; the MMDiT at 64² latents,
    1,024 image and 1,024 edit tokens beside the 512-token text budget),
    the FLOPs over the timed pass's step time against the bf16 peak."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    from genpc_tpu_torch.models.schedulers import FlowMatchEuler
    b = DiTDepthEdit(load_config(device="cuda", **QWEN))
    counts = {k: sum(p.numel() for p in m.parameters())
              for k, m in b.models().items()}
    vl = counts["qwen_vl_text"] + counts["qwen_vl_vision"]
    log("qwen parameters (meta device): " + json.dumps(counts)
        + f"; the VL towers {vl:,}")
    if any(counts[k] != v for k, v in QWEN_PARAMS.items()):
        fail(f"qwen: parameter counts differ from the reference's "
             f"{QWEN_PARAMS}")
    hw = QWEN["generate_res"] // b.factor
    meta = torch.device("meta")
    lat = torch.zeros(n, b.dit_cfg.in_channels, hw, hw, device=meta)
    txt = torch.zeros(n, b.txt_budget, b.dit_cfg.text_dim, device=meta)
    mask = torch.ones(n, b.txt_budget, dtype=torch.bool, device=meta)
    with FlopCounterMode(display=False) as fc:
        b.sample_step(lat, torch.zeros(1, dtype=torch.long, device=meta),
                      lat, txt, mask, txt, mask,
                      FlowMatchEuler(b.steps, device=meta))
    flops = fc.get_total_flops()
    log(f"qwen sampler step FLOPs over {n} objects: {flops / 1e12:.4f} "
        f"TFLOP (FlopCounterMode: two MMDiT passes over {n} x "
        f"{2 * (hw // 2) ** 2 + b.txt_budget} tokens) in {step_ms:.3f} ms "
        f"(the timed pass's graph replays, CUDA events) = "
        f"{flops / step_ms / 1e9:.2f} "
        f"TFLOP/s, {flops / step_ms / 1e-3 / BF16_PEAK:.4f} of the H100 "
        f"SXM's {BF16_PEAK / 1e12:.0f} TFLOP/s bf16 dense peak (data sheet)")


def drive_config4(root: str, flags, counters) -> dict:
    """BASELINE config 4 once: run_batched (registration path) with the
    full-width Qwen-Image-Edit generator, then the full-width InstantMesh
    image-to-3D backend; each backend releases the card to the next (the
    memory allocated is printed after each release()).  CD and EMD must
    be finite."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.parallel import batched_runner
    cfg = load_config(device="cuda", **CONFIG4)
    release = batched_runner._release_backend
    after = []

    def rec_release(owner, attr):
        release(owner, attr)
        torch.cuda.synchronize()
        after.append((attr, torch.cuda.memory_allocated()))

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    timings = {}
    with patched((batched_runner, "_release_backend", rec_release)):
        results, wall, launches = _counted(
            "config4", counters,
            lambda: batched_runner.run_batched(cfg, flags, root,
                                               timings=timings))
    b = len(flags)
    log(f"config4 (Qwen-Image-Edit + InstantMesh): {wall:.3f} s for {b} "
        f"objects, {b / wall * 60:.3f} objects/min; stage walls (s): "
        + json.dumps({k: round(v, 4) for k, v in timings.items()})
        + f"; memory allocated {base / 2**20:.1f} MiB before the pass, "
        + ", ".join(f"{m / 2**20:.1f} MiB after {a}.release()"
                    for a, m in after))
    for f in flags:
        log(f"  {f}: CD x100 {results[f]['cd'] * 100:.4f} / EMD x100 "
            f"{results[f]['emd'] * 100:.4f}")
    cds = np.array([results[f]["cd"] for f in flags])
    emds = np.array([results[f]["emd"] for f in flags])
    if set(results) != set(flags) or not (np.isfinite(cds).all()
                                          and np.isfinite(emds).all()):
        fail("config4: missing objects or non-finite CD/EMD")
    if any(m - base > RELEASE_SLACK for _, m in after):
        fail("config4: a release() left its backend's memory allocated")
    return {"results": results, "launches": launches, "wall": wall}


# ------------------------------------------------------------ phase 8 ---

#: the reference's full-size FLUX deployment (FLUX.1-Depth-dev for the
#: images, the FLUX inpainter for stage 1's depths) at its quantisation
#: defaults: quant_bits and tower_quant_bits unset, i.e. int4 MMDiT and
#: int4 T5-XXL in both backends
#: objects of the FLUX pass (cut from 13 for the time limit when phase
#: 10 came)
FLUX_OBJECTS = 7
FLUX = dict(REDWOOD, trust_aligned_completion=False, control_model="flux",
            inpainter="flux", model_size="full",
            generate_obj_batch=FLUX_OBJECTS)
#: the reference's parameter counts (jax.eval_shape of its full presets,
#: unquantised; tests/test_torch_flux.py and test_torch_t5.py hold the
#: port's to them)
FLUX_PARAMS = {"dit": 11_901_604_928, "t5": 4_762_310_656}
#: card against host of T5PromptEncoder.encode at the tiny preset:
#: tests/test_torch_t5.py's bf16 bound, of the largest |host| value
T5_TOL = 3e-2


def flux_card_vs_host() -> None:
    """The FLUX backend at the tiny preset on the host and on the card with
    one state dict: generate_batch over two objects at 64² (30 steps,
    guidance 10.0, a CUDA graph a step on the card) on the host's draws at
    quant_bits 0, 8 and 4 (T5 quantised alike), images within
    GEN_IMAGE_TOL; FluxInpainter.paint on a depth image with a hole on the
    host's draw, within GEN_IMAGE_TOL and the known pixels exact; and
    T5PromptEncoder.encode within T5_TOL."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit, FluxInpainter
    depths = [_depth_image(seed=s, res=32) for s in (0, 1)]
    for bits in (0, 8, 4):
        kw = dict(model_size="tiny", quant_bits=bits, tower_quant_bits=bits)
        host = DiTDepthEdit(load_config(device="cpu", **kw), variant="flux")
        host.init_params()
        card = DiTDepthEdit(load_config(device="cuda", **kw),
                            variant="flux")
        card.init_params({k: m.state_dict()
                          for k, m in host.models().items()})
        lat = host.draws(2, 64 // host.factor)
        imgs = []
        for b in (host, card):
            b.draws = lambda n, hw, b=b: lat.to(b.device)
            imgs.append(b.generate_batch(depths, ["01184", "05117"],
                                         size=64))
        d = np.abs(imgs[0] - imgs[1])
        log(f"flux card vs host, tiny, quant_bits {bits}, 2 objects at "
            f"64², 30 steps: max |d| {float(d.max()):.3e}, mean |d| "
            f"{float(d.mean()):.3e} (tolerance {GEN_IMAGE_TOL} on the max)")
        if not (np.isfinite(imgs[1]).all() and d.max() <= GEN_IMAGE_TOL):
            fail(f"flux card vs host (quant_bits {bits}): the images "
                 f"disagree")
        if bits == 0:
            ctx_h, pooled_h = host.t5.encode(["complete the depth map. ",
                                              "a chair"])
            ctx_c, pooled_c = card.t5.encode(["complete the depth map. ",
                                              "a chair"])
            for name, h, c in (("context", ctx_h, ctx_c),
                               ("pooled", pooled_h, pooled_c)):
                gap = float((h - c.cpu()).abs().max())
                scale = float(h.abs().max())
                log(f"t5 card vs host, tiny, {name} {tuple(h.shape)}: max "
                    f"|d| {gap:.3e} of max |host| {scale:.3e} (tolerance "
                    f"{T5_TOL} of it)")
                if not gap <= T5_TOL * scale:
                    fail(f"t5 card vs host: the {name}s disagree")
    host = FluxInpainter(load_config(device="cpu", model_size="tiny"))
    host.backend.init_params()
    card = FluxInpainter(load_config(device="cuda", model_size="tiny"))
    card.backend.init_params({k: m.state_dict() for k, m
                              in host.backend.models().items()})
    raw = _depth_image(seed=2, res=64)
    hole = np.zeros((3, 64, 64), np.float32)
    hole[:, 16:40, 20:52] = 1.0
    hole[:, raw[0] == 0] = 1.0
    noise = host.paint_draws(64 // host.backend.factor)
    outs = []
    for inp in (host, card):
        inp.paint_draws = lambda hw, inp=inp: noise.to(inp.device)
        outs.append(inp.paint(raw, hole))
    known = hole.max(axis=0) < 0.5
    d = np.abs(outs[0] - outs[1])
    exact = bool(np.array_equal(outs[0][:, known], outs[1][:, known]))
    log(f"flux inpainter card vs host, tiny, 64², 30 steps: max |d| "
        f"{float(d.max()):.3e} (tolerance {GEN_IMAGE_TOL}), known pixels "
        f"exact: {exact}")
    if not (np.isfinite(outs[1]).all() and d.max() <= GEN_IMAGE_TOL
            and exact):
        fail("flux inpainter card vs host: the images disagree")


def _backend_bytes(be) -> dict:
    from genpc_tpu_torch.models.quant import tree_bytes
    return {k: tree_bytes(m) for k, m in be.models().items()}


def drive_flux(root: str, flags, counters) -> dict:
    """run_batched (registration path) with FLUX at its full-size
    defaults: stage 1 paints each object's depth with the FLUX inpainter
    (30 steps at res², a CUDA graph a step), the inpainter is freed, then
    FLUX.1-Depth-dev generates every image at 512² in one
    generate_obj_batch chunk (30 steps, guidance 10.0) and is freed.  A
    warm-up pass, then the timed pass whose launches are counted; both
    build their backends from the same seeds, so the painted depths and
    the images of the two passes must be bitwise equal, and the memory
    allocated after each release() must be back at its level before the
    pass."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit, FluxInpainter
    from genpc_tpu_torch.parallel import batched_runner
    cfg = load_config(device="cuda", **FLUX)
    stage1 = batched_runner.batched_stage1
    gen = batched_runner._generate_images
    release = batched_runner._release_backend
    passes = []     # each pass's walls, memory, weight bytes, spans, outputs

    def rec_stage1(cfg, arts, viewpoints, core=None, dp=None, mesh=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        rec = dict(base=torch.cuda.memory_allocated(), after={}, weights={},
                   spans={})
        passes.append(rec)
        t0 = time.time()
        _, rec["spans"]["inpainter"] = _with_spans(lambda: stage1(
            cfg, arts, viewpoints, core=core, dp=dp, mesh=mesh))
        torch.cuda.synchronize()
        rec["stage1_wall"] = time.time() - t0
        rec["weights"]["inpainter"] = _backend_bytes(dp.inpainter.backend)
        rec["depths"] = [np.array(a.depth) for a in arts]

    def rec_gen(cfg, dp, arts):
        rec = passes[-1]
        t0 = time.time()
        _, rec["spans"]["depth2image"] = _with_spans(
            lambda: gen(cfg, dp, arts))
        torch.cuda.synchronize()
        rec["gen_wall"] = time.time() - t0
        rec["weights"]["depth2image"] = _backend_bytes(dp.depth2image)
        rec["images"] = [np.array(a.image) for a in arts]

    def rec_release(owner, attr):
        release(owner, attr)
        if attr in ("inpainter", "depth2image"):
            torch.cuda.synchronize()
            rec = passes[-1]
            rec["after"][attr] = torch.cuda.memory_allocated()
            rec["peak"] = torch.cuda.max_memory_allocated()

    with patched((batched_runner, "batched_stage1", rec_stage1),
                 (batched_runner, "_generate_images", rec_gen),
                 (batched_runner, "_release_backend", rec_release)):
        t0 = time.time()
        batched_runner.run_batched(cfg, flags, root)
        log(f"flux: warm-up pass {time.time() - t0:.2f} s")
        timings = {}
        with _LoopEvents(DiTDepthEdit, lambda a: 1, method="_step") as ev, \
                _LoopEvents(FluxInpainter, lambda a: a[-1],
                            method="inpaint_image") as ev_inp:
            results, wall, launches = _counted(
                "flux", counters,
                lambda: batched_runner.run_batched(cfg, flags, root,
                                                   timings=timings))
    warm, timed = passes
    b = len(flags)
    first, *replays = ev.call_ms()
    step_ms = statistics.median(replays)
    paint_ms = ev_inp.call_ms()
    log(f"flux: timed pass {wall:.3f} s, {b / wall * 60:.3f} objects/min; "
        f"stage walls (s): " + json.dumps(
            {k: round(v, 4) for k, v in timings.items()}))
    log(f"flux: stage 1 {timed['stage1_wall']:.3f} s, {b} depths painted "
        f"at {FLUX['res']}² (30 steps each; the inpaint call of each, VAE "
        f"encode, sampler and decode, CUDA events: first "
        f"{paint_ms[0]:.3f} ms, then median "
        f"{statistics.median(paint_ms[1:]):.3f} ms, "
        f"{statistics.median(paint_ms[1:]) / 30:.3f} ms a step); inpainter "
        f"spans (s; counters) " + json.dumps(
            {k: round(v, 4)
             for k, v in timed["spans"]["inpainter"].items()}))
    log(f"flux: generation stage {timed['gen_wall']:.3f} s for {b} images "
        f"at {FLUX['generate_res']}² in generate_obj_batch "
        f"{FLUX['generate_obj_batch']} chunks: spans (s; counters) "
        + json.dumps({k: round(v, 4) for k, v
                      in timed["spans"]["depth2image"].items()})
        + f"; a sampler step over {b} objects (one MMDiT pass; CUDA "
        f"events) {step_ms:.3f} ms as a CUDA graph replay (median of "
        f"{len(replays)}), {first:.3f} ms for the first (eager warm-up, "
        f"capture, replay)")
    gib = 2 ** 30
    gen_bytes = sum(timed["weights"]["depth2image"].values())
    dit_bf16 = 2 * FLUX_PARAMS["dit"]
    log(f"flux: weight bytes (GB) " + json.dumps(
        {w: {k: round(v / 1e9, 4) for k, v in d.items()}
         for w, d in timed["weights"].items()})
        + f"; peak allocated over the pass {timed['peak'] / gib:.3f} GiB "
        f"({(timed['peak'] - timed['base']) / gib:.3f} GiB above its "
        f"start, {(timed['peak'] - timed['base'] - gen_bytes) / gib:.3f} "
        f"GiB above the generator's weights, where every layer's bf16 "
        f"kernel at once would be {dit_bf16 / gib:.3f} GiB) of the card's "
        f"{torch.cuda.get_device_properties(0).total_memory / gib:.3f} GiB; "
        f"memory allocated {timed['base'] / 2**20:.1f} MiB before the pass, "
        + ", ".join(f"{m / 2**20:.1f} MiB after {a}.release()"
                    for a, m in timed["after"].items()))
    cds = np.array([results[f]["cd"] for f in flags])
    emds = np.array([results[f]["emd"] for f in flags])
    for f in flags:
        log(f"  {f}: CD x100 {results[f]['cd'] * 100:.4f} / EMD x100 "
            f"{results[f]['emd'] * 100:.4f}")
    log(f"flux: mean CD x100 {cds.mean() * 100:.4f}, mean EMD x100 "
        f"{emds.mean() * 100:.4f} over {b} objects")
    if set(results) != set(flags) or not (np.isfinite(cds).all()
                                          and np.isfinite(emds).all()):
        fail("flux: missing objects or non-finite CD/EMD")
    size, res = FLUX["generate_res"], FLUX["res"]
    if not (all(im.shape == (size, size, 3) and np.isfinite(im).all()
                for im in timed["images"])
            and all(d.shape == (3, res, res) and np.isfinite(d).all()
                    for d in timed["depths"])):
        fail("flux: a bad painted depth or generated image")
    same_d = all(np.array_equal(x, y)
                 for x, y in zip(warm["depths"], timed["depths"]))
    same_i = all(np.array_equal(x, y)
                 for x, y in zip(warm["images"], timed["images"]))
    log(f"flux: warm-up and timed passes paint bitwise equal depths: "
        f"{same_d}; generate bitwise equal images: {same_i}")
    if not (same_d and same_i):
        fail("flux: the two passes paint or generate differently")
    if any(m - timed["base"] > RELEASE_SLACK
           for m in timed["after"].values()):
        fail("flux: a release() left its backend's memory allocated")
    return {"results": results, "launches": launches, "wall": wall,
            "step_ms": step_ms}


def _step_inputs(b, n: int, dev):
    """Seeded inputs of one sampler step of backend b over n objects at
    FLUX's generation size: latents, a step index, condition latents and
    the conditioning tensors (FLUX: a 512-token T5 context and the pooled
    vector; Qwen: 512-token contexts with 300 valid tokens, twice)."""
    import torch
    hw = FLUX["generate_res"] // b.factor
    c = b.dit_cfg
    g = None if dev.type == "meta" else \
        torch.Generator(device=dev).manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    lat = randn(n, c.in_channels, hw, hw)
    cond_lat = randn(n, c.cond_channels, hw, hw)
    if b.variant == "flux":
        cond = [randn(n, 512, c.text_dim), randn(n, c.pooled_dim)]
    else:
        mask = torch.zeros(n, 512, dtype=torch.bool, device=dev)
        mask[:, :300] = True
        cond = [randn(n, 512, c.text_dim), mask,
                randn(n, 512, c.text_dim), mask]
    return [lat, torch.tensor([3], device=dev), cond_lat, *cond]


def _step_flops(variant: str, n: int) -> float:
    """One sampler step's FLOPs over n objects (FlopCounterMode on the
    meta device, the bf16 model: quantisation changes no product)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode
    from genpc_tpu_torch.models.schedulers import FlowMatchEuler
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    meta = torch.device("meta")
    mb = DiTDepthEdit(load_config(device="cuda", **dict(
        FLUX, quant_bits=0, tower_quant_bits=0)), variant=variant)
    with FlopCounterMode(display=False) as fc:
        mb.sample_step(*_step_inputs(mb, n, meta),
                       FlowMatchEuler(mb.steps, device=meta))
    return fc.get_total_flops()


def flux_params() -> None:
    """The parameter counts of the FLUX backend at full size on the meta
    device (the int4 modules counted at full precision), equal to the
    reference's; and the bytes its int4 and bf16 weights take."""
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    from genpc_tpu_torch.models.quant import logical_params
    q4 = DiTDepthEdit(load_config(device="cuda", **FLUX), variant="flux")
    counts = {k: logical_params(m) for k, m in q4.models().items()}
    log("flux parameters (meta device, at full precision): "
        + json.dumps(counts))
    if any(counts[k] != v for k, v in FLUX_PARAMS.items()):
        fail(f"flux: parameter counts differ from the reference's "
             f"{FLUX_PARAMS}")


def flux_step_flops(n: int, int4_step_ms: float) -> None:
    """One sampler step over n objects at 512² outside the pass: the FLUX
    MMDiT at quant_bits 0 and 8 (int4 is the pass's) and the Qwen MMDiT
    at int4 (its reference default; two passes a step, true CFG).  For
    each: the graph replay's time (CUDA events, median of 3 behind a
    device sleep), the FLOPs (FlopCounterMode) over it against the bf16
    peak, the peak memory of the step (weights, inputs and the graph)
    and the weight bytes; the backend is released after."""
    import gc
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    from genpc_tpu_torch.models.quant import tree_bytes
    from genpc_tpu_torch.models.schedulers import FlowMatchEuler
    flops = {v: _step_flops(v, n) for v in ("flux", "qwen")}
    log(f"flux sampler step, int4 (the pass): {flops['flux'] / 1e12:.4f} "
        f"TFLOP over {n} objects in {int4_step_ms:.3f} ms = "
        f"{flops['flux'] / int4_step_ms / 1e9:.2f} TFLOP/s, "
        f"{flops['flux'] / int4_step_ms / 1e-3 / BF16_PEAK:.4f} of the H100 "
        f"SXM's {BF16_PEAK / 1e12:.0f} TFLOP/s bf16 dense peak (data sheet)")
    for variant, bits in (("flux", 0), ("flux", 8), ("qwen", 4)):
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        b = DiTDepthEdit(load_config(device="cuda", **dict(
            FLUX, quant_bits=bits)), variant=variant)
        t0 = time.time()
        b.init_dit()
        torch.cuda.synchronize()
        init_s = time.time() - t0
        tensors = _step_inputs(b, n, b.device)
        sched = FlowMatchEuler(b.steps, device=b.device)
        with torch.inference_mode():
            ms = cuda_ms(lambda: b._step(sched, tensors), reps=3)
        peak = torch.cuda.max_memory_allocated()
        f = flops[variant]
        log(f"{variant} sampler step at quant_bits {bits} over {n} objects "
            f"at {FLUX['generate_res']}²: {ms:.3f} ms as a CUDA graph "
            f"replay (median of 3), {f / 1e12:.4f} TFLOP = "
            f"{f / ms / 1e9:.2f} TFLOP/s, {f / ms / 1e-3 / BF16_PEAK:.4f} of "
            f"the bf16 peak; MMDiT weights {tree_bytes(b.model) / 1e9:.4f} "
            f"GB (random, drawn in {init_s:.3f} s); peak allocated "
            f"{(peak - base) / 2**30:.3f} GiB above the "
            f"{base / 2**20:.1f} MiB before it")
        b.release()
        del b, tensors
    gc.collect()


# ------------------------------------------------------------ phase 9 ---

#: BASELINE config 5 as the reference deploys it: configs/lidar.yaml with
#: the reference's backends (FLUX.1-Depth-dev for the images at the int4
#: defaults, RMBG-2.0 for the mattes, TRELLIS for the meshes), every model
#: at full width
CONFIG5 = dict(LIDAR, control_model="flux", rembg_model="rmbg",
               generative_model="trellis", model_size="full")
#: CAR scans of the config-5 pass: one (sized for the host marching of a
#: random-weight 128³ TRELLIS volume, tens of seconds a pass; on the card
#: it takes a fraction of a second, and one scan keeps the script within
#: its time limit)
CONFIG5_SCANS = 1
#: the reference's parameter counts (jax.eval_shape of its full presets;
#: tests/test_torch_birefnet.py, test_torch_trellis.py and
#: test_torch_inpainters.py hold the port's to them)
CONFIG5_PARAMS = {"birefnet": 201_026_555, "trellis": 405_674_188,
                  "sf3d": 378_826_062, "ddnm": 824_754_243}


def _kept(img):
    """A known pixel as the DDNM inpainter returns it: mapped to [-1, 1]
    and back in fp32."""
    import numpy as np
    return np.clip((img * 2 - 1) / 2 + 0.5, 0, 1)


def config5_card_vs_host(tmp: str) -> None:
    """The new modules at their tiny presets on the host and on the card
    with one state dict and the same draws: the RMBG matte within
    GEN_IMAGE_TOL; TRELLIS's occupancy within IM_SDF_TOL (a voxel the
    two put on either side of 0.5 within IM_SDF_TOL of it), its SDF
    volume elsewhere within IM_SDF_TOL of the host's largest |sdf| and
    its voxel colours within IM_SDF_TOL; SF3D's SDF grid within
    IM_SDF_TOL of the largest |sdf| and its colours at the host mesh's
    vertices within IM_SDF_TOL; the DDNM paint (50 steps) within
    GEN_IMAGE_TOL with the known pixels exact; cv2 through batched_stage1
    on both devices' stage-1 arrays; trellis_2 from the registry on the
    card; and marching tetrahedra on the card bitwise equal to the
    host's."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.io.ply import load_xyz
    from genpc_tpu_torch.io.synthetic_data import write_dataset
    from genpc_tpu_torch.models.backends import get_image23d, prep_rgb
    from genpc_tpu_torch.models.ddnm import DDNMInpainter
    from genpc_tpu_torch.models.lrm import mesh_from_sdf
    from genpc_tpu_torch.models.rmbg import RMBGMatting
    from genpc_tpu_torch.models.sf3d import SF3DBackend
    from genpc_tpu_torch.models.trellis import TrellisBackend, _repeat3
    from genpc_tpu_torch.ops.marching import marching_tetrahedra
    from genpc_tpu_torch.parallel.batched_runner import batched_stage1
    from genpc_tpu_torch.pipeline.artifacts import input_artifacts
    from genpc_tpu_torch.pipeline.depth_prompting import DepthPrompting
    r = np.random.default_rng(0)

    def pair(cls):
        host = cls(load_config(device="cpu", model_size="tiny"))
        host.init_params()
        card = cls(load_config(device="cuda", model_size="tiny"))
        (model,) = host.models().values()
        card.init_params(model.state_dict())
        return host, card

    host, card = pair(RMBGMatting)
    x = torch.from_numpy(r.random((2, 3, 64, 64)).astype(np.float32) - 0.5)
    mh, mc = host.matte(x), card.matte(x.cuda()).cpu()
    gap = float((mh - mc).abs().max())
    log(f"rmbg card vs host, tiny, 2 images at 64²: matte max |d| "
        f"{gap:.3e} (tolerance {GEN_IMAGE_TOL}), matte std "
        f"{float(mh.std()):.3e}")
    if not (torch.isfinite(mc).all() and gap <= GEN_IMAGE_TOL):
        fail("rmbg card vs host: the mattes disagree")

    host, card = pair(TrellisBackend)
    imgs = np.stack([prep_rgb(r.random((48, 48, 4)).astype(np.float32),
                              host.tc.img_size) for _ in range(2)])
    x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()) * 2 - 1
    sn, ln = host.draws(2)
    outs = [[t.cpu() for t in b.generate(x.to(b.device), sn.to(b.device),
                                         ln.to(b.device))]
            for b in (host, card)]
    (sh, rh, oh), (sc, rc, oc) = outs
    flip = (oh < 0.5) != (oc < 0.5)
    keep = ~_repeat3(flip, host.tc.sdf_cells)
    occ_gap = float((oh - oc).abs().max())
    flip_gap = float((oh[flip] - 0.5).abs().max()) if flip.any() else 0.0
    sdf_gap = float((sh - sc).abs()[keep].max()) / float(sh.abs().max())
    rgb_gap = float((rh - rc).abs().max())
    log(f"trellis card vs host, tiny, 2 objects, {host.steps} steps a "
        f"flow: occupancy max |d| {occ_gap:.3e}, {int(flip.sum())} voxels "
        f"flipped (within {flip_gap:.3e} of 0.5); SDF max |d| "
        f"{sdf_gap:.3e} of max |sdf|, colours max |d| {rgb_gap:.3e} "
        f"(tolerance {IM_SDF_TOL} each)")
    if not (torch.isfinite(sc).all() and max(occ_gap, flip_gap, sdf_gap,
                                             rgb_gap) <= IM_SDF_TOL):
        fail("trellis card vs host: the volumes disagree")

    host, card = pair(SF3DBackend)
    s = host.net_cfg.img_size
    imgs = np.stack([prep_rgb(r.random((48, 48, 4)).astype(np.float32), s)
                     for _ in range(2)])
    x = torch.from_numpy(imgs.transpose(0, 3, 1, 2).copy()) * 2 - 1
    ph, gh = host.density_grid(x)
    pc, gc = card.density_grid(x.cuda())
    sdf_gap = float((gh - gc.cpu()).abs().max()) / float(gh.abs().max())
    verts, _ = mesh_from_sdf(gh[0].numpy())
    col_gap = float(np.abs(host.vertex_colors(ph[0], verts)
                           - card.vertex_colors(pc[0], verts)).max())
    log(f"sf3d card vs host, tiny, 2 objects: SDF grid max |d| "
        f"{sdf_gap:.3e} of max |sdf|, colours at {len(verts)} vertices "
        f"max |d| {col_gap:.3e} (tolerance {IM_SDF_TOL} each)")
    if not (torch.isfinite(gc).all() and sdf_gap <= IM_SDF_TOL
            and col_gap <= IM_SDF_TOL):
        fail("sf3d card vs host: the grids disagree")

    host, card = pair(DDNMInpainter)
    raw = _depth_image(seed=3, res=64)
    hole = np.zeros((3, 64, 64), np.float32)
    hole[:, 16:40, 20:52] = 1.0
    noise = host.paint_draws((1, 3, 64, 64))
    outs = []
    for inp in (host, card):
        inp.paint_draws = lambda shape, inp=inp: noise.to(inp.device)
        outs.append(inp.inpaint(raw, hole))
    known = hole.max(axis=0) < 0.5
    gap = float(np.abs(outs[0] - outs[1]).max())
    exact = all(np.array_equal(o[:, known], _kept(raw)[:, known])
                for o in outs)
    log(f"ddnm card vs host, tiny, 64², {host.steps} steps: max |d| "
        f"{gap:.3e} (tolerance {GEN_IMAGE_TOL}), known pixels exact on "
        f"both: {exact}")
    if not (np.isfinite(outs[1]).all() and gap <= GEN_IMAGE_TOL and exact):
        fail("ddnm card vs host: the paints disagree")

    flags = ["01184", "05117"]
    root = os.path.join(tmp, "tiny_cv2")
    write_dataset(root, flags, seed=3, n_gt=8192)
    stage1 = {}
    for dev in ("cuda", "cpu"):
        cfg = load_config(device=dev, **dict(TINY, inpainter="cv2"))
        arts = [input_artifacts(f, *load_xyz(os.path.join(root, f"{f}.ply")),
                                int(cfg.input_points)) for f in flags]
        batched_stage1(cfg, arts, DepthPrompting(cfg).viewpoints)
        stage1[dev] = [(a.raw_depth, a.mask, a.depth) for a in arts]
    raw_gap = max(float(np.abs(c[0] - h[0]).max())
                  for c, h in zip(stage1["cuda"], stage1["cpu"]))
    same = [(np.array_equal(c[1], h[1]), np.array_equal(c[2], h[2]))
            for c, h in zip(stage1["cuda"], stage1["cpu"])]
    log(f"cv2 through batched_stage1, tiny, 2 objects, card vs host: raw "
        f"depths max |d| {raw_gap:.3e} (the splat's rounding); (mask, "
        f"painted depth) bitwise equal by object {same}")
    if not all(all(s) for s in same):
        fail("cv2 card vs host: the masks or painted depths disagree")

    b = get_image23d("trellis_2", load_config(device="cuda",
                                               model_size="tiny"))
    m = b("01184", r.random((64, 64, 4)).astype(np.float32))
    log(f"trellis_2 from the registry on the card, tiny: variant "
        f"{b.variant!r}, a mesh of {len(m.vertices)} vertices and "
        f"{len(m.faces)} faces")
    if not (b.variant == "trellis_2" and b.device.type == "cuda"
            and np.isfinite(m.vertices).all() and len(m.faces)):
        fail("trellis_2: no mesh from the registry's backend")

    field = r.normal(size=(64, 64, 64)).astype(np.float32)
    level = float(np.median(field))
    (vc, fc), (vh, fh) = (marching_tetrahedra(f, level) for f in (
        torch.from_numpy(field).cuda(), field))
    same = np.array_equal(vc, vh) and np.array_equal(fc, fh)
    log(f"marching tetrahedra on the card vs the host, a random 64³ "
        f"field at its median: {len(vc)} vertices, {len(fc)} faces, "
        f"bitwise equal: {same}")
    if not same:
        fail("marching: the card's mesh differs from the host's")


def config5_params() -> None:
    """The parameter counts of the new modules at full size on the meta
    device, equal to the reference's."""
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.ddnm import DDNMInpainter
    from genpc_tpu_torch.models.rmbg import RMBGMatting
    from genpc_tpu_torch.models.sf3d import SF3DBackend
    from genpc_tpu_torch.models.trellis import TrellisBackend
    cfg = load_config(device="cuda", model_size="full")
    mods = {k: m for cls in (RMBGMatting, TrellisBackend, SF3DBackend,
                             DDNMInpainter)
            for k, m in cls(cfg).models().items()}
    counts = {k: sum(v.numel() for v in m.state_dict().values())
              for k, m in mods.items()}
    log("config 5 parameters (meta device; BatchNorm statistics "
        "included): " + json.dumps(counts))
    if counts != CONFIG5_PARAMS or not all(
            p.is_meta for m in mods.values() for p in m.parameters()):
        fail(f"config 5: parameter counts differ from the reference's "
             f"{CONFIG5_PARAMS}")


def drive_config5(root: str, flags, counters) -> dict:
    """BASELINE config 5: run_batched_lidar over ``flags`` (CAR scans)
    with a 60-degree held-out wedge, FLUX generating each image at 512²
    (30 steps, guidance 10.0, int4 MMDiT and T5), RMBG-2.0 matting it at
    1024², TRELLIS lifting it to a mesh (25 steps in each flow, a 128³
    SDF volume, marching tetrahedra on the host), then registration and
    fusion.  A warm-up pass and the timed pass whose launches are
    counted; both build their backends from the same seeds, so the
    images, mattes and SDF volumes of the two must be bitwise equal and
    the memory allocated after the last release() must be back at its
    level before the pass."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.trellis import TrellisBackend
    from genpc_tpu_torch.parallel import batched_runner
    from genpc_tpu_torch.pipeline.scale_adapter import ScaleAdapter
    cfg = load_config(device="cuda", **CONFIG5)
    stage1, gen = batched_runner.batched_stage1, \
        batched_runner._generate_images
    stage2 = ScaleAdapter.scale_adapter_batch
    generate, flow = TrellisBackend.generate, TrellisBackend._flow
    release = batched_runner._release_backend
    passes = []

    def rec_stage1(cfg, arts, viewpoints, core=None, dp=None, mesh=None):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        passes.append(dict(base=torch.cuda.memory_allocated(), after={},
                           spans={}, flows=[], sdf=[], t0=time.time()))
        stage1(cfg, arts, viewpoints, core=core, dp=dp, mesh=mesh)

    def rec_gen(cfg, dp, arts):
        _, passes[-1]["spans"]["depth2image"] = _with_spans(
            lambda: gen(cfg, dp, arts))
        passes[-1]["images"] = [np.array(a.image) for a in arts]

    def rec_stage2(self, arts):
        _, passes[-1]["spans"]["stage2"] = _with_spans(
            lambda: stage2(self, arts))
        rec = passes[-1]
        rec["mattes"] = [np.array(a.image_nobg[..., 3]) for a in arts]
        rec["meshes"] = [(len(a.complete_mesh.vertices),
                          len(a.complete_mesh.faces)) for a in arts]
        rec["arts"] = arts

    def rec_generate(self, imgs, struct_noise, slat_noise):
        out = generate(self, imgs, struct_noise, slat_noise)
        passes[-1]["sdf"].append(out[0].cpu().numpy())
        return out

    def rec_flow(self, name, x, tok, extra, sched):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = flow(self, name, x, tok, extra, sched)
        end.record()
        passes[-1]["flows"].append((name, start, end, sched.num_steps))
        return out

    def rec_release(owner, attr):
        backend = getattr(owner, attr, None)
        release(owner, attr)
        if backend is not None and attr in ("depth2image", "rembg",
                                            "image23d"):
            torch.cuda.synchronize()
            rec = passes[-1]
            rec["after"][attr] = torch.cuda.memory_allocated()
            rec["peak"] = torch.cuda.max_memory_allocated()

    def one_pass():
        return batched_runner.run_batched_lidar(cfg, flags, root, "CAR",
                                                holdout_wedge_deg=60.0)

    with patched((batched_runner, "batched_stage1", rec_stage1),
                 (batched_runner, "_generate_images", rec_gen),
                 (ScaleAdapter, "scale_adapter_batch", rec_stage2),
                 (TrellisBackend, "generate", rec_generate),
                 (TrellisBackend, "_flow", rec_flow),
                 (batched_runner, "_release_backend", rec_release)):
        t0 = time.time()
        one_pass()
        log(f"config5: warm-up pass {time.time() - t0:.2f} s")
        results, wall, launches = _counted("config5", counters, one_pass)
    warm, timed = passes
    torch.cuda.synchronize()
    b = len(flags)
    flows = {}
    for name, s, e, n in timed["flows"]:
        flows[name] = [round(s.elapsed_time(e), 3), n]
    log(f"config5 (FLUX -> RMBG-2.0 -> TRELLIS, {b} CAR scan(s), "
        f"held-out wedge 60°): timed pass {wall:.3f} s, "
        f"{b / wall * 60:.3f} objects/min; TRELLIS flows (ms for the "
        f"loop incl. its first step's graph capture, steps; CUDA events) "
        + json.dumps(flows))
    for stage, spans in timed["spans"].items():
        log(f"config5: {stage} spans (s; counters) " + json.dumps(
            {k: round(v, 4) for k, v in spans.items()}))
    gib = 2 ** 30
    log(f"config5: peak allocated over the pass {timed['peak'] / gib:.3f} "
        f"GiB; memory allocated {timed['base'] / 2**20:.1f} MiB before "
        f"the pass, " + ", ".join(f"{m / 2**20:.1f} MiB after {a}.release()"
                                  for a, m in timed["after"].items()))
    log("config5: meshes (vertices, faces) by scan, warm-up | timed: "
        + json.dumps({f: [list(w), list(t)] for f, w, t in zip(
            flags, warm["meshes"], timed["meshes"])}))
    for f in flags:
        log(f"  {f}: UHD x100 {results[f]['uhd'] * 100:.4f}, held-out UHD "
            f"x100 {results[f].get('holdout_uhd', float('nan')) * 100:.4f}")
    vals = [v for f in flags for v in results[f].values()]
    if set(results) != set(flags) or not np.isfinite(vals).all() or \
            not all("holdout_uhd" in results[f] for f in flags):
        fail("config5: a missing scan, held-out wedge or non-finite UHD")
    same = {k: all(np.array_equal(x, y) for x, y in zip(warm[k], timed[k]))
            for k in ("images", "mattes", "sdf")}
    log(f"config5: warm-up and timed passes bitwise equal: "
        + json.dumps(same))
    if not all(same.values()):
        fail("config5: the two passes differ")
    if timed["after"]["rembg"] - timed["base"] > RELEASE_SLACK:
        fail("config5: the releases left their backends' memory "
             "allocated")
    return {"results": results, "launches": launches, "wall": wall,
            "arts": timed["arts"]}


def _graph_ms(cache: dict, key: tuple, fn, tensors, device) -> float:
    """One call's time as a CUDA graph replay (median of 5, behind a
    device sleep), the graph captured first."""
    import torch
    from genpc_tpu_torch.models.graphs import graphed_call
    with torch.inference_mode():
        graphed_call(cache, key, fn, tensors, device)
        return cuda_ms(lambda: graphed_call(cache, key, fn, tensors,
                                            device), reps=5)


def _meta_flops(fn) -> float:
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn()
    return fc.get_total_flops()


def config5_step_flops() -> None:
    """At full width outside the pass, on seeded inputs: one TRELLIS
    structure-flow step (4,096 tokens) and one SLAT-flow step (32,768
    tokens) as CUDA graph replays, and one RMBG-2.0 forward at 1024²
    (eager): each one's time (CUDA events), FLOPs (FlopCounterMode on the
    meta device) and their rate against the bf16 peak, and the peak
    memory; each backend released after."""
    import gc
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.rmbg import RMBGMatting
    from genpc_tpu_torch.models.schedulers import FlowMatchEuler
    from genpc_tpu_torch.models.trellis import TrellisBackend
    dev, meta = torch.device("cuda"), torch.device("meta")
    cfg = load_config(device="cuda", model_size="full")
    b, mb = TrellisBackend(cfg), TrellisBackend(cfg)
    b.init_params()
    tc = b.tc
    g = torch.Generator(device=dev).manual_seed(0)

    def inputs(device, name):
        def randn(*shape):
            return torch.randn(shape, device=device,
                               generator=g if device == dev else None)
        n_tok = (tc.img_size // tc.patch) ** 2
        tok = randn(1, n_tok, tc.img_dim)
        if name == "struct":
            return [randn(1, tc.struct_res ** 3, 1),
                    torch.tensor([3], device=device), tok]
        return [randn(1, tc.slat_res ** 3, tc.slat_dim),
                torch.tensor([3], device=device), tok,
                torch.rand(1, tc.slat_res ** 3, 1, device=device)]

    for name in ("struct", "slat"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        sched = FlowMatchEuler(b.steps, device=dev)
        model = getattr(b.net, f"{name}_flow")
        ms = _graph_ms(
            b._graphs, (name, b.steps),
            lambda x, i, tok, *e, m=model, s=sched: b.flow_step(
                m, x, i, tok, e[0] if e else None, s),
            inputs(dev, name), dev)
        peak = torch.cuda.max_memory_allocated()
        msched = FlowMatchEuler(b.steps, device=meta)
        mm = getattr(mb.net, f"{name}_flow")
        t = inputs(meta, name)
        flops = _meta_flops(lambda: mb.flow_step(
            mm, t[0], t[1], t[2], t[3] if len(t) > 3 else None, msched))
        log(f"trellis {name} flow step, one object ({t[0].shape[1]} "
            f"tokens): {ms:.3f} ms as a CUDA graph replay (median of 5), "
            f"{flops / 1e12:.4f} TFLOP = {flops / ms / 1e9:.2f} TFLOP/s, "
            f"{flops / ms / 1e-3 / BF16_PEAK:.4f} of the H100 SXM's "
            f"{BF16_PEAK / 1e12:.0f} TFLOP/s bf16 dense peak; {b.steps} "
            f"steps {b.steps * ms / 1e3:.3f} s; peak allocated "
            f"{peak / 2**30:.3f} GiB")
    b.release()
    del b
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    r, mr = RMBGMatting(cfg), RMBGMatting(cfg)
    r.init_params()
    s = r.net_cfg.img_size
    x = torch.rand((1, 3, s, s), device=dev, generator=g) - 0.5
    ms = cuda_ms(lambda: r.matte(x), reps=3)
    peak = torch.cuda.max_memory_allocated()
    with torch.inference_mode():
        flops = _meta_flops(lambda: mr.net(torch.empty((1, 3, s, s),
                                                       device=meta)))
    log(f"rmbg forward at {s}² (Swin-v1-Large BiRefNet, eager): {ms:.3f} "
        f"ms (median of 3), {flops / 1e12:.4f} TFLOP = "
        f"{flops / ms / 1e9:.2f} TFLOP/s, {flops / ms / 1e-3 / BF16_PEAK:.4f}"
        f" of the bf16 peak; peak allocated {peak / 2**30:.3f} GiB")
    r.release()
    gc.collect()


def drive_sf3d_full(run: dict) -> None:
    """SF3DBackend.generate_meshes_batch at full width over one image (the
    config-5 pass's matted image): the device program's time (the
    triplanes and the 96³ SDF grid; CUDA events), the host marching's
    seconds, the mesh's vertices and faces, and the peak memory; then
    release()."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.sf3d import SF3DBackend
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    b = SF3DBackend(load_config(device="cuda", model_size="full"))
    art = run["arts"][0]
    b.init_params()
    grid = b.density_grid
    ev = []

    def timed_grid(images):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = grid(images)
        end.record()
        ev.append((start, end))
        return out

    b.density_grid = timed_grid
    t0 = time.time()
    (mesh,), spans = _with_spans(lambda: b.generate_meshes_batch(
        [art.flag], [art.image_nobg]))
    wall = time.time() - t0
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    spans = {k: round(v, 4) for k, v in spans.items()}
    log(f"sf3d at full width, one image: {wall:.3f} s; the device "
        f"program (triplanes, {b.net_cfg.grid_res}³"
        f" SDF grid) {ev[-1][0].elapsed_time(ev[-1][1]):.3f} ms (CUDA "
        f"events); a mesh of {len(mesh.vertices)} vertices and "
        f"{len(mesh.faces)} faces; spans (s; counters) "
        + json.dumps(spans) + f"; peak allocated {peak / 2**30:.3f} GiB")
    b.release()
    torch.cuda.synchronize()
    if not (np.isfinite(mesh.vertices).all() and len(mesh.faces)):
        fail("sf3d: no finite mesh")
    if torch.cuda.memory_allocated() - base > RELEASE_SLACK:
        fail("sf3d: release() left its memory allocated")


def drive_ddnm_full(run: dict) -> None:
    """One DDNM paint at full width (the base UNet's widths in pixel
    space, 50 DDIM steps, a CUDA graph a step) of the config-5 pass's
    stage-1 raw depth at res² over its hole mask: the paint's time and
    a step's as a graph replay (CUDA events), its FLOPs (FlopCounterMode
    on the meta device) against the bf16 peak, the known pixels exact
    and the peak memory; then release()."""
    import numpy as np
    import torch
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.ddnm import DDNMInpainter
    from genpc_tpu_torch.models.schedulers import DDIM
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    cfg = load_config(device="cuda", model_size="full")
    inp, minp = DDNMInpainter(cfg), DDNMInpainter(cfg)
    art = run["arts"][0]
    raw, hole = art.raw_depth, art.mask.max(axis=0)
    inp.init_params()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = inp.inpaint(raw, hole)
    end.record()
    torch.cuda.synchronize()
    paint_ms = start.elapsed_time(end)
    (graph,) = inp._graphs.values()
    with torch.inference_mode():
        step_ms = cuda_ms(lambda: graph(graph.bufs), reps=5)
    peak = torch.cuda.max_memory_allocated()
    meta = torch.device("meta")
    res = raw.shape[-1]
    t = [torch.empty((1, 3, res, res), device=meta),
         torch.tensor([3], device=meta),
         torch.empty((1, 3, res, res), device=meta),
         torch.empty((1, 1, res, res), device=meta),
         torch.empty((1, 1, inp.unet_cfg.context_dim), device=meta)]
    with torch.inference_mode():
        flops = _meta_flops(lambda: minp.step(*t, DDIM(inp.steps,
                                                       device=meta)))
    known = hole < 0.5
    exact = bool(np.array_equal(out[:, known], _kept(raw)[:, known]))
    log(f"ddnm at full width, one {res}² depth, {inp.steps} steps: "
        f"{paint_ms:.3f} ms (CUDA events; the first step captures its "
        f"graph); a step {step_ms:.3f} ms as a graph replay (median of "
        f"5), {flops / 1e12:.4f} TFLOP = {flops / step_ms / 1e9:.2f} "
        f"TFLOP/s, {flops / step_ms / 1e-3 / BF16_PEAK:.4f} of the bf16 "
        f"peak; {int((~known).sum())} hole pixels; known pixels exact: "
        f"{exact}; peak allocated {peak / 2**30:.3f} GiB")
    inp.release()
    torch.cuda.synchronize()
    if not (np.isfinite(out).all() and exact):
        fail("ddnm: a non-finite paint or a known pixel changed")
    if torch.cuda.memory_allocated() - base > RELEASE_SLACK:
        fail("ddnm: release() left its memory allocated")


# ----------------------------------------------------------- phase 10 ---

#: the dp size of each mesh pass over the 13 objects: the aligned path at
#: dp = 4 (padded to 16), the registration path at dp = 2 (padded to 14),
#: every shard on cuda:0 (a second card, where there is one, in
#: drive_mesh_cards)
MESH_DP = {"aligned": 4, "registration": 2}
#: a mesh pass's per-object CD×100 and EMD×100 against phase 4's
#: unsharded pass: each shard's launches see fewer objects, so sums may
#: take another order
MESH_TOL = 1e-3
#: the pose renderer's size (224², N = 2,048) and the scatter's footprint
SCATTER_SIZE = (224, 2048, 3)


def drive_mesh(path: str, root: str, flags, counters, unsharded: dict,
               devices=None) -> dict:
    """run_batched of one path with cfg.mesh_shape {'dp': k}: one pass,
    its launches counted; each object's CD×100 / EMD×100 against the
    unsharded pass of phase 4."""
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.parallel import batched_runner
    k = MESH_DP[path]
    devices = devices or ["cuda:0"] * k
    label = f"mesh_{path}"
    cfg = load_config(device="cuda", mesh_shape={"dp": k},
                      mesh_devices=devices, **dict(
                          REDWOOD, trust_aligned_completion=(path ==
                                                             "aligned")))
    timings = {}
    results, wall, launches = _counted(
        f"{label} (dp={k} over {','.join(devices)})", counters,
        lambda: batched_runner.run_batched(cfg, flags, root,
                                           timings=timings))
    pad = (-len(flags)) % k
    log(f"{label}: one pass over {len(flags)} objects padded to "
        f"{len(flags) + pad}, {wall:.3f} s ({len(flags) / wall * 60:.3f} "
        f"objects/min; the unsharded timed pass {unsharded['wall']:.3f} s); "
        f"stage walls (s): " + json.dumps({n: round(v, 4)
                                          for n, v in timings.items()}))
    if set(results) != set(flags):
        fail(f"{label}: the results hold {sorted(results)}")
    worst, bitwise = 0.0, True
    for f in flags:
        a, b = unsharded["results"][f], results[f]
        d = max(abs(a[m] - b[m]) * 100 for m in ("cd", "emd"))
        worst = max(worst, d)
        bitwise &= a == b
        log(f"  {f}: CD x100 {b['cd'] * 100:.6f} / EMD x100 "
            f"{b['emd'] * 100:.6f} (unsharded {a['cd'] * 100:.6f} / "
            f"{a['emd'] * 100:.6f})")
    log(f"{label}: max |d| of CD x100 and EMD x100 against the unsharded "
        f"pass {worst:.3e}; bitwise equal: {bitwise}")
    if worst > MESH_TOL:
        fail(f"{label}: {worst:.3e} from the unsharded pass (> {MESH_TOL})")
    return {"results": results, "launches": launches, "wall": wall,
            "timings": timings, "max_abs_d": worst, "bitwise": bitwise}


def mesh_checks(root: str, flags) -> None:
    """The mesh API on the card: make_mesh over a repeated cuda:0 and its
    error; evaluate_pair at 16,384 points with sp = 4 against the
    unsharded CD (1e-5); sharded_chamfer_l1 at 16,384 × 16,384 with sp =
    4 (its time against the unsharded chamfer); the tp = 2 tiny MMDiT
    forward (fp32 compute) against the unsharded one (1e-5); one
    batched_pose_step at dp = 4 over 8 objects, card against host
    (losses and parameters within 1e-4)."""
    import numpy as np
    import torch
    from genpc_tpu_torch.io.ply import load_xyz
    from genpc_tpu_torch.metrics.losses import chamfer_l1
    from genpc_tpu_torch.metrics.metric import evaluate_pair
    from genpc_tpu_torch.models.dit import DiTConfig, MMDiT
    from genpc_tpu_torch.models.weights import materialize
    from genpc_tpu_torch.parallel import mesh as pm
    n_dev = torch.cuda.device_count()
    mesh = pm.make_mesh({"dp": 4}, ["cuda:0"] * 4)
    log(f"mesh: make_mesh({{'dp': 4}}) over cuda:0 x 4: axes "
        f"{mesh.axis_names}, shape {mesh.shape}")
    try:
        pm.make_mesh({"dp": n_dev + 1})
    except ValueError as e:
        log(f"mesh: make_mesh({{'dp': {n_dev + 1}}}) over the {n_dev} "
            f"card(s): ValueError ({e})")
    else:
        fail("mesh: make_mesh did not raise on too few devices")

    gt, _ = load_xyz(os.path.join(root, "GT", f"{flags[0]}.ply"))
    pred = gt[np.random.default_rng(0).choice(len(gt), 19728,
                                              replace=False)]
    pred = pred + np.random.default_rng(1).normal(
        0, 0.01, pred.shape).astype(np.float32)
    sp = pm.make_mesh({"sp": 4}, ["cuda:0"] * 4)
    one = evaluate_pair(pred, gt, with_emd=False, device="cuda")
    four = evaluate_pair(pred, gt, with_emd=False, mesh=sp, device="cuda")
    d = abs(one["cd"] - four["cd"])
    log(f"mesh: evaluate_pair at 16,384 points, sp=4: CD {four['cd']:.9f} "
        f"against {one['cd']:.9f} unsharded, |d| {d:.3e}")
    if d > 1e-5:
        fail("mesh: the sp-sharded CD leaves 1e-5 of the unsharded one")
    r = np.random.default_rng(2)
    x = torch.tensor(r.random((16384, 3)), dtype=torch.float32,
                     device="cuda")
    y = torch.tensor(r.random((16384, 3)), dtype=torch.float32,
                     device="cuda")
    sh = pm.sharded_chamfer_l1(x, y, sp)
    ref = chamfer_l1(x[None], y[None])
    ms = cuda_ms(lambda: pm.sharded_chamfer_l1(x, y, sp), reps=5)
    ms1 = cuda_ms(lambda: chamfer_l1(x[None], y[None]), reps=5)
    d = abs(float(sh) - float(ref))
    log(f"mesh: sharded_chamfer_l1 16,384 x 16,384, sp=4 over one card: "
        f"{float(sh):.9f}, |d| {d:.3e} from the unsharded chamfer; "
        f"{ms:.3f} ms against {ms1:.3f} ms")
    if d > 1e-5:
        fail("mesh: sharded_chamfer_l1 leaves 1e-5 of the chamfer")

    with torch.device("meta"):
        model = MMDiT(DiTConfig.preset("tiny"))
    materialize(model, "cuda", torch.float32, seed=0)
    for m in model.modules():
        if hasattr(m, "compute"):
            m.compute = torch.float32
    out2, n = pm.tp_sharded_dit_forward(
        pm.make_mesh({"tp": 2}, ["cuda:0"] * 2), model=model)
    out1, _ = pm.tp_sharded_dit_forward(
        pm.make_mesh({"tp": 1}, ["cuda:0"]), model=model)
    d = (out2 - out1).abs().max().item()
    v = out1.abs().max().item()
    log(f"mesh: tp_sharded_dit_forward tp=2 (tiny, fp32, seeded random "
        f"weights, the reference's zero inputs): {n} layers split, max |d| "
        f"{d:.3e} from the unsharded forward, max |v| {v:.4e}")
    if d > 1e-5 * v or n != 40:
        fail("mesh: the tp forward leaves 1e-5 of the unsharded one")

    outs = {}
    for dev in ("cuda:0", "cpu"):
        step, make_example, shardings = pm.batched_pose_step(
            pm.make_mesh({"dp": 4}, [dev] * 4))
        params, opt, comp, col, part, size = make_example(batch=8)
        t0 = time.time()
        p, _, loss = step(*shardings(params, opt, comp, col, part), 0.05,
                          size)
        outs[dev] = (torch.cat(loss).cpu(),
                     {k: torch.cat([q[k] for q in p]).cpu() for k in p[0]})
        log(f"mesh: batched_pose_step dp=4, batch 8 on {dev}: "
            f"{time.time() - t0:.3f} s")
    (lc, pc), (lh, ph) = outs["cuda:0"], outs["cpu"]
    d = max([(lc - lh).abs().max().item()]
            + [(pc[k] - ph[k]).abs().max().item() for k in pc])
    log(f"mesh: batched_pose_step card against host: losses "
        f"{[round(v, 5) for v in lc.tolist()]}, max |d| {d:.3e}")
    if d > 1e-4 or not torch.isfinite(lc).all():
        fail("mesh: batched_pose_step card leaves 1e-4 of host")


def scatter_checks() -> None:
    """The footprint-scatter renderer at the pose size (224², N = 2,048,
    footprint 3): card against host, deterministic=True bitwise equal
    over two calls and within 1e-5 of the float sums; its forward and
    forward+backward times against the slots renderer (K4, K4+K5) at the
    pose path's footprint 2."""
    import numpy as np
    import torch
    from genpc_tpu_torch.render.point_renderer import (RenderCamera,
                                                       render_points)
    res, n, f = SCATTER_SIZE
    r = np.random.default_rng(3)
    pts_h = torch.tensor(r.normal(size=(n, 3)) * 0.3, dtype=torch.float32)
    cols_h = torch.tensor(r.random((n, 3)), dtype=torch.float32)
    pts, cols = pts_h.cuda(), cols_h.cuda()
    cam = RenderCamera.default(res)
    img = {}
    for det in (False, True):
        a = render_points(pts, cols, 0.02, cam, footprint=f,
                          deterministic=det)
        b = render_points(pts, cols, 0.02, cam, footprint=f,
                          deterministic=det)
        h = render_points(pts_h, cols_h, 0.02, cam, footprint=f,
                          deterministic=det)
        d = (a.cpu() - h).abs().max().item()
        img[det] = a
        log(f"scatter {res}², N {n}, f {f}, deterministic={det}: card "
            f"against host max |d| {d:.3e}; two card calls bitwise equal: "
            f"{torch.equal(a, b)}")
        if d > 1e-5:
            fail("scatter: card leaves 1e-5 of host")
        if det and not torch.equal(a, b):
            fail("scatter: deterministic=True does not repeat bitwise")
    d = (img[True] - img[False]).abs().max().item()
    log(f"scatter: fixed-point against float sums max |d| {d:.3e}")
    if d > 1e-5:
        fail("scatter: deterministic sums leave 1e-5 of the float sums")

    def fwd(method, fp, det=False):
        return lambda: render_points(pts, cols, 0.02, cam, footprint=fp,
                                     method=method, deterministic=det)

    def fwd_bwd(method, fp, det=False):
        def run():
            p = pts.detach().requires_grad_(True)
            render_points(p, cols, 0.02, cam, footprint=fp, method=method,
                          deterministic=det).square().sum().backward()
        return run

    times = {f"scatter f{f} forward": cuda_ms(fwd("scatter", f), 5),
             f"scatter f{f} forward+backward": cuda_ms(
                 fwd_bwd("scatter", f), 5),
             f"scatter f{f} deterministic forward+backward": cuda_ms(
                 fwd_bwd("scatter", f, True), 5),
             "scatter f2 forward+backward": cuda_ms(fwd_bwd("scatter", 2),
                                                    5),
             "slots f2 forward (table + K4)": cuda_ms(fwd("slots", 2), 5),
             "slots f2 forward+backward (K4 + K5)": cuda_ms(
                 fwd_bwd("slots", 2), 5)}
    log("scatter time (one render, CUDA events): " + json.dumps(
        {k: round(v, 4) for k, v in times.items()}))


def toolkit_checks(root: str, flags) -> None:
    """The toolkit modules, card against host: apml_loss, eval_sh, the
    morphology, edge and bilateral filters and SSIM at 1024², densify
    and estimate_normals at 16,384 points, poisson_reconstruct at 96³."""
    import numpy as np
    import torch
    from genpc_tpu_torch.geometry import densify, mesh_utils, sh
    from genpc_tpu_torch.io.ply import load_xyz
    from genpc_tpu_torch.metrics import image_metrics
    from genpc_tpu_torch.metrics.losses import apml_loss
    from genpc_tpu_torch.render import image_ops
    r = np.random.default_rng(4)

    def both(name, fn, *arrays, tol=1e-5, rel=True):
        t0 = time.time()
        card = fn(*(torch.as_tensor(a).cuda() for a in arrays))
        torch.cuda.synchronize()
        t_card = time.time() - t0
        t0 = time.time()
        host = fn(*(torch.as_tensor(a) for a in arrays))
        t_host = time.time() - t0
        card = card.float().cpu() if torch.is_tensor(card) \
            else torch.as_tensor(card)
        host = torch.as_tensor(host).float()
        if card.shape != host.shape:
            fail(f"toolkit {name}: card shape {tuple(card.shape)}, host "
                 f"{tuple(host.shape)}")
        d = (card - host).abs().max().item()
        scale = max(host.abs().max().item(), 1.0) if rel else 1.0
        log(f"toolkit {name}: card against host max |d| {d:.3e} (bound "
            f"{tol * scale:.1e}); card {t_card:.3f} s, host {t_host:.3f} s")
        if d > tol * scale:
            fail(f"toolkit {name}: card leaves the host")

    a = (r.normal(size=(2, 2048, 3)) * 0.2).astype(np.float32)
    b = (r.normal(size=(2, 2048, 3)) * 0.2).astype(np.float32)
    both("apml_loss [2,2048]x[2,2048]", apml_loss, a, b)
    coeffs = r.normal(size=(16384, 3, 25)).astype(np.float32)
    dirs = r.normal(size=(16384, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    both("eval_sh deg 4 [16384,3,25]", lambda c, d: sh.eval_sh(4, c, d),
         coeffs, dirs)
    mask = (r.random((1024, 1024)) < 0.3).astype(np.float32)
    img = r.random((1024, 1024, 3)).astype(np.float32)
    img2 = np.clip(img + r.normal(0, 0.05, img.shape), 0, 1).astype(
        np.float32)
    both("dilate 1024²", lambda m: image_ops.dilate(m, 2), mask, tol=0)
    both("erode 1024²", lambda m: image_ops.erode(m, 2), mask, tol=0)
    both("fill_hole 1024²", image_ops.fill_hole, mask, tol=0)
    both("scharr_edges 1024²", image_ops.scharr_edges, img)
    both("bilateral_filter 1024²", image_ops.bilateral_filter, img)
    both("ssim 1024²", image_metrics.ssim, img, img2)
    gt, _ = load_xyz(os.path.join(root, "GT", f"{flags[0]}.ply"))
    pts = gt[r.choice(len(gt), 16384, replace=False)].astype(np.float32)
    both("densify.linear_interpolation 16,384",
         lambda p: densify.linear_interpolation(
             p.cpu().numpy(), device=p.device)[0], pts, tol=0)
    both("estimate_normals 16,384",
         lambda p: mesh_utils.estimate_normals(p.cpu().numpy(),
                                               device=p.device), pts, tol=0)
    both("poisson_reconstruct 96³ (vertices)",
         lambda p: mesh_utils.poisson_reconstruct(
             p.cpu().numpy(), grid_res=96, device=p.device).vertices,
         pts, tol=0)


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
    report = {"chamfer_nn": check_k1(dev)[0], "fps": check_k2(dev)[0],
              "emd_bid": check_k3(dev), **check_k4_k5(dev)}
    check_k3(dev, K3_SHAPE_1)
    check_k3(dev, K3_SHAPE_IM)
    for shape in K3_SHAPES_DP:
        check_k3(dev, shape)
    k6 = check_k6(dev)
    for name, path in (("w4_gemm", "tensor_core"), ("w4_gemv", "cuda_core")):
        report[name] = {"classes": [r for r in k6 if r["path"] == path]}

    # 4. the main paths
    from genpc_tpu_torch.categories import REDWOOD_FLAGS
    from genpc_tpu_torch.io.synthetic_data import (write_dataset,
                                                   write_lidar_dataset)
    counters = {name: wrapper(spec) for name, spec, _, _ in KERNELS}
    flags = list(REDWOOD_FLAGS)
    runs = {}
    with tempfile.TemporaryDirectory(prefix="genpc_smoke_") as tmp:
        for seed in (1, 2):
            small_input_check(tmp, seed)
            small_input_check_per_object(tmp, seed)
        root = os.path.join(tmp, "redwood_synthetic")
        t0 = time.time()
        write_dataset(root, flags, seed=0)
        log(f"data: {len(flags)} synthetic objects written in "
            f"{time.time() - t0:.1f} s")
        for name in ("aligned", "registration"):
            runs[name] = drive(name, root, flags, counters)
        runs["per_object"] = drive_per_object(
            root, flags[:PER_OBJECT_FLAGS], counters)
        wroot = os.path.join(tmp, "waymo_synthetic")
        t0 = time.time()
        scans = write_lidar_dataset(wroot, {"CAR": LIDAR_SCANS,
                                            "PED": LIDAR_SCANS}, seed=0)
        log(f"data: {LIDAR_SCANS} CAR and {LIDAR_SCANS} PED LiDAR-like "
            f"scans written in {time.time() - t0:.1f} s")
        runs["lidar_car"] = drive_lidar(wroot, scans["CAR"], "CAR", LIDAR,
                                        counters, warm=True)
        runs["lidar_ped"] = drive_lidar(wroot, scans["PED"], "PED",
                                        LIDAR_PED, counters, warm=False,
                                        attribute=True)
        runs["run_lidar"] = drive_run_lidar(wroot, scans["CAR"][:2],
                                            counters)
        # 5. generation
        generation_card_vs_host()
        runs["controlnet"] = drive_controlnet(root, flags, counters)
        drive_generate_standalone()
        # 6. image-to-3D
        instantmesh_card_vs_host()
        runs["instantmesh"] = drive_instantmesh(root, flags[:IM_OBJECTS],
                                                counters)
        instantmesh_real_surface(root, runs["instantmesh"])
        # the pass's chunk, and one chunk over all 13 objects: the largest
        # image23d_batch a run of them can use
        instantmesh_step_flops((IM_OBJECTS, len(flags)),
                               runs["instantmesh"]["max_verts"])
        # 7. Qwen-Image-Edit, alone and ahead of InstantMesh
        qwen_card_vs_host()
        runs["qwen"] = drive_qwen(root, flags, counters)
        qwen_step_flops(QWEN["generate_obj_batch"], runs["qwen"]["step_ms"])
        runs["config4"] = drive_config4(root, flags[:CONFIG4_OBJECTS],
                                        counters)
        # 8. FLUX: the inpainter and FLUX.1-Depth-dev at their int4 defaults
        flux_card_vs_host()
        flux_params()
        runs["flux"] = drive_flux(root, flags[:FLUX_OBJECTS], counters)
        flux_step_flops(FLUX_OBJECTS, runs["flux"]["step_ms"])
        # 9. BASELINE config 5 (FLUX -> RMBG-2.0 -> TRELLIS) and the other
        # modules of its slice (SF3D, DDNM, cv2)
        config5_card_vs_host(tmp)
        config5_params()
        runs["config5"] = drive_config5(wroot, scans["CAR"][:CONFIG5_SCANS],
                                        counters)
        config5_step_flops()
        drive_sf3d_full(runs["config5"])
        drive_ddnm_full(runs["config5"])
        # 10. the multi-device path and the toolkit modules
        for name in ("aligned", "registration"):
            runs[f"mesh_{name}"] = drive_mesh(name, root, flags, counters,
                                              runs[name])
        if torch.cuda.device_count() >= 2:
            runs["mesh_registration_cards"] = drive_mesh(
                "registration", root, flags, counters, runs["registration"],
                devices=["cuda:0", "cuda:1"])
        mesh_checks(root, flags)
        scatter_checks()
        toolkit_checks(root, flags)
        if "--profile" in sys.argv[1:]:
            profile_pass(root, flags)
    if not runs["registration"]["repeat"]:
        fail("registration: the two passes disagree: the pose path is not "
             "bitwise repeatable")
    log("per object: CD x100 / EMD x100, aligned | registration")
    for f in flags:
        a, r = runs["aligned"]["results"][f], \
            runs["registration"]["results"][f]
        log(f"  {f}: {a['cd'] * 100:.4f} / {a['emd'] * 100:.4f} | "
            f"{r['cd'] * 100:.4f} / {r['emd'] * 100:.4f}")
    for name in ("aligned", "registration", "per_object"):
        res = runs[name]["results"].values()
        log(f"{name}: mean CD x100 "
            f"{sum(m['cd'] for m in res) / len(res) * 100:.4f}, mean EMD "
            f"x100 {sum(m['emd'] for m in res) / len(res) * 100:.4f} over "
            f"{len(res)} objects")

    log(smi)
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": runs["registration"]["launches"][name],
         "launches_by_path": {path: run["launches"][name]
                              for path, run in runs.items()},
         **report[name]}
        for name, _spec, src, rep in KERNELS]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
