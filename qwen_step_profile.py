#!/usr/bin/env python3
"""Where one full-width Qwen-Image-Edit sampler step spends its time on
one NVIDIA GPU.

    python3 qwen_step_profile.py [--objects N]

Builds the MMDiT and VAE of ``chip_smoke.QWEN`` (bf16 seeded random
weights) on the card and, over N objects (13 by default; seeded latents,
condition latents, 512-token text features with 300 valid tokens), runs
one sampler step (a conditional and an unconditional pass, true CFG,
the Euler step) and prints: the step as a CUDA graph replay and eagerly
(CUDA events, ``chip_smoke.cuda_ms``), SDPA alone at the step's shapes
with and without the key mask, and the device time by operator and
kernel of one eager step (``torch.profiler``).  Exits non-zero without
a CUDA device.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--objects", type=int, default=13)
    n = ap.parse_args().objects
    sys.path.insert(0, HERE)
    import torch
    if not torch.cuda.is_available():
        print("torch.cuda.is_available() is False: this profile needs an "
              "NVIDIA GPU", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke as cs
    from genpc_tpu_torch.config import load_config
    from genpc_tpu_torch.models.dit_depth import DiTDepthEdit
    from genpc_tpu_torch.models.schedulers import FlowMatchEuler
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda")
    b = DiTDepthEdit(load_config(device="cuda", **cs.QWEN))
    b.init_dit()
    cfg = b.dit_cfg
    hw = cs.QWEN["generate_res"] // b.factor
    g = torch.Generator(device=dev).manual_seed(0)
    lat = torch.randn(n, cfg.in_channels, hw, hw, generator=g, device=dev)
    cond = torch.randn(n, cfg.cond_channels, hw, hw, generator=g,
                       device=dev)
    txt = torch.randn(n, b.txt_budget, cfg.text_dim, generator=g,
                      device=dev)
    mask = torch.zeros(n, b.txt_budget, dtype=torch.bool, device=dev)
    mask[:, :300] = True
    sched = FlowMatchEuler(b.steps, device=dev)
    tensors = [lat, torch.tensor([3], device=dev), cond, txt, mask, txt,
               mask]
    with torch.inference_mode():
        ms = cs.cuda_ms(lambda: b._step(sched, tensors), reps=3)
        eager = cs.cuda_ms(lambda: b.sample_step(*tensors, sched), reps=1)
        print(f"a sampler step over {n} objects: {ms:.3f} ms as a CUDA "
              f"graph replay (median of 3), {eager:.3f} ms eager")
        t = 2 * (hw // cfg.patch_size) ** 2 + b.txt_budget
        dh = cfg.head_dim
        q = torch.randn(n, cfg.num_heads, t, dh, device=dev,
                        dtype=torch.bfloat16)
        key_mask = torch.ones(n, 1, 1, t, dtype=torch.bool, device=dev)
        flops = 4 * n * cfg.num_heads * t * t * dh
        for label, m in (("with the key mask", key_mask),
                         ("without a mask", None)):
            a_ms = cs.cuda_ms(lambda: F.scaled_dot_product_attention(
                q, q, q, attn_mask=m), reps=5)
            print(f"SDPA [{n}, {cfg.num_heads}, {t}, {dh}] bf16 {label}: "
                  f"{a_ms:.3f} ms, {flops / a_ms / 1e9:.1f} TFLOP/s")
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            b.sample_step(*tensors, sched)
            torch.cuda.synchronize()
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=30,
                                    max_name_column_width=70))
    return 0


if __name__ == "__main__":
    sys.exit(main())
