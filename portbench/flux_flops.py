"""The closed-form FLOPs of FLUX.1-Depth-dev's MMDiT in a pass of the
port, from the counters of its sampler loops, for ``flux_pass_mfu``.

Counted, at the published widths (``transformer/config.json``: hidden
3,072, 19 double-stream and 38 single-stream blocks), for each step:
  * the linear layers of every block over every position: 24·d² FLOPs a
    position a block (12·d² multiply-adds: a double block's q, k, v and
    output projections and its 4·d MLP on each stream; a single block's
    q, k, v, its 4·d MLP and its 5·d -> d output projection);
  * the attention of every block over the joint sequence: Q·Kᵀ and P·V,
    4·N²·d FLOPs a batch row of N positions.
Left out: the AdaLN modulations (one vector a row, not a position), the
embedders, the final layer, RoPE, the norms and the elementwise work,
T5-XXL, CLIP-L and the VAE.

The counters are the port's (``genpc_tpu_torch/tracing.py``): each
sampler span, ``inpaint`` (a FLUX paint) and ``denoise`` (a generation),
sums over its steps the batch rows (``:rows``), the latent image
positions (``:img_tokens``) and the text positions (``:txt_tokens``).
Every call of one span in a pass has one image size and one text length,
so N = (img_tokens + txt_tokens) / rows for each of its rows.
"""

from __future__ import annotations

from typing import Mapping, Optional

HIDDEN = 3072
BLOCKS = 19 + 38
#: NVIDIA H100 SXM, dense bf16 (the data sheet), FLOP/s
BF16_PEAK = 989.4e12
SPANS = ("inpaint", "denoise")


def mmdit_flops(rows: float, img_tokens: float, txt_tokens: float,
                hidden: int = HIDDEN, blocks: int = BLOCKS) -> float:
    """The counted FLOPs of MMDiT forwards over ``rows`` batch rows
    holding ``img_tokens`` + ``txt_tokens`` positions in all, every row
    as long as the others."""
    if rows <= 0:
        return 0.0
    n = img_tokens + txt_tokens
    return blocks * (24.0 * hidden ** 2 * n + 4.0 * hidden * n * n / rows)


def pass_flops(timings: Mapping[str, float]) -> Optional[float]:
    """The counted FLOPs of every FLUX paint and generation step of one
    pass (its ``timings``), or None where neither span counted rows."""
    found = [s for s in SPANS if timings.get(f"{s}:rows")]
    if not found:
        return None
    return sum(mmdit_flops(timings[f"{s}:rows"], timings[f"{s}:img_tokens"],
                           timings[f"{s}:txt_tokens"]) for s in found)
