"""Cloud fusion: dedup, concat, FPS, denoise (counterpart of
genpc_tpu/registration/fusion.py; reference: reg_xyz.py:210-223).

  1. drop generated points whose squared NN distance to an input point is
     below the threshold (one launch of kernel K1 per object),
  2. concatenate input + surviving generated points,
  3. FPS-downsample (kernel K2: one launch over every object of a batch
     that exceeds the target size, the clouds padded by repetition),
  4. statistical outlier removal (std_ratio 2.5).

Inputs and outputs are numpy; ``device`` is where the work runs (the
card unless the caller asks for the CPU).
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from genpc_tpu_torch.ops.chamfer import nearest_neighbor
from genpc_tpu_torch.ops.fps import pad_repeat
from genpc_tpu_torch.ops.fps_kernel import fps_batched
from genpc_tpu_torch.ops.outliers import statistical_outlier_mask
from genpc_tpu_torch.tracing import span

Cloud = Tuple[np.ndarray, Optional[np.ndarray]]


def _t(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a), dtype=torch.float32, device=device)


def remove_close_points(source_pts: np.ndarray, target_pts: np.ndarray,
                        target_colors: Optional[np.ndarray] = None,
                        distance_threshold: float = 1e-4,
                        device: torch.device | str = "cuda"
                        ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Keep target points whose squared NN distance to source >= threshold."""
    d2, _ = nearest_neighbor(_t(target_pts, device), _t(source_pts, device))
    mask = d2.cpu().numpy() >= distance_threshold
    kept = np.asarray(target_pts)[mask]
    cols = None if target_colors is None else np.asarray(target_colors)[mask]
    return kept, cols


def fuse_clouds_batched(sources: Sequence[np.ndarray],
                        targets: Sequence[np.ndarray],
                        source_colors: Sequence[Optional[np.ndarray]],
                        target_colors: Sequence[Optional[np.ndarray]],
                        num_points: int = 20000,
                        distance_threshold: float = 1e-4,
                        denoise_neighbors: int = 20,
                        denoise_std_ratio: float = 2.5,
                        device: torch.device | str = "cuda",
                        provenance: Optional[List[dict]] = None
                        ) -> List[Cloud]:
    """The fusion tail of a batch of objects -> [(points, colors)].

    Per object dedup and concat, then one FPS over every concatenation
    longer than num_points, then per object the outlier mask.  Padding by
    repetition leaves each object's FPS sequence as it is alone, so the
    result equals a per-object loop of ``fuse_clouds``.  An object's
    colours are None unless both of its colour arrays are given.

    provenance (optional list) receives one dict per object: ``concat``
    (the deduplicated concatenation), ``sampled`` (after the FPS),
    ``from_partial`` (bool, which sampled points came from the source)
    and ``mask`` (the outlier mask over ``sampled``).  Spans
    (``tracing``): ``fusion_dedup``, ``fusion_fps``, ``fusion_outliers``,
    each ending in a copy to the host."""
    fused = []
    with span("fusion_dedup"):
        for s, t, sc, tc in zip(sources, targets, source_colors,
                                target_colors):
            kept, kept_cols = remove_close_points(s, t, tc,
                                                  distance_threshold,
                                                  device=device)
            pts = np.concatenate([np.asarray(s), kept], axis=0)
            cols = None
            if sc is not None and kept_cols is not None:
                cols = np.concatenate([np.asarray(sc), kept_cols], axis=0)
            fused.append((pts, cols, np.arange(len(pts)) < len(s)))
    concat = [pts for pts, _, _ in fused]
    big = [i for i, f in enumerate(fused) if len(f[0]) > num_points]
    with span("fusion_fps"):
        if big:
            idx = fps_batched(_t(pad_repeat([fused[i][0] for i in big]),
                                 device), num_points).cpu().numpy()
            for i, row in zip(big, idx):
                pts, cols, part = fused[i]
                fused[i] = (pts[row], None if cols is None else cols[row],
                            part[row])
    out = []
    with span("fusion_outliers"):
        for k, (pts, cols, part) in enumerate(fused):
            mask = statistical_outlier_mask(_t(pts, device),
                                            nb_neighbors=denoise_neighbors,
                                            std_ratio=denoise_std_ratio)
            mask = mask.cpu().numpy()
            out.append((pts[mask], None if cols is None else cols[mask]))
            if provenance is not None:
                provenance.append({"concat": concat[k], "sampled": pts,
                                   "from_partial": part, "mask": mask})
    return out


def fuse_clouds(source_pts: np.ndarray, target_pts: np.ndarray,
                source_colors: Optional[np.ndarray] = None,
                target_colors: Optional[np.ndarray] = None,
                num_points: int = 20000,
                distance_threshold: float = 1e-4,
                denoise_std_ratio: float = 2.5,
                device: torch.device | str = "cuda") -> Cloud:
    """Full fusion tail of one object; returns (points, colors)."""
    return fuse_clouds_batched(
        [source_pts], [target_pts], [source_colors], [target_colors],
        num_points=num_points, distance_threshold=distance_threshold,
        denoise_std_ratio=denoise_std_ratio, device=device)[0]
