"""Statistical outlier removal (counterpart of genpc_tpu/ops/outliers.py).

A point is kept iff its mean distance to its nb_neighbors nearest
neighbours (excluding itself) is at most global_mean + std_ratio *
global_std (population std) of those per-point means.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from portbench.reference.plain.ops.knn import knn


def statistical_outlier_mask(points: torch.Tensor, nb_neighbors: int = 20,
                             std_ratio: float = 2.0) -> torch.Tensor:
    pts = points.to(torch.float32)
    d, _ = knn(pts, pts, nb_neighbors + 1)   # first neighbour is self (d=0)
    mean_d = torch.sqrt(torch.clamp_min(d[:, 1:], 0.0)).mean(dim=1)
    mu = mean_d.mean()
    sigma = mean_d.std(correction=0)
    return mean_d <= mu + std_ratio * sigma


def remove_statistical_outliers(points, colors=None, nb_neighbors: int = 20,
                                std_ratio: float = 2.0,
                                device: torch.device | str = "cuda"
                                ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Numpy wrapper returning filtered (points, colors); the mask is
    computed on ``device`` (the card unless the caller asks for the CPU)."""
    pts = torch.as_tensor(np.asarray(points), dtype=torch.float32,
                          device=device)
    mask = statistical_outlier_mask(pts, nb_neighbors,
                                    std_ratio).cpu().numpy()
    kept = np.asarray(points)[mask]
    cols = None if colors is None else np.asarray(colors)[mask]
    return kept, cols
