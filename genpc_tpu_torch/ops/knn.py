"""k-nearest-neighbour search (counterpart of genpc_tpu/ops/knn.py).

Row-tiled plain torch: each tile's direct-form squared distances
(dx²+dy²)+dz² go through ``torch.topk``, so no N×M matrix is ever held.
``lax.top_k`` returns equal values lower index first, and ``torch.topk``
promises no order among ties, so the k results are re-sorted stably by
(value, index).
"""

from __future__ import annotations

from typing import Tuple

import torch

from genpc_tpu_torch.ops.chamfer import _sq_dist

_TILE_ELEMS = 1 << 22


def knn(query: torch.Tensor, ref: torch.Tensor, k: int
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """query [N,3], ref [M,3] -> (sq_dists [N,k], idx [N,k] int32), ascending."""
    q = query.to(torch.float32)
    r = ref.to(torch.float32)
    n, m = q.shape[0], r.shape[0]
    rows = max(1, min(n, _TILE_ELEMS // max(m, 1)))
    dists, idxs = [], []
    for r0 in range(0, n, rows):
        d = _sq_dist(q[r0:r0 + rows], r)
        v, i = torch.topk(d, k, dim=1, largest=False, sorted=True)
        # ties: lower index first, as lax.top_k orders them
        i, perm = i.sort(dim=1)
        v = v.gather(1, perm)
        v, perm = v.sort(dim=1, stable=True)
        dists.append(v)
        idxs.append(i.gather(1, perm).to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)
