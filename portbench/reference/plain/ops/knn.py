"""k-nearest-neighbour search (counterpart of genpc_tpu/ops/knn.py).

Row-tiled plain torch: each tile's direct-form squared distances
(dx²+dy²)+dz² go through ``torch.topk``, so no N×M matrix is ever held.
``lax.top_k`` takes equal values lower index first, also at the k-th
place, and ``torch.topk`` promises neither which of several equal k-th
values it takes nor their order: the k-th value's lowest-index copies
are taken by a running count, and the k results are sorted stably by
(value, index).
"""

from __future__ import annotations

from typing import Tuple

import torch

from portbench.reference.plain.ops.chamfer import _sq_dist

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
        # the k smallest with lax.top_k's ties, lower index first: every
        # value below the k-th, then the lowest-index copies of the k-th
        # (torch.topk may pick any of them)
        vk = torch.topk(d, k, dim=1, largest=False, sorted=True)[0][:, -1:]
        below = d < vk
        at = d == vk
        take = below | (at & (torch.cumsum(at, 1)
                              <= k - below.sum(1, keepdim=True)))
        i = torch.topk(take.to(torch.float32), k, dim=1).indices.sort(
            dim=1)[0]
        v, perm = torch.gather(d, 1, i).sort(dim=1, stable=True)
        dists.append(v)
        idxs.append(i.gather(1, perm).to(torch.int32))
    return torch.cat(dists), torch.cat(idxs)
