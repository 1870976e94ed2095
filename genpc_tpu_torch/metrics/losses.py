"""Completion losses: Chamfer-L1/L2, one-sided Chamfer, auction EMD
(counterpart of genpc_tpu/metrics/losses.py; reference:
utils/loss_util.py:8-53).

  chamfer_l1  = (mean sqrt(d1) + mean sqrt(d2)) / 2
  chamfer_l2  = mean d1 + mean d2
  chamfer_partial_l1/l2 = one-sided variants (only d1 is computed; the
                gradient equals the reference's custom VJP, whose d2 term
                carries no cotangent)
  emd_loss    = mean sqrt(auction_dist), eps=0.005, iters=50
  apml_loss   = soft point matching: a coupling from row and column
                softmaxes of the negative distances, against the squared
                distances (differentiable in both clouds)

All accept [N,3] or [B,N,3] and are differentiable (chamfer through
``ops/chamfer``; EMD with respect to the first argument only).
"""

from __future__ import annotations

import torch

from genpc_tpu_torch.ops.chamfer import chamfer_distances, nn_one_sided
from genpc_tpu_torch.ops.emd import emd_auction


def _d1(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    batched = p1.ndim == 3
    d1, _ = nn_one_sided(p1 if batched else p1[None],
                         p2 if batched else p2[None])
    return d1


def chamfer_l1(p1, p2):
    d1, d2, _, _ = chamfer_distances(p1, p2)
    return (torch.sqrt(torch.clamp_min(d1, 0.0)).mean()
            + torch.sqrt(torch.clamp_min(d2, 0.0)).mean()) / 2.0


def chamfer_l2(p1, p2):
    d1, d2, _, _ = chamfer_distances(p1, p2)
    return d1.mean() + d2.mean()


def chamfer_partial_l1(p1, p2):
    return torch.sqrt(torch.clamp_min(_d1(p1, p2), 0.0)).mean()


def chamfer_partial_l2(p1, p2):
    return _d1(p1, p2).mean()


def emd_loss(p1, p2, eps: float = 0.005, iters: int = 50):
    d, _ = emd_auction(p1, p2, eps=eps, iters=iters)
    return torch.sqrt(torch.clamp_min(d, 0.0)).mean()


def apml_loss(p1, p2, temperature: float = 0.05):
    """Approximate point-matching loss (reference: losses.py:50-76; APML,
    arXiv:2512.19743): the geometric mean of the row and column softmaxes
    of -d²/temperature (one balanced coupling step), normalised to sum 1
    per pair, contracted against d² and averaged over the batch.  Dense
    [B,N,M] in the direct form |a|² + |b|² - 2ab, as the reference."""
    a = torch.as_tensor(p1, dtype=torch.float32)
    b = torch.as_tensor(p2, dtype=torch.float32, device=a.device)
    if a.ndim == 2:
        a, b = a[None], b[None]
    cross = torch.einsum("bnd,bmd->bnm", a, b)
    d2 = torch.clamp_min(a.square().sum(-1)[..., :, None]
                         + b.square().sum(-1)[..., None, :] - 2 * cross, 0.0)
    logits = -d2 / temperature
    coupling = torch.exp(0.5 * (torch.log_softmax(logits, -1)
                                + torch.log_softmax(logits, -2)))
    coupling = coupling / torch.clamp_min(
        coupling.sum((-2, -1), keepdim=True), 1e-12)
    return (coupling * d2).sum((-2, -1)).mean()


class CompletionLoss:
    """Drop-in for the reference's Completionloss(loss_func=...): 'cd_l1',
    'cd_l2' or 'emd'."""

    def __init__(self, loss_func: str = "cd_l1",
                 emd_eps: float = 0.005, emd_iters: int = 50):
        self.loss_func = loss_func
        self.emd_eps = emd_eps
        self.emd_iters = emd_iters
        if loss_func == "cd_l1":
            self.metric = chamfer_l1
            self.partial_matching = chamfer_partial_l1
        elif loss_func == "cd_l2":
            self.metric = chamfer_l2
            self.partial_matching = chamfer_partial_l2
        elif loss_func == "emd":
            self.metric = self.emd_loss
        else:
            raise ValueError(f"loss function {loss_func} not supported")

    chamfer_l1 = staticmethod(chamfer_l1)
    chamfer_l2 = staticmethod(chamfer_l2)
    chamfer_partial_l1 = staticmethod(chamfer_partial_l1)
    chamfer_partial_l2 = staticmethod(chamfer_partial_l2)

    def emd_loss(self, p1, p2):
        return emd_loss(p1, p2, eps=self.emd_eps, iters=self.emd_iters)

    def get_loss(self, gen, gt):
        return self.metric(gen, gt)
