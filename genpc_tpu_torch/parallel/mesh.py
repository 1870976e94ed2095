"""Multi-device execution: object data parallelism (``dp``), point-axis
sharding of the chamfer (``sp``) and tensor-parallel MMDiT layers
(``tp``) (counterpart of genpc_tpu/parallel/mesh.py).

One process drives every device of the mesh, as the reference's single
controller does.  A mesh is a named grid of ``torch.device``s; a device
may repeat, so a mesh of any shape runs on one card (or on the CPU,
where the tests run it).  A sharded tensor is the list of its shards in
shard order, shard i on the axis's i-th device (``dp_sharded``).  The
collectives are explicit copies (``.to(device, non_blocking=True)``),
and every reduction runs in shard order on the axis's first device: no
float atomics and no process group.  Each shard's work is enqueued
before the host reads any result, so on distinct cards the shards of a
stage that reads nothing back overlap.

  * ``make_mesh``, ``get_mesh``, ``dp_size``, ``dp_sharded``, ``gather``;
  * ``sharded_chamfer_l1``: Chamfer-L1 with the rows of both clouds
    split over an axis; each shard runs kernel K1 on its rows against
    the whole other cloud, so no N×M tensor exists;
  * ``tp_sharded_dit_forward``: one forward of the tiny MMDiT with every
    layer the reference builds through ``_tp_dense`` split over ``tp``
    (column-parallel, or row-parallel for the output projections);
  * ``batched_pose_step``: one Adam step of the pose loss for a batch of
    objects split over ``dp`` (the reference render by the footprint-
    scatter renderer, the loss through kernels K4/K5 and K1).
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from genpc_tpu_torch.ops.chamfer import _nn


@dataclass(frozen=True)
class DeviceMesh:
    """A named grid of devices (the reference's ``jax.sharding.Mesh``):
    ``devices`` is an object array of ``torch.device`` of shape
    ``tuple(shape.values())``."""
    devices: np.ndarray
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, axis: str) -> List[torch.device]:
        """The devices along ``axis``, every other axis at its first
        index: shard i of a tensor split over ``axis`` lives on the i-th."""
        a = self.axis_names.index(axis)
        index = [0] * len(self.axis_names)
        index[a] = slice(None)
        return list(self.devices[tuple(index)])


def make_mesh(shape: Dict[str, int], devices=None) -> DeviceMesh:
    """A named mesh, e.g. make_mesh({'dp': 4, 'sp': 2}).  devices: a list
    of devices (repeats allowed), every CUDA device by default."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    n = int(np.prod(list(shape.values())))
    if len(devices) < n:
        raise ValueError(f"mesh {shape} needs {n} devices, have "
                         f"{len(devices)}")
    grid = np.empty(n, dtype=object)
    grid[:] = devices[:n]
    return DeviceMesh(grid.reshape(tuple(shape.values())), tuple(shape))


def get_mesh(cfg) -> Optional[DeviceMesh]:
    """The mesh of cfg.mesh_shape (e.g. {'dp': 8}), None without one.  Its
    devices are cfg.mesh_devices when the config holds them (a list of
    device names, repeats allowed: ['cuda:0'] * 4 runs four shards on one
    card); else the CPU repeated when cfg.device is 'cpu', and every
    CUDA device otherwise."""
    shape = cfg.get("mesh_shape") if hasattr(cfg, "get") else None
    if not shape:
        return None
    devices = cfg.get("mesh_devices")
    if devices is None and torch.device(cfg.get("device", "cuda")).type \
            == "cpu":
        devices = ["cpu"] * int(np.prod(list(dict(shape).values())))
    return make_mesh(dict(shape), devices)


def dp_size(mesh: Optional[DeviceMesh]) -> int:
    """Size of the object-parallel axis (1 without a mesh)."""
    if mesh is None or "dp" not in mesh.axis_names:
        return 1
    return mesh.shape["dp"]


def dp_devices(mesh: Optional[DeviceMesh], device) -> List[torch.device]:
    """The devices of the ``dp`` shards: the mesh's dp axis, or the one
    ``device`` without a mesh or a dp axis."""
    if mesh is None or "dp" not in mesh.axis_names:
        return [torch.device(device)]
    return mesh.axis_devices("dp")


def split(x, devices: Sequence[torch.device]) -> List[torch.Tensor]:
    """x (tensor or array) -> its len(devices) equal chunks along axis 0,
    chunk i copied to devices[i]."""
    x = torch.as_tensor(x)
    k = len(devices)
    if x.shape[0] % k:
        raise ValueError(f"axis 0 of length {x.shape[0]} does not split "
                         f"into {k} shards")
    return [c.to(d, non_blocking=True)
            for c, d in zip(torch.chunk(x, k), devices)]


def dp_sharded(mesh: Optional[DeviceMesh], *arrays):
    """Each array split over ``dp`` along its object axis (a list of
    shards, shard i on the i-th dp device); without a mesh, the arrays
    as they are."""
    if mesh is None:
        return arrays if len(arrays) > 1 else arrays[0]
    out = tuple(split(a, mesh.axis_devices("dp")) for a in arrays)
    return out if len(out) > 1 else out[0]


def gather(shards: Sequence[torch.Tensor], device=None) -> torch.Tensor:
    """Shards concatenated in shard order on ``device`` (the first
    shard's by default)."""
    device = shards[0].device if device is None else device
    return torch.cat([s.to(device, non_blocking=True) for s in shards])


def run_sharded(fn, devices: Sequence[torch.device], *arrays):
    """fn over the dp shards of stacked host arrays: each array's object
    axis is split into len(devices) chunks, chunk i on devices[i]; every
    shard's call is made before any result is read back, then the
    results (a tensor or array, or a tuple of them) are concatenated on
    the host in shard order as numpy arrays."""
    outs = [fn(*shard) for shard in zip(*(split(a, devices)
                                          for a in arrays))]
    single = not isinstance(outs[0], tuple)
    cols = zip(*((o,) if single else o for o in outs))
    host = tuple(np.concatenate([o.cpu().numpy() if torch.is_tensor(o)
                                 else np.asarray(o) for o in col])
                 for col in cols)
    return host[0] if single else host


# ------------------------------------------------------------ sp chamfer

def sharded_chamfer_l1(x: torch.Tensor, y: torch.Tensor, mesh: DeviceMesh,
                       axis: str = "sp") -> torch.Tensor:
    """Chamfer-L1 of x [N,3] and y [M,3] with the rows of both clouds
    split over ``axis`` (N and M divisible by its size).  Shard i holds
    its rows of each cloud and the whole of the other, runs K1 both ways
    and sums its square-rooted distances; the two sums are reduced in
    shard order on the axis's first device.  Returns a scalar there."""
    devs = mesh.axis_devices(axis)
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    sums = []
    for xs, ys, d in zip(split(x, devs), split(y, devs), devs):
        d1, _ = _nn(xs[None], y.to(d, non_blocking=True)[None])
        d2, _ = _nn(ys[None], x.to(d, non_blocking=True)[None])
        sums.append((torch.sqrt(torch.clamp_min(d1, 0.0)).sum(),
                     torch.sqrt(torch.clamp_min(d2, 0.0)).sum()))
    s1 = torch.zeros((), dtype=torch.float32, device=devs[0])
    s2 = torch.zeros((), dtype=torch.float32, device=devs[0])
    for a, b in sums:
        s1 = s1 + a.to(devs[0], non_blocking=True)
        s2 = s2 + b.to(devs[0], non_blocking=True)
    return (s1 / x.shape[0] + s2 / y.shape[0]) / 2.0


# ------------------------------------------------------------ tp MMDiT

#: the MMDiT block layers that the reference builds ``shard="in"``
#: (row-parallel): the attention and MLP output projections
_ROW_PARALLEL = ("to_out.0", "to_add_out", "net.2", "proj_out")


class TPLinear(nn.Module):
    """A block ``Linear`` split over devices.  shard 'out' (column-
    parallel): shard i holds rows i of the weight and bias and computes
    its output columns from a copy of the input, gathered in shard order.
    shard 'in' (row-parallel): shard i holds columns i of the weight and
    computes a partial product from its slice of the input; the partials
    are summed in fp32 in shard order on the first device, then the bias
    is added and the sum cast to the compute type."""

    def __init__(self, lin: nn.Module, devices: Sequence[torch.device],
                 shard: str):
        super().__init__()
        k = len(devices)
        self.devices, self.shard, self.compute = list(devices), shard, \
            lin.compute
        w = lin.weight.detach()
        b = None if lin.bias is None else lin.bias.detach()
        dim = 0 if shard == "out" else 1
        if w.shape[dim] % k:
            raise ValueError(f"weight {tuple(w.shape)} does not split into "
                             f"{k} shards along {dim}")
        self.w = [c.to(d) for c, d in zip(torch.chunk(w, k, dim), devices)]
        if b is None:
            self.b = [None] * k
        elif shard == "out":
            self.b = [c.to(d) for c, d in zip(torch.chunk(b, k), devices)]
        else:
            self.b = b.to(devices[0])

    def forward(self, x):
        c, devs = self.compute, self.devices
        if self.shard == "out":
            outs = [torch.nn.functional.linear(
                x.to(d, non_blocking=True).to(c), w.to(c),
                None if b is None else b.to(c))
                for w, b, d in zip(self.w, self.b, devs)]
            return torch.cat([o.to(devs[0], non_blocking=True)
                              for o in outs], -1)
        xs = torch.chunk(x, len(devs), -1)
        parts = [torch.nn.functional.linear(
            xi.to(d, non_blocking=True).to(c), w.to(c))
            for xi, w, d in zip(xs, self.w, devs)]
        acc = parts[0].to(devs[0], torch.float32)
        for p in parts[1:]:
            acc = acc + p.to(devs[0], torch.float32, non_blocking=True)
        if self.b is not None:
            acc = acc + self.b.to(torch.float32)
        return acc.to(c)


def tp_shard(model: nn.Module, devices: Sequence[torch.device]
             ) -> Tuple[nn.Module, int]:
    """A copy of an MMDiT whose block linears (the reference's
    ``_tp_dense`` layers: modulations, attention and MLP projections of
    every double and single block) are ``TPLinear``s over devices.
    Returns (the copy, the number of split layers)."""
    from genpc_tpu_torch.models.layers import Linear
    out = copy.deepcopy(model)
    n = 0
    for blocks in ("transformer_blocks", "single_transformer_blocks"):
        for block in getattr(out, blocks, []):
            for name, mod in list(block.named_modules()):
                if not isinstance(mod, Linear):
                    if type(mod).__name__ == "QuantLinear":
                        raise ValueError("tensor-parallel QuantLinear "
                                         "layers are not supported")
                    continue
                shard = "in" if name.endswith(_ROW_PARALLEL) else "out"
                parent_name, _, leaf = name.rpartition(".")
                parent = block.get_submodule(parent_name) if parent_name \
                    else block
                setattr(parent, leaf, TPLinear(mod, devices, shard))
                n += 1
    return out, n


def tp_sharded_dit_forward(mesh: DeviceMesh, tp_axis: str = "tp",
                           model: Optional[nn.Module] = None):
    """One forward of the tiny MMDiT (the reference's inputs: zero
    latents 8×8, condition latents and 16 text tokens, t 0.5, guidance
    1) with its ``_tp_dense`` layers split over ``tp_axis``.  model: a
    tiny port MMDiT (random weights of seed 0 on the axis's first device
    by default; it is copied, not changed).  Returns (output [1,C,8,8]
    on the first device, the number of split layers)."""
    from genpc_tpu_torch.models.dit import DiTConfig, MMDiT
    from genpc_tpu_torch.models.weights import materialize
    devs = mesh.axis_devices(tp_axis)
    cfg = DiTConfig.preset("tiny")
    if model is None:
        with torch.device("meta"):
            model = MMDiT(cfg)
        materialize(model, devs[0], torch.float32, seed=0)
    sharded, n = tp_shard(model, devs)
    f32 = dict(dtype=torch.float32, device=devs[0])
    with torch.no_grad():
        out = sharded(torch.zeros((1, cfg.in_channels, 8, 8), **f32),
                      torch.full((1,), 0.5, **f32),
                      torch.zeros((1, 16, cfg.text_dim), **f32),
                      pooled=torch.zeros((1, cfg.pooled_dim), **f32),
                      cond_latents=torch.zeros((1, cfg.cond_channels, 8, 8),
                                               **f32),
                      guidance=torch.ones((1,), **f32))
    return out, n


# ------------------------------------------------------------ pose step

def batched_pose_step(mesh: DeviceMesh, batch_axis: str = "dp"):
    """A pose-optimisation step for a batch of objects split over
    ``batch_axis``.  Returns (step, make_example, shardings):

      * ``step(params, opt_state, comp, comp_col, partial, radius,
        render_size)`` takes the per-shard lists ``shardings`` gives and
        returns (params, opt_state, losses [b]) per shard: each object
        renders its partial (colour 0.7) with the default footprint-
        scatter renderer into a reference image and hard mask, takes the
        gradient of its ``pose_loss`` (slots renderer, K4/K5; Chamfer,
        K1) and one Adam(1e-2) update, as the reference's vmapped step;
      * ``make_example(batch, n_complete, n_partial, render_size)``: the
        reference's inputs from its numpy seed, on the host (params
        rot6d [b,6], trans [b,3], log_scale [b,1]; opt_state {mu, nu,
        count [b]});
      * ``shardings(params, opt_state, comp, comp_col, partial)``: each
        split over the axis's devices, a list of per-shard trees."""
    from genpc_tpu_torch.geometry.transforms import rot6d_from_axis_angle
    from genpc_tpu_torch.registration.pose_optim import KEYS, _adam, \
        pose_loss
    from genpc_tpu_torch.render.point_renderer import (
        RenderCamera, hard_mask, render_points)
    devs = mesh.axis_devices(batch_axis)
    plain = {k: None for k in KEYS}           # one learning rate

    def shard_step(params, opt, comp, comp_col, partial, radius,
                   render_size):
        camera = RenderCamera.default(render_size)
        ref_img = render_points(partial, torch.full_like(partial, 0.7),
                                radius, camera)
        p = {k: params[k][:, None].detach().requires_grad_(True)
             for k in KEYS}
        loss = pose_loss(p, comp, comp_col, comp.mean(1), partial, ref_img,
                         hard_mask(ref_img), camera, radius)[:, 0]
        grads = torch.autograd.grad(loss.sum(), [p[k] for k in KEYS])
        opt1 = {"mu": {k: opt["mu"][k][:, None] for k in KEYS},
                "nu": {k: opt["nu"][k][:, None] for k in KEYS},
                "count": opt["count"][:, None]}
        new_p, new_opt = _adam({k: p[k].detach() for k in KEYS},
                               dict(zip(KEYS, grads)), opt1, 1e-2, plain)
        return ({k: v[:, 0] for k, v in new_p.items()},
                {"mu": {k: v[:, 0] for k, v in new_opt["mu"].items()},
                 "nu": {k: v[:, 0] for k, v in new_opt["nu"].items()},
                 "count": new_opt["count"][:, 0]},
                loss.detach())

    def step(params, opt_state, comp, comp_col, partial, radius,
             render_size):
        outs = [shard_step(*a, radius, render_size)
                for a in zip(params, opt_state, comp, comp_col, partial)]
        return tuple(list(o) for o in zip(*outs))

    def make_example(batch: int, n_complete: int = 256, n_partial: int = 128,
                     render_size: int = 32):
        rng = np.random.default_rng(0)
        f32 = torch.float32
        params = {
            "rot6d": rot6d_from_axis_angle("y", 0.0)[None].repeat(batch, 1),
            "trans": torch.zeros((batch, 3), dtype=f32),
            "log_scale": torch.log(torch.full((1, 1), 0.75, dtype=f32))
            .repeat(batch, 1)}
        opt_state = {"mu": {k: torch.zeros_like(v) for k, v in params.items()},
                     "nu": {k: torch.zeros_like(v) for k, v in params.items()},
                     "count": torch.zeros(batch, dtype=torch.int32)}
        comp = torch.as_tensor(rng.normal(size=(batch, n_complete, 3)) * 0.3,
                               dtype=f32)
        comp_col = torch.full((batch, n_complete, 3), 0.6, dtype=f32)
        partial = torch.as_tensor(rng.normal(size=(batch, n_partial, 3))
                                  * 0.3, dtype=f32)
        return params, opt_state, comp, comp_col, partial, render_size

    def shard_tree(t):
        if not isinstance(t, dict):
            return split(t, devs)
        per = {k: shard_tree(v) for k, v in t.items()}
        return [{k: per[k][i] for k in per} for i in range(len(devs))]

    def shardings(params, opt_state, comp, comp_col, partial):
        return tuple(shard_tree(t) for t in (params, opt_state, comp,
                                             comp_col, partial))

    return step, make_example, shardings
