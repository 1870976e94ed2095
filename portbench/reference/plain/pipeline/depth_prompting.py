"""Stage 1 — Depth Prompting: viewpoint selection + depth render + inpaint
+ depth-conditioned image generation (counterpart of
genpc_tpu/pipeline/depth_prompting.py; reference: DepthPrompting.py).

Two entry points share this class's camera rig and backends:
  * the object-batched runner (``parallel/batched_runner.make_stage1_core``)
    runs stage 1 over a whole batch;
  * ``get_image`` runs it for one object (``main.run_pipeline``,
    ``main_lidar.run_lidar``): FPS to ``downsample_num`` (kernel K2),
    viewpoint selection over the rig (the coarse-to-exact z-buffer
    selector, or the exact Katz HPR with ``visibility='hpr'``), the best
    and the opposite camera, the visible-depth-sum choice between them
    (DepthPrompting.py:110-176), the raw-depth splat and its masks, the
    diffusion inpaint, then the depth->image backend.

Numeric contracts are the reference's: UV rescale to [0.05,0.95] with
padding, the (row,col) pixel swap and clip, the inverted depth encoding
0.1+0.8·(1−d̂), the vertical flip.  The inpainters are the
reference's (DepthPrompting.py:201-229): the device diffusion fill
(``inpainter='jax'``, the reference's name for it), OpenCV's
Navier-Stokes fill on the host (``'cv2'``), the FLUX inpainter
(``'flux'``, which paints the raw depth's hole mask 1 with the prompt
"complete the depth map. ") and DDNM (``'DDNM'``, which paints hole mask
2 and keeps it as the object's mask); any other name raises.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from portbench.reference.plain.categories import get_category
from portbench.reference.plain.geometry.cameras import (
    Camera, create_cameras, rescale_uvs, transform_points)
from portbench.reference.plain.models.backends import get_depth2image
from portbench.reference.plain.ops.fps import farthest_point_sample
from portbench.reference.plain.ops.hpr import select_best_view, visible_points
from portbench.reference.plain.pipeline.artifacts import ObjectArtifacts, Workspace
from portbench.reference.plain.render.inpaint import diffusion_inpaint, inpaint_image
from portbench.reference.plain.render.splat import raw_depth_images, uvs_to_pixels
from portbench.reference.plain.runtime import resolve_device


#: the prompt the FLUX inpainter paints a depth map with (the reference's)
INPAINT_PROMPT = "complete the depth map. "


def make_inpainter(cfg):
    """The inpainter of ``cfg.inpainter``: None for the diffusion fill
    ('jax') and cv2 (functions of render/inpaint.py), a
    ``FluxInpainter`` for 'flux', a ``DDNMInpainter`` for 'DDNM'; any
    other name raises."""
    inpainter = cfg.get("inpainter", "jax")
    if inpainter == "flux":
        from portbench.reference.plain.models.dit_depth import FluxInpainter
        return FluxInpainter(cfg)
    if inpainter == "DDNM":
        from portbench.reference.plain.models.ddnm import DDNMInpainter
        return DDNMInpainter(cfg)
    if inpainter not in ("jax", "cv2"):
        raise NotImplementedError(f"Inpainter {inpainter} not implemented.")
    return None


def paint_depth(cfg, inpainter, raw: np.ndarray, m1: np.ndarray,
                m2: np.ndarray) -> np.ndarray:
    """One object's raw depth [3, res, res] painted by the inpainter of
    ``cfg.inpainter`` other than the diffusion fill (the reference's
    calls: DepthPrompting.py:201-229): FLUX over hole mask 1 with the
    prompt, DDNM over hole mask 2, cv2 over hole mask 1."""
    name = cfg.get("inpainter", "jax")
    if name == "flux":
        return np.asarray(inpainter.paint(raw, m1, prompt=INPAINT_PROMPT,
                                          size=int(cfg.res)))
    if name == "DDNM":
        return np.asarray(inpainter.inpaint(raw, m2))
    if name == "cv2":
        return inpaint_image(raw, m1, backend="cv2").numpy()
    raise ValueError(f"inpainter {name!r} paints on the device")


class DepthPrompting:
    def __init__(self, cfg, depth2image=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.cameras, self.viewpoints = create_cameras(
            num_views=cfg.view_num,
            distance=cfg.distance,
            fovy=cfg.fovy,
            res=cfg.cam_res,
            distribution=cfg.camera_distribution,
            device=self.device,
        )
        # a backend the caller passes in stays the caller's to free
        self.owns_depth2image = depth2image is None
        self.depth2image = depth2image or get_depth2image(cfg.control_model,
                                                          cfg)
        self.workspace = Workspace(cfg.output_path, cfg.generative_model)
        self.inpainter = make_inpainter(cfg)
        self.owns_inpainter = True

    def _t(self, a) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=self.device)

    # ------------------------------------------------------------------
    def viewpoint_select(self, xyz: np.ndarray) -> int:
        """Best viewpoint = argmax of visible-point count over the rig
        (reference: DepthPrompting.py:87-98), on an FPS downsample."""
        cfg = self.cfg
        sampled, _ = farthest_point_sample(self._t(xyz), cfg.downsample_num)
        if cfg.get("visibility", "zbuffer") == "zbuffer":
            # the coarse pass scores an FPS-ordered prefix; a cloud no
            # larger than downsample_num keeps its own order, so score
            # every point instead of a spatially biased prefix
            n_coarse = int(cfg.get("select_coarse_points", 2500))
            if len(xyz) <= int(cfg.downsample_num):
                n_coarse = len(sampled)
            return int(select_best_view(
                sampled, self._t(self.viewpoints), n_coarse=n_coarse,
                topk=int(cfg.get("select_topk", 48))))
        vis = visible_points(sampled.cpu().numpy(), self.viewpoints,
                             cfg.removal_radius, method="hpr")
        return int(vis.sum(axis=1).argmax())

    # ------------------------------------------------------------------
    def get_depth(self, art: ObjectArtifacts) -> ObjectArtifacts:
        cfg = self.cfg
        xyz = np.asarray(art.xyz, np.float32)
        rgb = np.asarray(art.rgb, np.float32)

        best = 1 if cfg.view_num == 6 else self.viewpoint_select(xyz)

        # project through the best camera and its opposite
        viewpoint = np.asarray(self.viewpoints[best], np.float64)
        opposite = -viewpoint
        cam_best = self.cameras[best]
        cam_opp = Camera.from_eyes(opposite[None], cfg.fovy, cfg.cam_res,
                                   device=self.device)
        pts = self._t(xyz)
        tb = transform_points(cam_best, pts)
        to = transform_points(cam_opp, pts)
        if cfg.rescale:
            uv_b, d_b = rescale_uvs(tb, cfg.padding)
            uv_o, d_o = rescale_uvs(to, cfg.padding)
        else:
            uv_b, d_b = (tb[..., :2] + 1) * 0.5, tb[..., 2]
            uv_o, d_o = (to[..., :2] + 1) * 0.5, to[..., 2]
        uv_b, d_b, uv_o, d_o = uv_b[0], d_b[0], uv_o[0], d_o[0]

        # visibility from each candidate on the full cloud
        vis = visible_points(xyz, np.stack([viewpoint, opposite]),
                             cfg.removal_radius,
                             method=cfg.get("visibility", "zbuffer"),
                             device=self.device)
        vis1, vis2 = vis[0], vis[1]

        # keep the view with the larger visible depth sum (reference:
        # DepthPrompting.py:153-176; the sums in numpy, as there)
        sum1 = float(d_b.cpu().numpy()[vis1].sum())
        sum2 = float(d_o.cpu().numpy()[vis2].sum())
        if sum1 >= sum2:
            uv, depth, visible, view = uv_b, d_b, vis1, viewpoint
        else:
            uv, depth, visible, view = uv_o, d_o, vis2, opposite

        pixels = uvs_to_pixels(uv, cfg.res)
        _, raw_depth, m1, m2 = raw_depth_images(
            pixels, depth, self._t(rgb), res=cfg.res,
            point_size=cfg.point_size, mask_pixel_rate=cfg.mask_pixel_rate,
            valid=torch.as_tensor(visible, device=self.device))
        inpainter = cfg.get("inpainter", "jax")
        raw, h1, h2 = (t.cpu().numpy() for t in (raw_depth, m1, m2))
        if inpainter == "jax":
            depth_img = diffusion_inpaint(
                raw_depth, m1, iters=int(cfg.get("inpaint_iters", 250))
            ).cpu().numpy()
        else:
            depth_img = paint_depth(cfg, self.inpainter, raw, h1, h2)

        art.point_uv = uv.cpu().numpy()
        art.viewpoint = np.asarray(view)
        art.raw_depth = raw
        art.depth = depth_img
        art.mask = h2 if inpainter == "DDNM" else h1
        return art

    # ------------------------------------------------------------------
    def get_image(self, art: ObjectArtifacts, depth_gen: bool = True,
                  img_gen: bool = True, verbose: bool = True
                  ) -> ObjectArtifacts:
        """Full Stage 1 for one object (reference: DepthPrompting.py:69-85)."""
        start = time.time()
        if art.rgb is None:
            rng = np.random.default_rng(0)
            art.rgb = (rng.random((len(art.xyz), 3)) / 255.0).astype(
                np.float32)
        if depth_gen:
            self.get_depth(art)
        if img_gen:
            art.image = np.asarray(self.depth2image.generate(
                art.depth, get_category(art.flag),
                size=self.cfg.generate_res))
        if self.cfg.save:
            self.workspace.save_stage1(art)
        if verbose:
            print(f" Stage 1 [{art.flag}] took {time.time()-start:.1f}s")
        return art
