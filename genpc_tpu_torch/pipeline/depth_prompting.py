"""Stage 1 — Depth Prompting (counterpart of
genpc_tpu/pipeline/depth_prompting.py).

The object-batched runner (``parallel/batched_runner.make_stage1_core``)
does the stage-1 work; this class holds what it needs: the camera rig
(the ``view_num`` eyes and their rotations) and the depth->image backend.
Only the device diffusion inpainter (``inpainter='jax'``, the reference's
name for it) is ported; the per-object ``get_depth``/``get_image`` path
and workspace saving are not.
"""

from __future__ import annotations

from genpc_tpu_torch.geometry.cameras import create_cameras
from genpc_tpu_torch.models.backends import get_depth2image
from genpc_tpu_torch.runtime import resolve_device


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
        inpainter = cfg.get("inpainter", "jax")
        if inpainter != "jax":
            raise NotImplementedError(
                f"inpainter {inpainter!r} is not ported to genpc_tpu_torch "
                f"yet (ROADMAP queue 1); the diffusion fill 'jax' is")
