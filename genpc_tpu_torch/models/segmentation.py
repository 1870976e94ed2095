"""Text/scene segmentation utilities (counterpart of
genpc_tpu/models/segmentation.py, numpy and cv2 as there; reference:
tools/sam3_wrapper.py).

The reference's scene-completion extension runs SAM3 text-prompted
segmentation, deduplicates overlapping masks by IoU, crops each object and
re-centers it to 512² at an 85% object ratio with an affine warp, and
matches masks across updates (sam3_wrapper.py:17-465).  The geometry of
that wrapper (IoU dedup, crop/center warp, mask matching) is model-free
and ported here exactly; the segmenter itself is pluggable — the default
``ConnectedComponentSegmenter`` splits a matte into instances, and a
SAM-class checkpoint can register behind the same callable signature.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np


def mask_iou(a: np.ndarray, b: np.ndarray) -> float:
    a = np.asarray(a) > 0.5
    b = np.asarray(b) > 0.5
    inter = np.logical_and(a, b).sum()
    union = np.logical_or(a, b).sum()
    return float(inter) / max(float(union), 1.0)


def dedup_masks(masks: List[np.ndarray], iou_thresh: float = 0.5,
                scores: Optional[List[float]] = None) -> List[int]:
    """Indices of kept masks after greedy IoU dedup
    (reference: sam3_wrapper.py:154-193)."""
    order = (np.argsort(scores)[::-1] if scores is not None
             else np.argsort([-(np.asarray(m) > 0.5).sum() for m in masks]))
    kept: List[int] = []
    for i in order:
        if all(mask_iou(masks[i], masks[j]) < iou_thresh for j in kept):
            kept.append(int(i))
    return sorted(kept)


def crop_center_object(image: np.ndarray, mask: np.ndarray,
                       out_size: int = 512, object_ratio: float = 0.85
                       ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Crop the masked object and center it at object_ratio of out_size.

    Returns (rgba [S,S,4], affine 2x3 mapping src->dst, mask_out [S,S]).
    Mirrors sam3_wrapper.py:86-151 (bbox -> scale -> affine warp).
    """
    import cv2
    img = np.asarray(image, np.float32)
    m = (np.asarray(mask) > 0.5).astype(np.float32)
    ys, xs = np.nonzero(m)
    if len(ys) == 0:
        raise ValueError("empty mask")
    y0, y1 = ys.min(), ys.max()
    x0, x1 = xs.min(), xs.max()
    h, w = y1 - y0 + 1, x1 - x0 + 1
    scale = object_ratio * out_size / max(h, w)
    tx = out_size / 2 - scale * (x0 + x1 + 1) / 2
    ty = out_size / 2 - scale * (y0 + y1 + 1) / 2
    A = np.array([[scale, 0, tx], [0, scale, ty]], np.float64)
    img_u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    warped = cv2.warpAffine(img_u8, A, (out_size, out_size),
                            flags=cv2.INTER_LINEAR)
    mask_w = cv2.warpAffine((m * 255).astype(np.uint8), A,
                            (out_size, out_size),
                            flags=cv2.INTER_NEAREST).astype(np.float32) / 255
    rgba = np.concatenate([warped.astype(np.float32) / 255.0 * mask_w[..., None],
                           mask_w[..., None]], axis=-1)
    return rgba, A, mask_w


def match_masks(old_masks: List[np.ndarray], new_masks: List[np.ndarray],
                iou_thresh: float = 0.3) -> List[Optional[int]]:
    """For each new mask, the best-matching old index or None
    (reference's update mode, sam3_wrapper.py:196-355)."""
    out: List[Optional[int]] = []
    for nm in new_masks:
        ious = [mask_iou(nm, om) for om in old_masks]
        best = int(np.argmax(ious)) if ious else -1
        out.append(best if ious and ious[best] >= iou_thresh else None)
    return out


class ConnectedComponentSegmenter:
    """Checkpoint-free instance segmenter: threshold + connected components."""

    def __init__(self, threshold: float = 0.1, min_area: int = 64):
        self.threshold = threshold
        self.min_area = min_area

    def __call__(self, image: np.ndarray, prompt: str = ""
                 ) -> Tuple[List[np.ndarray], List[float]]:
        import cv2
        img = np.asarray(image, np.float32)
        lum = img[..., :3].max(axis=-1)
        binary = (lum > self.threshold).astype(np.uint8)
        n, labels = cv2.connectedComponents(binary)
        masks, scores = [], []
        for i in range(1, n):
            m = labels == i
            if m.sum() >= self.min_area:
                masks.append(m.astype(np.float32))
                scores.append(float(m.sum()))
        return masks, scores


def process_scene_image(image: np.ndarray,
                        segmenter: Optional[Callable] = None,
                        prompt: str = "", out_size: int = 512,
                        object_ratio: float = 0.85, iou_thresh: float = 0.5
                        ) -> List[dict]:
    """Full scene pass (reference: sam3_wrapper.py:358-465 process_single_image):
    segment, dedup, crop/center each instance.  Returns a list of
    {'rgba', 'mask', 'affine', 'score'} records."""
    segmenter = segmenter or ConnectedComponentSegmenter()
    masks, scores = segmenter(image, prompt)
    keep = dedup_masks(masks, iou_thresh, scores)
    out = []
    for i in keep:
        rgba, A, m = crop_center_object(image, masks[i], out_size,
                                        object_ratio)
        out.append({"rgba": rgba, "mask": m, "affine": A,
                    "score": scores[i]})
    return out
