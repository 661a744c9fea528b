"""Host decode with PIL, in torchvision-on-PIL geometry.

The port's copy of ``deepfakedetection_tpu/data/decode.py``. Eval:
ensure_rgb -> shorter-side resize (PIL BILINEAR, the antialiased triangle
filter torchvision runs on PIL images) -> center crop. Training: the same
to a square canvas of ``plan.host_canvas_size``; the random geometry runs
on the device (``data/augment.py``). The ``decode_pil_*`` functions take
an open image (a file's or, for tar shards, bytes'), so both share one
geometry.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
from PIL import Image

from deepfakedetection_tpu_torch.data.transforms import EvalTransformPlan, TrainTransformPlan


def _resize_shorter(img: Image.Image, target: int) -> Image.Image:
    """Shorter side to ``target``; the longer side truncates, as
    torchvision's ``_compute_resized_output_size`` does (500x375 at 299 gives
    398, not 399)."""
    w, h = img.size
    if w <= h:
        rw, rh = target, max(1, int(h * target / w))
    else:
        rh, rw = target, max(1, int(w * target / h))
    if (rw, rh) == (w, h):
        return img
    return img.resize((rw, rh), Image.BILINEAR)


def _crop_anchor(size: int, target: int) -> int:
    """torchvision CenterCrop's anchor, ``int(round((size - target) / 2))``
    with round-half-to-even; a smaller image is padded top-left by
    ``(target - size) // 2`` first."""
    if size >= target:
        return int(round((size - target) / 2.0))
    return -((target - size) // 2)


def _center_crop_square(arr: np.ndarray, target: int) -> np.ndarray:
    h, w = arr.shape[:2]
    out = np.zeros((target, target, 3), np.uint8)
    top, left = _crop_anchor(h, target), _crop_anchor(w, target)
    src_y0, src_x0 = max(top, 0), max(left, 0)
    src_y1, src_x1 = min(h, top + target), min(w, left + target)
    dst_y0, dst_x0 = src_y0 - top, src_x0 - left
    out[dst_y0 : dst_y0 + (src_y1 - src_y0), dst_x0 : dst_x0 + (src_x1 - src_x0)] = arr[
        src_y0:src_y1, src_x0:src_x1
    ]
    return out


def _decode_to_square(
    img: Image.Image, target: int, *, resize: bool, crop: bool, resize_target: int | None = None
) -> np.ndarray:
    if resize:
        img = _resize_shorter(img, resize_target or target)
    arr = np.asarray(img, dtype=np.uint8)
    if arr.ndim == 2:
        arr = np.stack([arr] * 3, axis=-1)
    if crop or arr.shape[:2] != (target, target):
        arr = _center_crop_square(arr, target)  # the batch needs a static square
    return arr


def decode_pil_eval(img: Image.Image, plan: EvalTransformPlan) -> np.ndarray:
    """An open PIL image -> uint8 [img_size, img_size, 3]."""
    if img.mode != "RGB":  # three channels even with ensure_rgb off
        img = img.convert("RGB")
    return _decode_to_square(
        img, plan.img_size, resize=plan.resize, crop=plan.center_crop,
        resize_target=plan.resize_size or plan.img_size,
    )


def decode_eval(path: str | Path, plan: EvalTransformPlan) -> np.ndarray:
    """An image file -> uint8 [img_size, img_size, 3]."""
    with Image.open(path) as img:
        return decode_pil_eval(img, plan)


def decode_pil_train(img: Image.Image, plan: TrainTransformPlan) -> np.ndarray:
    """An open PIL image -> the uint8 square canvas [host_canvas_size]^2 x 3."""
    if img.mode != "RGB":
        img = img.convert("RGB")
    return _decode_to_square(img, plan.host_canvas_size, resize=plan.resize, crop=True)


def decode_train(path: str | Path, plan: TrainTransformPlan) -> np.ndarray:
    """An image file -> the uint8 square canvas [host_canvas_size]^2 x 3."""
    with Image.open(path) as img:
        return decode_pil_train(img, plan)
