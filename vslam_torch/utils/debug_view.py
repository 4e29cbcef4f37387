"""Per-frame tracked-keypoint overlay images (the port of
vslam_tpu/utils/debug_view.py).

The reference draws its tracked keypoints on every frame in a live OpenCV
window (drawKeys, reference src/FeatureTracker.cpp:1686-1697). This
headless equivalent renders the same diagnostic as a PNG: every detected
key, the subset matched to a map landmark, and the surviving inliers, in
distinct colors. numpy rasterization; PIL only encodes the file.
"""

from __future__ import annotations

import os

import numpy as np
import torch

# BGR-ish palette on the gray frame
COLOR_DETECTED = (90, 90, 230)  # soft red: detection without a map match
COLOR_MATCHED = (60, 200, 255)  # amber: matched to a landmark, chi2 outlier
COLOR_INLIER = (80, 230, 80)  # green: match survived the pose solve


def _mark(img: np.ndarray, xy: np.ndarray, color, half: int = 2):
    """Draw `half*2+1`-px hollow squares at integer key positions —
    vectorized bounds-checked scatter, no per-key python loop."""
    H, W, _ = img.shape
    if len(xy) == 0:
        return
    x = np.round(xy[:, 0]).astype(np.int64)
    y = np.round(xy[:, 1]).astype(np.int64)
    ok = (x >= half) & (x < W - half) & (y >= half) & (y < H - half)
    x, y = x[ok], y[ok]
    rng = np.arange(-half, half + 1)
    # top/bottom edges
    xs = (x[:, None] + rng[None, :]).reshape(-1)
    yt = np.repeat(y - half, len(rng))
    yb = np.repeat(y + half, len(rng))
    # left/right edges
    ys = (y[:, None] + rng[None, :]).reshape(-1)
    xl = np.repeat(x - half, len(rng))
    xr = np.repeat(x + half, len(rng))
    for yy, xx in ((yt, xs), (yb, xs), (ys, xl), (ys, xr)):
        img[yy, xx] = color


def render_overlay(
    gray: np.ndarray,
    keys_xy: np.ndarray,  # (N, 2)
    keys_valid: np.ndarray,  # (N,) bool
    matched_keys: np.ndarray,  # (M,) key indices matched to landmarks
    inlier_keys: np.ndarray,  # (I,) key indices that survived the solve
    stats: dict | None = None,
) -> np.ndarray:
    """(H, W, 3) uint8 overlay. Inliers override matched override
    detected."""
    img = np.repeat(
        np.clip(gray, 0, 255).astype(np.uint8)[..., None], 3, axis=-1
    )
    det = np.nonzero(keys_valid)[0]
    det = np.setdiff1d(det, matched_keys)
    matched_only = np.setdiff1d(matched_keys, inlier_keys)
    _mark(img, keys_xy[det], COLOR_DETECTED, half=1)
    _mark(img, keys_xy[matched_only], COLOR_MATCHED, half=2)
    _mark(img, keys_xy[inlier_keys], COLOR_INLIER, half=2)
    if stats:
        _draw_counts(img, stats)
    return img


def _draw_counts(img: np.ndarray, stats: dict):
    """Tiny 3x5 digit readout top-left: n_inliers / n_matched / n_keys."""
    text = "{}/{}/{}".format(
        stats.get("n_inliers", 0), stats.get("n_matched", 0), stats.get("n_keys", 0)
    )
    x = 4
    for ch in text:
        glyph = _FONT.get(ch)
        if glyph is not None:
            h, w = glyph.shape
            y0 = 4
            if y0 + h < img.shape[0] and x + w < img.shape[1]:
                img[y0 : y0 + h, x : x + w] = np.where(
                    glyph[..., None] > 0, 255, img[y0 : y0 + h, x : x + w]
                )
        x += 4
    return img


def _font():
    rows = {
        "0": ["111", "101", "101", "101", "111"],
        "1": ["010", "110", "010", "010", "111"],
        "2": ["111", "001", "111", "100", "111"],
        "3": ["111", "001", "111", "001", "111"],
        "4": ["101", "101", "111", "001", "001"],
        "5": ["111", "100", "111", "001", "111"],
        "6": ["111", "100", "111", "101", "111"],
        "7": ["111", "001", "010", "010", "010"],
        "8": ["111", "101", "111", "101", "111"],
        "9": ["111", "101", "111", "001", "111"],
        "/": ["001", "001", "010", "100", "100"],
    }
    return {
        k: np.array([[int(c) for c in r] for r in glyph], np.uint8)
        for k, glyph in rows.items()
    }


_FONT = _font()


def save_overlay(path: str, img: np.ndarray):
    from PIL import Image

    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    Image.fromarray(img).save(path)


def _host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def make_tracker_hook(debug_dir: str, every: int = 10, frame_cache: dict | None = None):
    """Build a tracker ``debug_hook`` that writes an overlay PNG every
    `every`-th processed frame. `frame_cache` maps frame index -> left
    gray image (the caller fills it; processing lags dispatch by the
    pipeline depth, so the hook needs frames kept for a few indices). Only
    on the frames it draws does the hook read the frame's keys, matches and
    inliers from the device."""
    cache = frame_cache if frame_cache is not None else {}

    def hook(frame_idx: int, pose, outputs, stats):
        if frame_idx % every:
            return
        gray = cache.get(frame_idx)
        if gray is None:
            return
        keys = outputs["keys"]
        keys_xy = _host(keys.xy)
        keys_valid = _host(keys.valid)
        midx = _host(outputs["midx"])
        inl = _host(outputs["inliers"])
        matched_keys = midx[midx >= 0]
        inlier_keys = midx[(midx >= 0) & inl]
        img = render_overlay(
            _host(gray), keys_xy, keys_valid, matched_keys, inlier_keys, stats,
        )
        save_overlay(os.path.join(debug_dir, f"frame_{frame_idx:06d}.png"), img)

    hook.cache = cache
    return hook
