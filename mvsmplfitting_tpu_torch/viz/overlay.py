"""Per-view mesh overlays (port of `viz/overlay.py`).

The reference renders its fitted meshes over every camera image with
pyrender (`code/utils/utils.py:876-882`); the JAX package replaced that
with a painter's-algorithm rasterizer drawn with cv2, and this is the
same rasterizer without OpenCV: the projection, culls, Lambert shading
and the far-to-near sort are JAX's numpy code, the painter's loop is one
`viz/draw.py:fill_faces` call (OpenCV's anti-aliased `fillConvexPoly`,
face by face, in host C++), the blend is `draw.blend_changed`, and the
images are read and written by `data/images.py` (`cv2.imread` and
`cv2.imwrite`'s bytes).  Overlays of the same vertices are the same
files JAX writes.

The numpy calls are JAX's on purpose: `points @ R.T` and `n @ view_dir`
go through the host's BLAS, and `np.argsort`'s default kind orders tied
depths as the host's numpy does, so the render equals JAX's on one host;
pass `order` to pin the face order.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

from ..data.images import read_image, write_image
from . import draw

# COCO17 skeleton edges for keypoint drawing (`module_utils.py:543-572`).
COCO17_EDGES = (
    (0, 1), (0, 2), (1, 3), (2, 4), (5, 6), (5, 7), (7, 9), (6, 8),
    (8, 10), (5, 11), (6, 12), (11, 12), (11, 13), (13, 15), (12, 14),
    (14, 16),
)

# Halpe-26 skeleton (AlphaPose's default joint set: the body and foot
# rows of the reference's `l_pair` table, `alphapose/utils/vis.py:94-109`).
HALPE26_EDGES = (
    (0, 1), (0, 2), (1, 3), (2, 4),                       # head
    (5, 18), (6, 18), (5, 7), (7, 9), (6, 8), (8, 10),    # arms
    (17, 18), (18, 19), (19, 11), (19, 12),               # spine/hips
    (11, 13), (12, 14), (13, 15), (14, 16),               # legs
    (20, 24), (21, 25), (23, 25), (22, 24), (15, 24), (16, 25),  # feet
)

# Per-person mesh tints (BGR pastels, cycled), mirroring the reference's
# distinct colors in `render_multiperson` (`utils.py:1030-1100`).
PERSON_COLORS = ((0.65, 0.74, 0.86), (0.86, 0.68, 0.60),
                 (0.62, 0.84, 0.66), (0.85, 0.83, 0.58),
                 (0.78, 0.62, 0.84), (0.60, 0.82, 0.84))


class _Clock:
    """Adds the seconds since the last mark to `timer` under a name."""

    def __init__(self, timer):
        self.timer = timer
        self.t = time.perf_counter()

    def mark(self, name: str) -> None:
        t = time.perf_counter()
        if self.timer is not None:
            self.timer.timings.setdefault(name, []).append(t - self.t)
        self.t = t


def _project(rotation, translation, focal, center, points):
    cam = points @ rotation.T + translation
    z = cam[:, 2:3]
    xy = cam[:, :2] / np.maximum(z, 1e-9)
    return xy * focal + center, cam[:, 2]


def face_order(img_hw, verts: np.ndarray, faces: np.ndarray,
               rotation, translation, focal, center,
               depth_order: Optional[np.ndarray] = None):
    """(pts (F, 3, 2) int32, shade (F,), order): the projected corners,
    the Lambert shade and the far-to-near order of the faces that pass
    the culls (`overlay.py:54-80`); `depth_order` stands for
    `np.argsort(-tri_depth)`."""
    h, w = img_hw
    pix, depth = _project(rotation, translation, focal, center, verts)

    tri_pix = pix[faces]                    # (F, 3, 2)
    tri_depth = depth[faces].mean(axis=1)   # (F,)

    # Cull behind-camera, offscreen and non-finite faces (un-converged or
    # random-weight inputs can carry NaN vertices).
    valid = (depth[faces] > 1e-6).all(axis=1)
    with np.errstate(invalid="ignore"):
        inside = ((tri_pix[..., 0] > -w) & (tri_pix[..., 0] < 2 * w) &
                  (tri_pix[..., 1] > -h) & (tri_pix[..., 1] < 2 * h)
                  ).all(axis=1)
    valid &= inside & np.isfinite(tri_pix).all(axis=(1, 2))
    tri_pix = np.nan_to_num(tri_pix, posinf=0.0, neginf=0.0)

    # Lambert shading from the face normal against the view direction.
    tri_w = verts[faces]                    # (F, 3, 3)
    n = np.cross(tri_w[:, 1] - tri_w[:, 0], tri_w[:, 2] - tri_w[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    view_dir = rotation[2]                  # camera z-axis in world frame
    shade = np.abs(n @ view_dir)
    shade = 0.35 + 0.65 * shade             # ambient + diffuse

    order = np.argsort(-tri_depth) if depth_order is None \
        else np.asarray(depth_order, np.int64)      # far -> near
    order = order[valid[order]]
    pts = np.round(tri_pix).astype(np.int32)
    return pts, shade, order


def _rasterize(img: np.ndarray, verts: np.ndarray, faces: np.ndarray,
               base_colors: np.ndarray, rotation: np.ndarray,
               translation: np.ndarray, focal: np.ndarray,
               center: np.ndarray, alpha: float,
               order: Optional[np.ndarray] = None,
               timer=None) -> np.ndarray:
    """Painter's-algorithm fill: one global far-to-near sort over every
    face (base_colors (F, 3) 0-255), so that occlusion is right across
    everything drawn in one call.  `order` replaces the depth sort's
    result (the culls still apply); `timer` (a `StageTimer`) collects the
    seconds of "overlay.project", "overlay.fill" and "overlay.blend"."""
    clock = _Clock(timer)
    pts, shade, order = face_order(img.shape[:2], verts, faces, rotation,
                                   translation, focal, center, order)
    colors = base_colors * shade[:, None]
    clock.mark("overlay.project")
    layer = np.ascontiguousarray(img).copy()
    draw.fill_faces(layer, pts, colors, order)
    clock.mark("overlay.fill")
    # Alpha blend only where the mesh drew.
    out = draw.blend_changed(img, layer, alpha)
    clock.mark("overlay.blend")
    return out


def render_mesh_overlay(img: np.ndarray, verts: np.ndarray,
                        faces: np.ndarray, rotation: np.ndarray,
                        translation: np.ndarray, focal: np.ndarray,
                        center: np.ndarray, color=(0.65, 0.74, 0.86),
                        alpha: float = 0.9,
                        order: Optional[np.ndarray] = None,
                        timer=None) -> np.ndarray:
    """Composite the mesh over `img` (uint8 BGR or RGB, returned the
    same); the inputs are host arrays (numpy), as JAX's.  `order` pins
    the far-to-near face order (`np.argsort(-depth)`'s result)."""
    base = np.tile(np.asarray(color, np.float64) * 255.0,
                   (len(faces), 1))
    return _rasterize(img, np.asarray(verts), np.asarray(faces), base,
                      rotation, translation, focal, center, alpha, order,
                      timer)


def render_multiperson_overlay(img: np.ndarray, verts_people,
                               faces: np.ndarray, rotation: np.ndarray,
                               translation: np.ndarray,
                               focal: np.ndarray, center: np.ndarray,
                               colors=None, alpha: float = 0.9,
                               timer=None) -> np.ndarray:
    """All people in one depth-sorted pass (the reference's
    `Renderer.render_multiperson`, `utils.py:1030-1100`): the faces of
    different people interleave in one far-to-near order, so that
    inter-person occlusion is right.

    verts_people: (P, V, 3) array or list of (V, 3) arrays.
    """
    verts_people = [np.asarray(v) for v in verts_people]
    if not verts_people:
        return img.copy()
    faces = np.asarray(faces)
    if colors is None:
        colors = [PERSON_COLORS[p % len(PERSON_COLORS)]
                  for p in range(len(verts_people))]
    all_verts = np.concatenate(verts_people, axis=0)
    all_faces, all_colors = [], []
    off = 0
    for p, v in enumerate(verts_people):
        all_faces.append(faces + off)
        all_colors.append(np.tile(
            np.asarray(colors[p], np.float64) * 255.0,
            (len(faces), 1)))
        off += len(v)
    return _rasterize(img, all_verts, np.concatenate(all_faces),
                      np.concatenate(all_colors), rotation, translation,
                      focal, center, alpha, timer=timer)


def draw_keypoints(img: np.ndarray, keypoints: np.ndarray,
                   conf_thresh: float = 0.2) -> np.ndarray:
    """Draw a skeleton (x, y, conf) onto the image in place.

    The edge table follows the joint count: 26 -> Halpe-26, 17 -> COCO17,
    any other count through the skeleton registry (`viz/skeletons.py`);
    unknown counts fall back to COCO17, extra joints still get circles.
    """
    kp = np.asarray(keypoints, np.float64)
    # Non-finite or absurd coordinates would overflow int32: drop them.
    ok = (np.isfinite(kp[:, :2]).all(axis=1)
          & (np.abs(kp[:, :2]) < 1e8).all(axis=1)
          & (kp[:, 2] > conf_thresh))
    pts = np.round(np.clip(np.nan_to_num(kp[:, :2]), -1e8, 1e8)
                   ).astype(np.int32)
    if len(kp) == 26:
        edges = HALPE26_EDGES
    elif len(kp) == 17:
        edges = COCO17_EDGES
    else:
        from .skeletons import skeleton_for
        edges = skeleton_for(len(kp)).limbs
    for a, b in edges:
        if a < len(kp) and b < len(kp) and ok[a] and ok[b]:
            draw.line(img, tuple(int(v) for v in pts[a]),
                      tuple(int(v) for v in pts[b]),
                      (0, 255, 255), 2, draw.LINE_AA)
    for j in range(len(kp)):
        if ok[j]:
            draw.circle(img, tuple(int(v) for v in pts[j]), 3,
                        (0, 0, 255), -1, draw.LINE_AA)
    return img


def _cameras_np(cameras):
    def host(t):
        return t.detach().cpu().numpy() if hasattr(t, "detach") \
            else np.asarray(t)
    return (host(cameras.rotation), host(cameras.translation),
            host(cameras.focal), host(cameras.center))


def _views(out_dir: str, img_paths: Sequence[Optional[str]], render,
           timer=None) -> None:
    """Render and write `<out_dir>/<v:02d>.jpg` for each view whose image
    exists, one host thread a view (the image library calls release the
    GIL); the files are those a loop over the views would write."""
    os.makedirs(out_dir, exist_ok=True)

    def one(v: int) -> None:
        img_path = img_paths[v]
        if img_path is None or not os.path.exists(img_path):
            return
        clock = _Clock(timer)
        img = read_image(img_path)
        clock.mark("overlay.read")
        out = render(v, img)
        clock = _Clock(timer)
        write_image(os.path.join(out_dir, f"{v:02d}.jpg"), out)
        clock.mark("overlay.encode")

    n = len(img_paths)
    with ThreadPoolExecutor(max(1, min(n, os.cpu_count() or 1))) as pool:
        list(pool.map(one, range(n)))


def save_overlays(out_dir: str, frame, cameras, verts: np.ndarray,
                  faces: np.ndarray, joints: Optional[np.ndarray] = None,
                  timer=None) -> None:
    """Write one overlay jpg per view of the frame that has an image,
    with the view's keypoints where it has them."""
    R, t, f, c = _cameras_np(cameras)

    def render(v, img):
        out = render_mesh_overlay(img, verts, faces, R[v], t[v], f[v], c[v],
                                  timer=timer)
        if frame.view_mask[v] > 0:
            draw_keypoints(out, frame.keypoints[v, 0])
        return out

    _views(out_dir, frame.img_paths, render, timer)


def save_overlays_multi(out_dir: str, frame, cameras, verts_people,
                        faces: np.ndarray,
                        live: Optional[np.ndarray] = None,
                        timer=None) -> None:
    """Multi-person counterpart of `save_overlays`: every live person's
    mesh in one jointly depth-sorted render per view, plus each person's
    keypoints where annotated.

    verts_people: (P, V, 3); live: (P,) person-present mask.
    """
    P = len(verts_people)
    if live is None:
        live = np.ones((P,), bool)
    keep = [p for p in range(P) if live[p]]
    R, t, f, c = _cameras_np(cameras)

    def render(v, img):
        out = render_multiperson_overlay(
            img, [verts_people[p] for p in keep], faces,
            R[v], t[v], f[v], c[v],
            colors=[PERSON_COLORS[p % len(PERSON_COLORS)] for p in keep],
            timer=timer)
        if frame.view_mask[v] > 0:
            for p in keep:
                if frame.person_mask[v, p] > 0:
                    draw_keypoints(out, frame.keypoints[v, p])
        return out

    _views(out_dir, frame.img_paths, render, timer)
