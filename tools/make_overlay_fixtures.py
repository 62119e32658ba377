"""Write the fixtures that hold the port's overlays to OpenCV and JAX
where neither is installed.

    python tools/make_overlay_fixtures.py [--out tests/fixtures/overlay]

Needs OpenCV and the JAX package (it records what `cv2` draws and encodes
and what JAX's `viz/overlay.py` renders), so it runs where both are
installed; the files it writes are committed and `chip_smoke.py` replays
them with the port alone.  It writes

* `verts.npy`: the synthetic SMPL body of `tests/fixtures/images/views`
  (frame 0 of `synthetic.true_params(1, 0)`, 6890 vertices, float32);
* `order.npy`: the far-to-near face order of that body's render in
  view 0, as `np.argsort` orders its depths here (int16);
* `golden.json`:
  - `primitives`: groups of seeded cv2 drawing calls (line, circle,
    fillConvexPoly, rectangle, ellipse2Poly, addWeighted), written out
    call by call, each group applied in turn to a patterned image, with
    the sha256 of the image after each group (of the points for
    ellipse2Poly);
  - `fill_faces`: 400 seeded triangles, their colors and a face order,
    and the sha256 of OpenCV's painter's loop over them;
  - `jpeg`: per fixture view, the sha256 of `cv2.imencode(".jpg")` at
    quality 95 and 80;
  - `render`: view 0's camera and the sha256 of JAX's
    `render_mesh_overlay` of `verts.npy` on `Camera00.jpg`, with those
    of the projected corners and face colors it drew from.

`build(verts)` returns all of it; `tests/test_torch_viz.py` calls it with
the committed vertices and checks that the committed files still match.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
VIEWS = os.path.join(ROOT, "tests", "fixtures", "images", "views")
OUT = os.path.join(ROOT, "tests", "fixtures", "overlay")
H, W = 120, 160            # the primitives' image


def sha(a) -> str:
    if isinstance(a, np.ndarray):
        a = np.ascontiguousarray(a).tobytes()
    return hashlib.sha256(a).hexdigest()


def pattern(h: int = H, w: int = W, k: int = 0) -> np.ndarray:
    """A deterministic BGR image: stripes and a product term."""
    y, x, c = np.meshgrid(np.arange(h), np.arange(w), np.arange(3),
                          indexing="ij")
    return ((x * 7 + y * 13 + c * 101 + (x * y) % 31 + 57 * k) % 256
            ).astype(np.uint8)


def body_verts() -> np.ndarray:
    import torch

    from mvsmplfitting_tpu_torch.models import vposer as V
    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    from mvsmplfitting_tpu_torch.models.smpl import SMPLParams, smpl_forward
    from mvsmplfitting_tpu_torch.synthetic import VPOSER_NPZ, true_params

    assets = synthetic_smpl("smpl", device="cpu")
    vw = V.load_npz(VPOSER_NPZ, device="cpu")
    z, cols = true_params(1, 0)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float32)

    params = SMPLParams(betas=t(cols["betas"]),
                        global_orient=t(cols["global_orient"]),
                        body_pose=torch.zeros((1, 69)),
                        transl=t(cols["transl"]), scale=t(cols["scale"]))
    return smpl_forward(assets, params, V.decode(vw, t(z)))[0][0].numpy()


def view_camera(v: int = 0) -> dict:
    import torch

    from mvsmplfitting_tpu_torch.synthetic import orbit_cameras
    cam = orbit_cameras(6, torch.device("cpu"))
    return {k: getattr(cam, k)[v].numpy().astype(np.float32).tolist()
            for k in ("rotation", "translation", "focal", "center")}


def primitive_groups(rng) -> list:
    """Groups of calls [op, *args]: points reach off the image, some
    shapes are degenerate (one or two points, zero radius, zero length)
    and some thick."""
    def pt():
        return [int(v) for v in rng.integers(-40, 200, 2)]

    def col():
        return [int(v) for v in rng.integers(0, 256, 3)]

    def poly(n):
        c = rng.integers(-20, 180, 2)
        ang = np.sort(rng.uniform(0, 2 * np.pi, n))
        r = rng.uniform(0, 60)
        return np.stack([c[0] + r * np.cos(ang), c[1] + r * np.sin(ang)],
                        1).round().astype(int).tolist()

    groups = []
    for lt in (8, 16):
        groups.append((f"line_thin_lt{lt}", [
            ["line", pt(), pt(), col(), 1, lt] for _ in range(30)]
            + [["line", [5, 5], [5, 5], col(), 1, lt]]))
        groups.append((f"line_thick_lt{lt}", [
            ["line", pt(), pt(), col(), int(rng.integers(2, 9)), lt]
            for _ in range(20)]))
    for lt in (8, 16):
        for th in (-1, 1, 2, 4):
            groups.append((f"circle_th{th}_lt{lt}", [
                ["circle", pt(), int(rng.integers(0, 50)), col(), th, lt]
                for _ in range(15)]))
        groups.append((f"fill_convex_poly_lt{lt}", [
            ["fill_convex_poly", poly(int(rng.integers(1, 8))), col(), lt]
            for _ in range(25)] + [
            ["fill_convex_poly", [[10, 10], [60, 10], [110, 10]], col(), lt],
            ["fill_convex_poly", [[-5000, -4000], [6000, 50], [30, 7000]],
             col(), lt]]))
    groups.append(("rectangle", [
        ["rectangle", pt(), pt(), col(), int(th), 8]
        for th in rng.choice([-1, 1, 2, 3], 20)]))
    groups.append(("ellipse2poly", [
        ["ellipse2poly", pt(), [int(v) for v in rng.integers(0, 90, 2)],
         int(rng.integers(-400, 400)), int(rng.integers(-400, 400)),
         int(rng.integers(-400, 400)), int(rng.integers(1, 46))]
        for _ in range(40)]))
    groups.append(("add_weighted", [
        ["add_weighted", float(a), float(1 - a), 0.0]
        for a in rng.uniform(0, 1, 6)]))
    return groups


def cv2_api():
    import cv2
    return {"line": cv2.line, "circle": cv2.circle,
            "fill_convex_poly": lambda img, p, c, lt: cv2.fillConvexPoly(
                img, np.asarray(p, np.int32), c, lt),
            "rectangle": cv2.rectangle, "ellipse2poly": cv2.ellipse2Poly,
            "add_weighted": cv2.addWeighted}


def replay(groups, api) -> dict:
    """Apply each group's calls in turn with `api` (cv2's functions or the
    port's, by op name) to `pattern()`; the sha256 after each group."""
    img = pattern()
    other = pattern(k=1)
    out = {}
    for name, calls in groups:
        if calls[0][0] == "ellipse2poly":
            pts = [np.asarray(api["ellipse2poly"](*c[1:]), np.int32)
                   for c in calls]
            out[name] = sha(b"".join(p.tobytes() for p in pts))
            continue
        for op, *args in calls:
            if op == "add_weighted":
                img = np.ascontiguousarray(
                    api["add_weighted"](img, args[0], other, *args[1:]))
            else:
                api[op](img, *(tuple(a) if isinstance(a, list) and op != (
                    "fill_convex_poly") else a for a in args))
        out[name] = sha(img)
    return out


def triangles(rng, n: int = 400):
    pts = rng.integers(-60, 220, (n, 3, 2)).astype(np.int32)
    colors = rng.uniform(0, 255, (n, 3))
    order = rng.permutation(n)[: n - 7]
    return pts, colors, order


def cv2_fill_faces(layer, pts, colors, order):
    import cv2
    for f in order:
        c = tuple(int(v) for v in colors[f])
        cv2.fillConvexPoly(layer, pts[f], c, lineType=cv2.LINE_AA)
    return layer


def build(verts: np.ndarray = None):
    """(verts, order, golden) as committed; `verts` defaults to
    `body_verts()`."""
    import cv2

    from mvsmplfitting_tpu.viz import overlay as JO

    if verts is None:
        verts = body_verts()
    rng = np.random.default_rng(20261018)
    groups = primitive_groups(rng)
    golden = {"size": [H, W], "primitives": [
        {"name": n, "calls": c} for n, c in groups]}
    for g, (name, digest) in zip(golden["primitives"],
                                 replay(groups, cv2_api()).items()):
        g["sha256"] = digest
    pts, colors, order = triangles(rng)
    golden["fill_faces"] = {
        "pts": pts.tolist(), "colors": colors.tolist(),
        "order": order.tolist(),
        "sha256": sha(cv2_fill_faces(pattern(200, 240), pts, colors,
                                     order))}
    golden["jpeg"] = {}
    for v in range(6):
        name = f"Camera0{v}.jpg"
        img = cv2.imread(os.path.join(VIEWS, name))
        golden["jpeg"][name] = {
            str(q): sha(cv2.imencode(".jpg", img,
                                     [cv2.IMWRITE_JPEG_QUALITY, q])[1])
            for q in (95, 80)}

    from mvsmplfitting_tpu_torch.models.assets import synthetic_smpl
    faces = synthetic_smpl("smpl", device="cpu").faces.numpy()
    cam = view_camera(0)
    R, t, f, c = (np.asarray(cam[k], np.float32) for k in (
        "rotation", "translation", "focal", "center"))
    img = cv2.imread(os.path.join(VIEWS, "Camera00.jpg"))
    render = JO.render_mesh_overlay(img, verts, faces, R, t, f, c)
    # JAX's own intermediates (`overlay.py:54-80`).
    pix, depth = JO._project(R, t, f, c, verts)
    tri_pix = np.nan_to_num(pix[faces], posinf=0.0, neginf=0.0)
    tri_w = verts[faces]
    n = np.cross(tri_w[:, 1] - tri_w[:, 0], tri_w[:, 2] - tri_w[:, 0])
    n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-12)
    shade = 0.35 + 0.65 * np.abs(n @ R[2])
    base = np.tile(np.asarray((0.65, 0.74, 0.86)) * 255.0, (len(faces), 1))
    order_full = np.argsort(-depth[faces].mean(axis=1))
    golden["render"] = {
        "image": "Camera00.jpg", "camera": cam, "sha256": sha(render),
        "pts_sha256": sha(np.round(tri_pix).astype(np.int32)),
        "colors_sha256": sha(base * shade[:, None]),
        "painted": int((render != img).any(-1).sum())}
    return verts, order_full.astype(np.int16), golden


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args()
    verts, order, golden = build()
    os.makedirs(args.out, exist_ok=True)
    np.save(os.path.join(args.out, "verts.npy"), verts)
    np.save(os.path.join(args.out, "order.npy"), order)
    with open(os.path.join(args.out, "golden.json"), "w") as fh:
        json.dump(golden, fh, separators=(",", ":"))
        fh.write("\n")
    print(f"wrote {args.out}: {len(golden['primitives'])} primitive groups, "
          f"render painted {golden['render']['painted']} px")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
