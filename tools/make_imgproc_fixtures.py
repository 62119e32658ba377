"""Record OpenCV's results of the training augmentation's image calls,
for the port's host routines (`mvsmplfitting_tpu_torch/data/imgproc.py`)
where OpenCV is not installed.

    python tools/make_imgproc_fixtures.py [--out tests/fixtures/imgproc]

Needs OpenCV (the yardstick: cv2 5.0.0), so it runs where it is
installed; the file it writes is committed, and `chip_smoke.py` [train]
replays it with the port alone.  `golden.json` holds, per case, the call
(`op` and its arguments), the seeded input it was made on (`input`:
shape, dtype, seed and value range, rebuilt by `case_input`), and the
sha256 of cv2's output bytes; where the port is held to a bound instead
of bitwise (INTER_LINEAR enlargements, ROADMAP C) the case also stores
cv2's output in `bounded.npz` under its name.

`cases()` lists the calls; `run_port(case)` runs the port's routine on a
case and `run_cv2(case)` OpenCV's; `tests/test_torch_augment.py` checks
that the committed file still matches both.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "tests", "fixtures", "imgproc")


def _rot(deg, scale, tx, ty):
    a = np.deg2rad(deg)
    return [[scale * np.cos(a), scale * np.sin(a), tx],
            [-scale * np.sin(a), scale * np.cos(a), ty]]


def cases():
    """The recorded calls: the warps of the pose crops (float32, border
    0), `random_affine` (float32, border 114) and uint8 ones, float32
    INTER_LINEAR shrinks (mosaic, letterbox) and an enlargement (mixup's
    jitter), the float64 INTER_CUBIC of `ops/crop.py`, the uint8
    INTER_NEAREST of `uncrop`, and RGB<->HSV on float32."""
    def inp(shape, dtype, seed, hi):
        return {"shape": list(shape), "dtype": dtype, "seed": seed, "hi": hi}
    return [
        {"name": "warp_f32_pose_crop", "op": "warp_affine",
         "input": inp((480, 640, 3), "float32", 1, 1.0),
         "M": _rot(30.0, 0.45, -40.0, 30.0), "out_wh": [192, 256],
         "border": 0.0},
        {"name": "warp_f32_enlarge", "op": "warp_affine",
         "input": inp((60, 50, 3), "float32", 2, 1.0),
         "M": _rot(-12.0, 3.7, 10.0, -15.0), "out_wh": [192, 256],
         "border": 0.0},
        {"name": "warp_f32_affine_114", "op": "warp_affine",
         "input": inp((256, 256, 3), "float32", 3, 255.0),
         "M": [[0.61, 0.04, -20.5], [-0.03, 0.58, 31.25]],
         "out_wh": [128, 128], "border": 114.0},
        {"name": "warp_u8_rotate_114", "op": "warp_affine",
         "input": inp((90, 120, 3), "uint8", 4, 256),
         "M": _rot(47.0, 1.3, 30.0, -60.0), "out_wh": [150, 110],
         "border": 114.0},
        {"name": "warp_u8_gray_shrink", "op": "warp_affine",
         "input": inp((200, 160), "uint8", 5, 256),
         "M": _rot(5.0, 0.35, 2.5, 1.5), "out_wh": [61, 77], "border": 0.0},
        {"name": "resize_linear_f32_shrink", "op": "resize_linear",
         "input": inp((540, 960, 3), "float32", 6, 255.0),
         "out_wh": [320, 180]},
        {"name": "resize_linear_f32_shrink_odd", "op": "resize_linear",
         "input": inp((130, 170, 3), "float32", 7, 255.0),
         "out_wh": [64, 49]},
        {"name": "resize_linear_f32_enlarge", "op": "resize_linear",
         "input": inp((24, 32, 3), "float32", 8, 255.0),
         "out_wh": [65, 49], "bounded": True},
        {"name": "resize_cubic_f64", "op": "resize_cubic",
         "input": inp((70, 60, 3), "float64", 9, 255.0),
         "out_wh": [64, 64]},
        {"name": "resize_nearest_u8", "op": "resize_nearest",
         "input": inp((33, 47, 3), "uint8", 10, 256), "out_wh": [70, 80]},
        {"name": "rgb_to_hsv_f32", "op": "rgb_to_hsv",
         "input": inp((100, 77, 3), "float32", 11, 1.0)},
        {"name": "hsv_to_rgb_f32", "op": "hsv_to_rgb",
         "input": inp((100, 77, 3), "float32", 12, 1.0)},
    ]


def case_input(case) -> np.ndarray:
    """The case's input: uniform in [0, hi) from `seed` (integers for
    uint8); an HSV input has H in [0, 360), S and V in [0, 1)."""
    spec = case["input"]
    rng = np.random.default_rng(spec["seed"])
    shape = tuple(spec["shape"])
    if spec["dtype"] == "uint8":
        return rng.integers(0, spec["hi"], shape, dtype=np.uint8)
    x = rng.uniform(0, spec["hi"], shape).astype(spec["dtype"])
    if case["op"] == "hsv_to_rgb":
        x[..., 0] = (x[..., 0] * 360.0).astype(np.float32)
    return x


def run_port(case) -> np.ndarray:
    sys.path.insert(0, ROOT)
    from mvsmplfitting_tpu_torch.data import imgproc

    x = case_input(case)
    op = case["op"]
    if op == "warp_affine":
        return imgproc.warp_affine(x, np.asarray(case["M"]), case["out_wh"],
                                   case["border"])
    if op in ("resize_linear", "resize_cubic", "resize_nearest"):
        return getattr(imgproc, op)(x, case["out_wh"])
    return getattr(imgproc, op)(x)


def run_cv2(case) -> np.ndarray:
    import cv2

    x = case_input(case)
    op = case["op"]
    if op == "warp_affine":
        return cv2.warpAffine(x, np.asarray(case["M"]),
                              tuple(case["out_wh"]), flags=cv2.INTER_LINEAR,
                              borderValue=(case["border"],) * 3)
    if op.startswith("resize_"):
        flag = {"resize_linear": cv2.INTER_LINEAR,
                "resize_cubic": cv2.INTER_CUBIC,
                "resize_nearest": cv2.INTER_NEAREST}[op]
        return cv2.resize(x, tuple(case["out_wh"]), interpolation=flag)
    code = (cv2.COLOR_RGB2HSV if op == "rgb_to_hsv" else cv2.COLOR_HSV2RGB)
    return cv2.cvtColor(x, code)


def sha(a: np.ndarray) -> str:
    a = np.ascontiguousarray(a)
    h = hashlib.sha256(str((a.shape, a.dtype.str)).encode())
    h.update(a.tobytes())
    return h.hexdigest()


def build():
    """(golden dict, {name: cv2 output} of the bounded cases)."""
    import cv2

    golden = {"opencv": cv2.__version__, "cases": []}
    bounded = {}
    for case in cases():
        out = run_cv2(case)
        golden["cases"].append(dict(case, sha256=sha(out)))
        if case.get("bounded"):
            bounded[case["name"]] = out
    return golden, bounded


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=OUT)
    args = p.parse_args(argv)
    golden, bounded = build()
    os.makedirs(args.out, exist_ok=True)
    with open(os.path.join(args.out, "golden.json"), "w") as f:
        json.dump(golden, f, indent=1)
        f.write("\n")
    np.savez_compressed(os.path.join(args.out, "bounded.npz"), **bounded)
    print(f"wrote {len(golden['cases'])} cases to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
