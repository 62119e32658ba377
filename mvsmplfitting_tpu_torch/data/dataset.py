"""Dataset walking for multi-view fitting (port of `data/dataset.py`).

Walks the reference's directory layout
(`data/images/<serial>/<CameraXX>/<frame>.jpg` with keypoints at
`data/keypoints/<serial>/<CameraXX>/<frame>_keypoints.json`,
`data_parser.FittingData`, `code/utils/data_parser.py:272-433`).  Frames
come out as fixed-shape host arrays with view masks, ready to become
the fit's `Observations` on a device (`frame_to_observations`) and to
be stacked into a frame batch (`cat_observations`).

Images are lazy: the fit only needs the image *height* (for the
reference's `data_weight = 500 / H`), read from the file's header;
pixels are read on demand (`load_image`).
"""

from __future__ import annotations

import dataclasses
import os
import struct as _struct
from dataclasses import dataclass
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device
from .keypoints import NUM_BODY_JOINTS, read_joints3d_json, \
    read_keypoints_json


def _jpeg_size(path: str) -> Optional[Tuple[int, int]]:
    """(height, width) from JPEG/PNG headers without decoding pixels."""
    with open(path, "rb") as f:
        head = f.read(32)
        if head[:8] == b"\x89PNG\r\n\x1a\n":
            w, h = _struct.unpack(">II", head[16:24])
            return h, w
        if head[:2] == b"\xff\xd8":  # JPEG: scan for SOFn marker
            f.seek(2)
            while True:
                marker = f.read(2)
                if len(marker) < 2 or marker[0] != 0xFF:
                    return None
                code = marker[1]
                if code in (0xD8, 0x01) or 0xD0 <= code <= 0xD7:
                    continue
                seg_len = _struct.unpack(">H", f.read(2))[0]
                if 0xC0 <= code <= 0xCF and code not in (0xC4, 0xC8, 0xCC):
                    f.read(1)
                    h, w = _struct.unpack(">HH", f.read(4))
                    return h, w
                f.seek(seg_len - 2, os.SEEK_CUR)
    return None


def load_image(path: str) -> np.ndarray:
    """RGB float image in [0, 1] (the reference's convention,
    `data_parser.py:371`), read by `data/images.py`.  No fit reads
    pixels: only the overlays (`viz/overlay.py`, through
    `images.read_image`) and the keypoint front end do."""
    from .images import read_image
    return read_image(path)[:, :, ::-1].astype(np.float32) / 255.0


@dataclass
class FrameData:
    """One frame across all cameras, fixed shapes + masks."""

    serial: str
    frame_name: str
    img_paths: List[Optional[str]]           # per view; None if missing
    keypoints: np.ndarray                    # (V, P, K, 3) padded people
    view_mask: np.ndarray                    # (V,) 1 if view has keypoints
    person_mask: np.ndarray                  # (V, P)
    img_hw: Tuple[int, int]                  # (H, W) of the first live view
    joints3d: Optional[np.ndarray] = None    # (K, 4) first person


def frame_to_observations(frame: FrameData, joint_weights: np.ndarray,
                          person: int = 0, device: DeviceLike = None):
    """FrameData -> the fit's Observations for one person, a batch of one
    frame on `device` (CUDA unless ``device="cpu"``).

    When the annotation set is wider than the stored body keypoints
    (smplx/coco25 maps 25 joints while the OpenPose files carry 17
    body rows; the reference truncates at `data_parser.py:54` and its
    own smplx branch then shape-errors), the missing rows are padded
    with zero confidence so they drop out of the energy.
    """
    from ..fitting.energy import Observations

    dev = resolve_device(device)
    kp = frame.keypoints[:, person]          # (V, K, 3)
    K_target = int(np.asarray(joint_weights).shape[0])
    if kp.shape[1] < K_target:
        pad = np.zeros((kp.shape[0], K_target - kp.shape[1], 3),
                       kp.dtype)
        kp = np.concatenate([kp, pad], axis=1)

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a)[None],
                               dtype=torch.float32, device=dev)

    gt3d = conf3d = None
    if frame.joints3d is not None:
        gt3d = t(frame.joints3d[:, :3])
        conf3d = t(frame.joints3d[:, 3])
    return Observations(gt2d=t(kp[..., :2]), conf=t(kp[..., 2]),
                        view_mask=t(frame.view_mask),
                        joint_weights=t(joint_weights),
                        gt3d=gt3d, conf3d=conf3d)


def cat_observations(obs: Sequence):
    """Observations of several batches, concatenated along the frames."""
    first = obs[0]
    return type(first)(**{
        f.name: (None if getattr(first, f.name) is None
                 else torch.cat([getattr(o, f.name) for o in obs]))
        for f in dataclasses.fields(first)})


class FittingDataset:
    """Iterates frames of `data_folder` grouped across camera dirs."""

    def __init__(self, data_folder: str, img_folder: str = "images",
                 keyp_folder: str = "keypoints",
                 num_body_joints: int = NUM_BODY_JOINTS,
                 use_3d: bool = False,
                 max_people: int = 1):
        self.data_folder = data_folder
        self.img_root = os.path.join(data_folder, img_folder)
        self.keyp_root = os.path.join(data_folder, keyp_folder)
        self.num_body_joints = num_body_joints
        self.use_3d = use_3d
        self.max_people = max_people

        self.serials: List[str] = sorted(
            d for d in os.listdir(self.img_root)
            if os.path.isdir(os.path.join(self.img_root, d)))
        # serial -> list of camera names; frames indexed per camera.
        self._frames: List[Tuple[str, List[str], List[str]]] = []
        for serial in self.serials:
            sdir = os.path.join(self.img_root, serial)
            cams = sorted(d for d in os.listdir(sdir)
                          if os.path.isdir(os.path.join(sdir, d)))
            per_cam = [sorted(
                fn for fn in os.listdir(os.path.join(sdir, c))
                if fn.lower().endswith((".jpg", ".png"))
                and not fn.startswith(".")) for c in cams]
            num_frames = min(len(x) for x in per_cam) if per_cam else 0
            for i in range(num_frames):
                self._frames.append(
                    (serial, cams, [per_cam[v][i] for v in range(len(cams))]))

    def __len__(self) -> int:
        return len(self._frames)

    def num_views(self, serial: Optional[str] = None) -> int:
        for s, cams, _ in self._frames:
            if serial is None or s == serial:
                return len(cams)
        return 0

    def __getitem__(self, idx: int) -> FrameData:
        serial, cams, fnames = self._frames[idx]
        V = len(cams)
        K = self.num_body_joints
        P = self.max_people
        kp = np.zeros((V, P, K, 3), np.float32)
        view_mask = np.zeros((V,), np.float32)
        person_mask = np.zeros((V, P), np.float32)
        img_paths: List[Optional[str]] = []
        keyp_paths: List[Optional[str]] = []
        joints3d = None
        hw = None

        for cam, fname in zip(cams, fnames):
            img_path = os.path.join(self.img_root, serial, cam, fname)
            stem = os.path.splitext(fname)[0]
            keyp_path = os.path.join(self.keyp_root, serial, cam,
                                     stem + "_keypoints.json")
            img_paths.append(img_path)
            keyp_paths.append(keyp_path
                              if os.path.exists(keyp_path) else None)

        from . import native
        if native.available() and not self.use_3d:
            # Native path: all views parsed in one threaded call.
            kp, people = native.parse_keypoints_batch(keyp_paths, P, K)
            for v in range(V):
                if people[v] > 0:
                    view_mask[v] = 1.0
                    person_mask[v, :people[v]] = 1.0
                    if hw is None:
                        hw = _jpeg_size(img_paths[v])
        else:
            for v, keyp_path in enumerate(keyp_paths):
                if keyp_path is None:
                    continue
                people = read_keypoints_json(keyp_path, K)
                if not people:
                    continue
                view_mask[v] = 1.0
                for p, person in enumerate(people[:P]):
                    kp[v, p, :person.shape[0]] = person[:K]
                    person_mask[v, p] = 1.0
                if hw is None:
                    hw = _jpeg_size(img_paths[v])
                if self.use_3d and joints3d is None:
                    j3d = read_joints3d_json(keyp_path)
                    if j3d:
                        joints3d = j3d[0]

        frame_name = os.path.splitext(fnames[0])[0]
        return FrameData(serial=serial, frame_name=frame_name,
                         img_paths=img_paths, keypoints=kp,
                         view_mask=view_mask, person_mask=person_mask,
                         img_hw=hw or (1080, 1920), joints3d=joints3d)

    def __iter__(self) -> Iterator[FrameData]:
        for i in range(len(self)):
            yield self[i]

    def batch(self, frames: Sequence[FrameData]) -> "FrameData":
        """Stack frames on a leading batch axis (arrays only)."""
        return FrameData(
            serial=frames[0].serial,
            frame_name=frames[0].frame_name,
            img_paths=[f.img_paths for f in frames],
            keypoints=np.stack([f.keypoints for f in frames]),
            view_mask=np.stack([f.view_mask for f in frames]),
            person_mask=np.stack([f.person_mask for f in frames]),
            img_hw=frames[0].img_hw,
            joints3d=None)
