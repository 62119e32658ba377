"""ctypes binding of the repository's native keypoint loader
(`native/keypoint_loader.cpp`, built by `make -C native`); port of
`data/native.py`.

A host parser, not a device path: where the library does not load, the
dataset parses the JSONs in Python instead (`available()` says which).
"""

from __future__ import annotations

import ctypes
import functools
import os
from typing import Optional, Sequence, Tuple

import numpy as np


@functools.lru_cache(maxsize=None)
def _find_lib() -> Optional[ctypes.CDLL]:
    here = os.path.dirname(os.path.abspath(__file__))
    for cand in (
            os.path.join(here, "..", "..", "native",
                         "libkeypoint_loader.so"),
            os.path.join(here, "libkeypoint_loader.so"),
    ):
        if not os.path.exists(cand):
            continue
        try:
            lib = ctypes.CDLL(cand)
        except OSError:
            continue
        lib.kp_parse_file.restype = ctypes.c_int
        lib.kp_parse_file.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
            ctypes.c_int, ctypes.c_int]
        lib.kp_parse_batch.restype = ctypes.c_int
        lib.kp_parse_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int),
            ctypes.c_int, ctypes.c_int, ctypes.c_int]
        return lib
    return None


def available() -> bool:
    return _find_lib() is not None


def parse_keypoints_batch(paths: Sequence[Optional[str]],
                          max_people: int = 4, num_joints: int = 17,
                          num_threads: int = 8
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """Parse many keypoint JSONs at once with the native loader.

    Returns (keypoints (N, max_people, num_joints, 3),
    people (N,) int, -1 for missing or unreadable files).
    """
    lib = _find_lib()
    if lib is None:
        raise RuntimeError("native keypoint loader not built "
                           "(run `make -C native`)")
    n = len(paths)
    out = np.zeros((n, max_people, num_joints, 3), np.float32)
    people = np.zeros((n,), np.int32)
    arr = (ctypes.c_char_p * n)(*[(p or "").encode() for p in paths])
    lib.kp_parse_batch(
        arr, n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        people.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        max_people, num_joints, num_threads)
    return out, people
