"""Temporal smoothing filters for fitted sequences (port of
`utils/filters.py`, host numpy and scipy as there).

The reference keeps a zero-phase Butterworth low-pass for smoothing
per-frame parameter tracks (`code/utils/module_utils.py:13-18`
``filter_butter``: ``scipy.signal.butter`` + ``filtfilt`` over the
time axis).  Same contract here, host-side numpy/scipy: data is
(T, D), filtering runs along T independently per channel.
"""

from __future__ import annotations

import numpy as np

__all__ = ["filter_butter"]


def filter_butter(data: np.ndarray, N: int = 5, Wn: float = 0.5,
                  btype: str = "low") -> np.ndarray:
    """Zero-phase Butterworth filter over the leading (time) axis.

    Mirrors the reference exactly, including its quirk of ignoring the
    ``btype`` argument (the design call hardcodes 'low',
    `module_utils.py:15`).
    """
    from scipy import signal

    filterdata = np.asarray(data).copy()
    b, a = signal.butter(N, Wn, "low")
    return signal.filtfilt(b, a, filterdata.T).T.copy()
