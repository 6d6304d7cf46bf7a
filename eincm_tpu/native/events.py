"""ctypes bindings to the native event-ingest kernels (events.cpp).

`rectify_filter_events` replaces the numpy gather/round/mask/compact in the
DSEC loader (reference: src/dataloaders/dsec_loader.py:145-171) with one
streaming multithreaded pass. Callers fall back to numpy when the shared
object is unavailable.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import numpy as np

from eincm_tpu.native.build import build

_lib: Optional[ctypes.CDLL] = None


def _load() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None:
        return _lib
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))

    def ptr(dt):
        return np.ctypeslib.ndpointer(dt, flags="C_CONTIGUOUS")

    lib.rectify_filter_events.argtypes = [
        ptr(np.uint16), ptr(np.uint16), ptr(np.int64), ptr(np.uint8),
        ctypes.c_int64, ptr(np.float32), ctypes.c_int64, ctypes.c_int64,
        ptr(np.int16), ptr(np.int16), ptr(np.int64), ptr(np.uint8),
    ]
    lib.rectify_filter_events.restype = ctypes.c_int64
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def rectify_filter_events(
    x: np.ndarray,
    y: np.ndarray,
    t: np.ndarray,
    p: np.ndarray,
    rectify_map: np.ndarray,
    sensor_size: Tuple[int, int],
):
    """Rectified + in-sensor-filtered event channels (x, y int16; t; p)."""
    lib = _load()
    h, w = sensor_size
    n = len(x)
    x = np.ascontiguousarray(x, np.uint16)
    y = np.ascontiguousarray(y, np.uint16)
    t = np.ascontiguousarray(t, np.int64)
    p = np.ascontiguousarray(p, np.uint8)
    m = np.ascontiguousarray(rectify_map, np.float32)
    ox = np.empty(n, np.int16)
    oy = np.empty(n, np.int16)
    ot = np.empty(n, np.int64)
    op = np.empty(n, np.uint8)
    kept = lib.rectify_filter_events(x, y, t, p, n, m.reshape(-1), h, w,
                                     ox, oy, ot, op)
    kept = int(kept)
    return ox[:kept].copy(), oy[:kept].copy(), ot[:kept].copy(), op[:kept].copy()

