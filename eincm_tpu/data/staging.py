"""Datasample staging: raw loader dict -> fixed-shape device-ready sample.

Port of `EINCMExperiment.stage_datasample` (src/experiments/e00/exp_mgr.py:
278-376): timestamp normalization to [0, 1], eval-event sub-slicing when the
optimization window was padded beyond the eval span, and per-frame edge
extraction. Addition: optional padding of the event arrays to a
fixed length (NaN events contribute nothing to any splat/mask) so a whole
sequence compiles one solver program.
"""

from __future__ import annotations

import sys
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np

from eincm_tpu.edge.pipeline import extract_edges
from eincm_tpu.models.pyramid import WindowSample

EPSN = sys.float_info.epsilon


class StagedSample(NamedTuple):
    """Device-ready window plus host-side evaluation data."""

    window: WindowSample  # solver inputs (normalized times, edges)
    images: np.ndarray  # (n_imgs, H, W) float64, preprocessed+normalized
    eval_events: Dict[str, np.ndarray]  # eval-consistent event subset
    gt_flow: Optional[np.ndarray]  # (H, W, 2) or None
    polarities: np.ndarray  # (E,) bool
    t_ref: float
    eval_ts: tuple  # (start, end) raw units
    eval_ts_units: str
    file_idx: Optional[int]
    n_event_deficiency: int


def _normalize_img(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, np.float64)
    return (img - img.min()) / (img.max() - img.min() + EPSN)


def stage_datasample(
    datasample: Dict,
    edge_fn: Optional[Callable] = None,
    preprocess: bool = True,
    pad_to: Optional[int] = None,
    dtype=np.float32,
) -> StagedSample:
    """Stage one raw loader sample.

    Args:
        datasample: loader dict (contract of dsec_loader.py:327-347 /
            mvsec_loader.py:309-319 / ecd_loader.py:124-131).
        edge_fn: images -> (n_imgs, H, W) edge maps; defaults to the full
            preprocess->canny->smoothen pipeline.
        pad_to: optionally pad events to this fixed count with NaNs.
    """
    ev = datasample["events"]
    xs = np.asarray(ev["x"], np.float64)
    ys = np.asarray(ev["y"], np.float64)
    ts = np.asarray(ev["t"], np.float64)
    ps = np.asarray(ev["p"], bool)
    images = np.asarray(datasample["images"], np.float64)
    image_ts = np.asarray(datasample["image_ts"], np.float64)

    if "eval_ts_us" in datasample:
        start_time, end_time = np.asarray(datasample["eval_ts_us"], np.float64)
        ts_units = "us"
    else:
        start_time, end_time = np.asarray(datasample["eval_ts"], np.float64)
        ts_units = "s"

    gt_flow = (
        np.asarray(datasample["flow_gt"], np.float64)
        if "flow_gt" in datasample and datasample["flow_gt"] is not None
        else None
    )
    file_idx = datasample.get("file_idx")
    deficiency = int(datasample.get("n_event_deficiency") or 0)

    # eval-consistent event subset (exp_mgr.py:301-315): when the window was
    # padded (deficiency > 0) the eval set is the interior [start, end] span.
    if deficiency > 0:
        i0, i1 = np.searchsorted(ts, [start_time, end_time])
        sl = slice(max(0, i0 + 1), min(len(xs), i1 - 1))
    else:
        sl = slice(None)
    eval_events = {"x": xs[sl], "y": ys[sl], "t": ts[sl], "p": ps[sl]}

    # normalize all timestamps to the eval span (exp_mgr.py:321-327)
    span = end_time - start_time + EPSN
    ts_n = (ts - start_time) / span
    image_ts_n = (image_ts - start_time) / span
    eval_events["t"] = (eval_events["t"] - start_time) / span

    # edge extraction (exp_mgr.py:335-350)
    images_pp = np.stack([_normalize_img(im) for im in images])
    if edge_fn is None:
        edge_fn = lambda ims: extract_edges(ims, preprocess=preprocess)
    edges = edge_fn(images)

    if pad_to is not None and len(xs) < pad_to:
        pad = pad_to - len(xs)
        fill = np.full(pad, np.nan)
        xs = np.concatenate([xs, fill])
        ys = np.concatenate([ys, fill])
        ts_n = np.concatenate([ts_n, fill])
        ps = np.concatenate([ps, np.zeros(pad, bool)])

    window = WindowSample(
        xs=xs.astype(dtype),
        ys=ys.astype(dtype),
        ts=ts_n.astype(dtype),
        edges=np.asarray(edges, dtype),
        edge_ts=image_ts_n.astype(dtype),
    )
    return StagedSample(
        window=window,
        images=images_pp,
        eval_events=eval_events,
        gt_flow=gt_flow,
        polarities=ps,
        t_ref=0.0,
        eval_ts=(float(start_time), float(end_time)),
        eval_ts_units=ts_units,
        file_idx=None if file_idx is None else int(file_idx),
        n_event_deficiency=deficiency,
    )
