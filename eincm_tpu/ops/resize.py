"""Theta (velocity field) rescaling between pyramid levels and sensor size.

Reference: src/utils/theta_utils.py:10-37 (`scale_theta_to_sensor_size`),
src/eincm/solver.py:350-377 (`_upscale_theta`, `_downscale_theta`).

All resizes go through `jax.image.scale_and_translate`, a dense separable
resampling that XLA lowers to two small matmuls. The 'repeat' upscale (the
reference's default pyramid init) is a reshape-broadcast.
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.image as jim
import jax.numpy as jnp

_INTERP_METHODS = (
    "linear",
    "bilinear",
    "trilinear",
    "cubic",
    "bicubic",
    "tricubic",
    "lanczos3",
    "lanczos5",
)


def _scale_hw(theta: jax.Array, out_h: int, out_w: int, method: str) -> jax.Array:
    h, w = theta.shape[0], theta.shape[1]
    dtype = jnp.result_type(theta.dtype, jnp.float32)
    scale = jnp.array([out_h / h, out_w / w, 1.0], dtype)
    translation = jnp.zeros((3,), dtype)
    return jim.scale_and_translate(
        image=theta.astype(dtype),
        shape=(out_h, out_w, theta.shape[2]),
        spatial_dims=(0, 1, 2),
        scale=scale,
        translation=translation,
        method=method,
    )


@partial(jax.jit, static_argnames=("sensor_size", "method"))
def scale_theta_to_sensor_size(
    theta: jax.Array,
    sensor_size: Tuple[int, int],
    method: str = "bilinear",
) -> jax.Array:
    """Upscale a coarse theta (h, w, 2) to the full sensor (H, W, 2)."""
    return _scale_hw(theta, sensor_size[0], sensor_size[1], method)


@partial(jax.jit, static_argnames=("base", "method"))
def upscale_theta(theta: jax.Array, base: int = 2, method: str = "repeat") -> jax.Array:
    """Upscale theta by `base` along both spatial axes.

    'repeat' duplicates pixels (reference default, src/eincm/solver.py:351-352);
    interpolating methods use `scale_and_translate`.
    """
    if method == "repeat":
        return jnp.repeat(jnp.repeat(theta, base, axis=0), base, axis=1)
    if method in _INTERP_METHODS:
        return _scale_hw(theta, theta.shape[0] * base, theta.shape[1] * base, method)
    raise NotImplementedError(f"upscale method {method!r}")


@partial(jax.jit, static_argnames=("base", "method"))
def downscale_theta(
    theta: jax.Array, base: int = 2, method: str = "bilinear"
) -> jax.Array:
    """Downscale theta by `base` along both spatial axes (interpolating)."""
    if method in _INTERP_METHODS:
        return _scale_hw(theta, theta.shape[0] // base, theta.shape[1] // base, method)
    raise NotImplementedError(f"downscale method {method!r}")
