"""Small image filters on device (Scharr gradients, blur, divergence).

The reference applies 3x3 kernels with `jax.scipy.signal.convolve(mode='same')`
(true convolution, zero padding; src/utils/img_utils.py:414-432). A
tiny-kernel conv op makes XLA emit a standalone convolution kernel per call,
and the EINCM loss performs ~20 such 3x3 filters per evaluation. Instead
each 3x3 filter is expressed as a shift-and-add *stencil* (9 shifted slices
of the zero-padded image, scaled and summed): elementwise work that XLA
fuses with its neighbors, in exact f32 arithmetic with no matmul precision
to choose.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

# Scharr-optimized Sobel kernels (reference: src/utils/img_utils.py:417-418).
SCHARR_GX = np.array(
    [[3.0, 0.0, -3.0], [10.0, 0.0, -10.0], [3.0, 0.0, -3.0]]
)
SCHARR_GY = np.array(
    [[3.0, 10.0, 3.0], [0.0, 0.0, 0.0], [-3.0, -10.0, -3.0]]
)
# Divergence kernel (reference: src/eincm/regularizers.py:50,
# src/eincm/objectives/event_collapse_objectives.py:14).
DIV_KERNEL = np.array(
    [[1 / 12, 1 / 6, 1 / 12], [1 / 6, 0.0, 1 / 6], [1 / 12, 1 / 6, 1 / 12]]
)
# 3x3 binomial blur (reference: src/utils/img_utils.py:430).
BLUR_KERNEL = np.array(
    [[1 / 16, 1 / 8, 1 / 16], [1 / 8, 1 / 4, 1 / 8], [1 / 16, 1 / 8, 1 / 16]]
)

_EPSN = float(np.finfo(np.float64).eps)


def _conv2d_same(image: jax.Array, kernels: np.ndarray) -> jax.Array:
    """True 2-D convolution of one image with K 3x3 kernels, zero-padded SAME.

    Lowered as a shift-and-add stencil (see module docstring). Convolution
    flips the kernel relative to correlation; the flip happens on the numpy
    constant at trace time.

    Args:
        image: (H, W).
        kernels: (K, 3, 3) numpy constants.

    Returns:
        (K, H, W).
    """
    h, w = image.shape
    p = jnp.pad(image, 1)
    flipped = kernels[:, ::-1, ::-1]
    outs = []
    for k in flipped:
        acc = None
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                c = float(k[dy + 1, dx + 1])
                if c == 0.0:
                    continue
                term = c * jax.lax.dynamic_slice(p, (1 + dy, 1 + dx), (h, w))
                acc = term if acc is None else acc + term
        outs.append(acc if acc is not None else jnp.zeros_like(image))
    return jnp.stack(outs)


def scharr_grads(image: jax.Array) -> jax.Array:
    """Scharr image gradients, stacked (H, W, 2) = (I_x, I_y).

    Reference: src/utils/img_utils.py:414-425
    (`sobel_scharr_optimized_image_grads`).
    """
    g = _conv2d_same(image, np.stack([SCHARR_GX, SCHARR_GY]))
    return jnp.moveaxis(g, 0, -1)


def gaussian_blur_3x3(image: jax.Array) -> jax.Array:
    """3x3 binomial blur. Reference: src/utils/img_utils.py:428-432."""
    return _conv2d_same(image, BLUR_KERNEL[None])[0]


def divergence_filter(field: jax.Array) -> jax.Array:
    """Apply the divergence kernel to a 2-D field (same-padding convolution)."""
    return _conv2d_same(field, DIV_KERNEL[None])[0]


def gradient_magnitude(image: jax.Array) -> jax.Array:
    """Unit-normalized Scharr gradient magnitude.

    Reference: src/utils/img_utils.py:435-449 (`gradient_magnitude`).
    """
    g = scharr_grads(image)
    mag = jnp.sqrt(g[..., 0] ** 2 + g[..., 1] ** 2)
    return (mag - mag.min()) / (mag.max() - mag.min() + _EPSN)
