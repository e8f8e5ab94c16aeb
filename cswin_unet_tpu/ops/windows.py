"""Cross-shaped window partitioning.

Equivalents of the reference's ``img2windows`` / ``windows2img``
(reference ``networks/cswin_unet.py:184-202``), re-derived for the NHWC
layout the whole model uses. Pure reshapes +
transposes — XLA fuses these into the surrounding ops; no data-dependent
shapes anywhere.

Window enumeration order matches the reference: window index
``b * nH * nW + i * nW + j`` where ``(i, j)`` indexes the ``(H/h_sp, W/w_sp)``
grid, and tokens within a window are row-major ``(h_sp, w_sp)``.
"""

from __future__ import annotations

import jax.numpy as jnp


def window_partition(x: jnp.ndarray, h_sp: int, w_sp: int) -> jnp.ndarray:
    """(B, H, W, C) -> (B * H/h_sp * W/w_sp, h_sp * w_sp, C)."""
    B, H, W, C = x.shape
    if H % h_sp or W % w_sp:
        raise ValueError(f"({H},{W}) not divisible by window ({h_sp},{w_sp})")
    x = x.reshape(B, H // h_sp, h_sp, W // w_sp, w_sp, C)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(B * (H // h_sp) * (W // w_sp), h_sp * w_sp, C)


def window_merge(windows: jnp.ndarray, h_sp: int, w_sp: int, H: int, W: int) -> jnp.ndarray:
    """(B * nH * nW, h_sp * w_sp, C) -> (B, H, W, C). Inverse of window_partition."""
    nH, nW = H // h_sp, W // w_sp
    B = windows.shape[0] // (nH * nW)
    C = windows.shape[-1]
    x = windows.reshape(B, nH, nW, h_sp, w_sp, C)
    x = x.transpose(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C)
