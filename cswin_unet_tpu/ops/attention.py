"""Cross-shaped-window (CSWin) stripe attention with LePE — XLA composition.

Behavioral spec comes from the reference ``LePEAttention``
(``networks/cswin_unet.py:31-109``):

  * tokens are partitioned into stripe windows of ``h_sp x w_sp``
    (vertical stripes ``(H, split)``, horizontal stripes ``(split, W)``,
    or the full ``(reso, reso)`` window in the last stage);
  * Q, K, V are windowed per head; attention is softmax(Q·Kᵀ·scale)·V
    computed independently per window;
  * LePE (locally-enhanced positional encoding) is a depthwise 3x3 conv
    applied to V *inside each window* (zero padding at window borders —
    this per-window conv is semantically different from a full-image
    depthwise conv and is correctness-critical), added to the attention
    output.

This module is the model's only implementation, an XLA composition. Scores
accumulate in float32 regardless of the activation dtype.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .windows import window_partition, window_merge


def depthwise_conv3x3(x: jnp.ndarray, kernel: jnp.ndarray, bias: jnp.ndarray | None = None) -> jnp.ndarray:
    """Depthwise 3x3 conv, stride 1, zero pad 1, NHWC.

    kernel: (3, 3, 1, C) HWIO with feature_group_count=C.
    """
    C = x.shape[-1]
    y = lax.conv_general_dilated(
        x,
        kernel.astype(x.dtype),
        window_strides=(1, 1),
        padding=((1, 1), (1, 1)),
        dimension_numbers=("NHWC", "HWIO", "NHWC"),
        feature_group_count=C,
    )
    if bias is not None:
        y = y + bias.astype(y.dtype)
    return y


def _heads(x: jnp.ndarray, num_heads: int) -> jnp.ndarray:
    """(N, L, C) -> (N, num_heads, L, C // num_heads)."""
    N, L, C = x.shape
    return x.reshape(N, L, num_heads, C // num_heads).transpose(0, 2, 1, 3)


def cswin_attention_xla(
    q: jnp.ndarray,
    k: jnp.ndarray,
    v: jnp.ndarray,
    lepe_kernel: jnp.ndarray,
    lepe_bias: jnp.ndarray | None,
    *,
    h_sp: int,
    w_sp: int,
    num_heads: int,
    scale: float,
) -> jnp.ndarray:
    """One stripe branch. q, k, v: (B, H, W, C) -> (B, H, W, C)."""
    B, H, W, C = q.shape
    L = h_sp * w_sp
    head_dim = C // num_heads

    qw = _heads(window_partition(q, h_sp, w_sp), num_heads)
    kw = _heads(window_partition(k, h_sp, w_sp), num_heads)
    v_img = window_partition(v, h_sp, w_sp).reshape(-1, h_sp, w_sp, C)
    lepe = depthwise_conv3x3(v_img, lepe_kernel, lepe_bias)
    vw = _heads(v_img.reshape(-1, L, C), num_heads)
    lepe = _heads(lepe.reshape(-1, L, C), num_heads)

    # Scores in f32 for numerical stability.
    attn = jnp.einsum(
        "nhld,nhmd->nhlm", qw * scale, kw, preferred_element_type=jnp.float32
    )
    attn = jax.nn.softmax(attn, axis=-1).astype(q.dtype)
    out = jnp.einsum("nhlm,nhmd->nhld", attn, vw, preferred_element_type=jnp.float32)
    out = out.astype(q.dtype) + lepe

    out = out.transpose(0, 2, 1, 3).reshape(-1, L, C)
    return window_merge(out, h_sp, w_sp, H, W)

