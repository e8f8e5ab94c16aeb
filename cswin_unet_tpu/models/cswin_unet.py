"""CSWin-UNet as plain JAX functions over a parameter pytree.

A U-shaped encoder-decoder segmentation transformer with cross-shaped-window
attention and LePE, behaviorally equivalent to the reference
``CSWinTransformer`` (``networks/cswin_unet.py:322-554``), written for XLA:

  * NHWC tensors end-to-end; tokens keep their (B, H, W, C) geometry instead
    of flattening to (B, L, C) and re-deriving H=W=√L at every block;
  * skip connections flow functionally through the forward (the reference
    stashes them on ``self.x1/x2/x3`` — not thread-safe, cswin_unet.py:472+);
  * every shape is static; all control flow is Python-level over a static
    config, so the whole forward jit-compiles to one XLA program;
  * mixed precision via ``dtype`` (bf16 activations, f32 params, f32
    softmax/LN statistics);
  * optional per-block rematerialization (``use_remat``, ``jax.checkpoint``)
    replacing torch.utils.checkpoint (reference cswin_unet.py:468-469).

The model object holds only the static configuration. ``init(rng, x)``
returns ``{"params": tree}`` and ``apply(variables, x, ...)`` runs the
forward; the tree's key paths and shapes are the checkpoint format
(``utils/checkpoint.py``), so they never change.

Geometry for tiny/224 (configs/cswin_tiny_224_lite.yaml): embed 64, depths
(1,2,9,1), heads (2,4,8,16), split (1,2,7,7); stage reso 56/28/14/7; stage 4
degenerates to full 7x7 window attention (reference cswin_unet.py:128-131).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

from ..ops.attention import cswin_attention_xla
from ..ops.carafe import carafe, carafe_with_classifier
from .initializers import (init_params, ones, torch_conv_bias, torch_conv_kernel,
                           trunc_normal, zeros)

Dtype = Any
_EPS = 1e-5


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------

def _ln_spec(c):
    return {"scale": ones((c,)), "bias": zeros((c,))}


def _dense_spec(c_in, c_out, bias=True):
    spec = {"kernel": trunc_normal((c_in, c_out))}
    if bias:
        spec["bias"] = zeros((c_out,))
    return spec


def _conv_spec(k, c_in, c_out):
    return {"kernel": torch_conv_kernel((k, k, c_in, c_out)),
            "bias": torch_conv_bias((c_out,), c_in * k * k)}


def _lepe_spec(c):
    return {"get_v_kernel": torch_conv_kernel((3, 3, 1, c)),
            "get_v_bias": torch_conv_bias((c,), 9)}


def _carafe_spec(dim, dim_out, k=3, up=2):
    c_mid, c_enc = dim // 4, up * up * k * k
    return {
        "down_kernel": torch_conv_kernel((1, 1, dim, c_mid)),
        "down_bias": torch_conv_bias((c_mid,), dim),
        "encoder_kernel": torch_conv_kernel((k, k, c_mid, c_enc)),
        "encoder_bias": torch_conv_bias((c_enc,), c_mid * k * k),
        "out_kernel": torch_conv_kernel((1, 1, dim, dim_out)),
        "out_bias": torch_conv_bias((dim_out,), dim),
    }


# ---------------------------------------------------------------------------
# layers (numerics follow flax.linen's Dense / Conv / LayerNorm, the format
# the checkpoints were written in)
# ---------------------------------------------------------------------------

def layer_norm(p, x, dtype):
    """LayerNorm over the last axis; statistics in f32, output in ``dtype``."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, -1, keepdims=True)
    var = jnp.maximum(jnp.mean(xf * xf, -1, keepdims=True) - mean * mean, 0.0)
    mul = lax.rsqrt(var + _EPS) * p["scale"].astype(jnp.float32)
    return ((xf - mean) * mul + p["bias"].astype(jnp.float32)).astype(dtype)


def dense(p, x, dtype):
    y = jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
    if "bias" in p:
        y = y + p["bias"].astype(dtype)
    return y


def conv(p, x, dtype, *, stride, pad):
    y = lax.conv_general_dilated(
        x.astype(dtype), p["kernel"].astype(dtype), (stride, stride),
        ((pad, pad), (pad, pad)), dimension_numbers=("NHWC", "HWIO", "NHWC"))
    return y + p["bias"].astype(dtype)


def dropout(x, rate, rng, broadcast_dims=()):
    """Inverted dropout; ``broadcast_dims`` share one draw (drop-path uses
    (1, 2, 3): one keep/drop per sample, scaled by 1/(1-p) — timm DropPath)."""
    if rate == 0.0 or rng is None:
        return x
    if rate >= 1.0:
        return jnp.zeros_like(x)
    keep = 1.0 - rate
    shape = tuple(1 if i in broadcast_dims else n for i, n in enumerate(x.shape))
    mask = jnp.broadcast_to(jax.random.bernoulli(rng, keep, shape), x.shape)
    return lax.select(mask, x / keep, jnp.zeros_like(x))


def cswin_block(p, x, rng, *, num_heads, split_size, last, qk_scale, drop,
                drop_path, dtype):
    """LN -> joint qkv -> two half-channel stripe branches (or one
    full-window branch in the last stage) -> proj -> residual; LN -> MLP ->
    residual (reference :112-181). ``rng`` is None when deterministic."""
    B, H, W, C = x.shape
    keys = [None] * 4 if rng is None else list(jax.random.split(rng, 4))

    qkv = dense(p["qkv"], layer_norm(p["norm1"], x, dtype), dtype)
    qkv = qkv.reshape(B, H, W, 3, C)
    q, k, v = qkv[..., 0, :], qkv[..., 1, :], qkv[..., 2, :]

    def branch(name, sl, heads, h_sp, w_sp):
        lepe = p[name]
        head_dim = (sl.stop - sl.start) // heads
        scale = qk_scale if qk_scale is not None else head_dim ** -0.5
        return cswin_attention_xla(
            q[..., sl], k[..., sl], v[..., sl],
            lepe["get_v_kernel"], lepe["get_v_bias"],
            h_sp=h_sp, w_sp=w_sp, num_heads=heads, scale=scale)

    if last:
        att = branch("attns_0", slice(0, C), num_heads, H, W)
    else:
        half = C // 2
        # Branch 0: vertical stripes (h_sp=H, w_sp=split); branch 1:
        # horizontal stripes (h_sp=split, w_sp=W). Reference :43-51.
        att = jnp.concatenate([
            branch("attns_0", slice(0, half), num_heads // 2, H, split_size),
            branch("attns_1", slice(half, C), num_heads // 2, split_size, W),
        ], axis=-1)
    att = dense(p["proj"], att, dtype)
    x = x + dropout(att, drop_path, keys[0], (1, 2, 3))

    y = dense(p["mlp"]["fc1"], layer_norm(p["norm2"], x, dtype), dtype)
    y = dropout(jax.nn.gelu(y, approximate=False), drop, keys[1])
    y = dropout(dense(p["mlp"]["fc2"], y, dtype), drop, keys[2])
    return x + dropout(y, drop_path, keys[3], (1, 2, 3))


# ---------------------------------------------------------------------------
# model
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CSWinUNet:
    """Full U-Net. Input (B, H, W, in_chans) NHWC; output logits
    (B, H, W, num_classes). Reference CSWinTransformer :322-554."""

    img_size: int = 224
    in_chans: int = 3
    num_classes: int = 9
    embed_dim: int = 64
    depth: Sequence[int] = (1, 2, 9, 1)
    split_size: Sequence[int] = (1, 2, 7, 7)
    num_heads: Sequence[int] = (2, 4, 8, 16)
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    qk_scale: Optional[float] = None
    drop_rate: float = 0.0
    drop_path_rate: float = 0.0
    use_remat: bool = False
    dtype: Dtype = jnp.float32

    # -- static geometry ----------------------------------------------------
    def _dims(self):
        ed = self.embed_dim
        return [ed, ed * 2, ed * 4, ed * 8]

    def _resos(self):
        return [self.img_size // (4 * 2**i) for i in range(4)]

    def _is_last(self, s):
        """Single full-window branch: the last stage, or a stage whose
        resolution equals its split size (reference :128-131)."""
        reso = self._resos()[s]
        return s == 3 or reso == self.split_size[s]

    def _block_spec(self, s):
        C = self._dims()[s]
        hidden = int(C * self.mlp_ratio)
        last = self._is_last(s)
        spec = {"norm1": _ln_spec(C),
                "qkv": _dense_spec(C, 3 * C, self.qkv_bias),
                "attns_0": _lepe_spec(C if last else C // 2)}
        if not last:
            spec["attns_1"] = _lepe_spec(C // 2)
        spec.update({
            "proj": _dense_spec(C, C),
            "norm2": _ln_spec(C),
            "mlp": {"fc1": _dense_spec(C, hidden), "fc2": _dense_spec(hidden, C)},
        })
        return spec

    def param_spec(self) -> dict:
        """Tree of ``initializers.Param`` leaves: the checkpoint layout."""
        ed, dims, depth = self.embed_dim, self._dims(), list(self.depth)
        spec = {
            "stage1_conv_embed_conv": _conv_spec(7, self.in_chans, ed),
            "stage1_conv_embed_norm": _ln_spec(ed),
        }
        for s in range(4):
            for i in range(depth[s]):
                spec[f"stage{s + 1}_{i}"] = self._block_spec(s)
            if s < 3:
                spec[f"merge{s + 1}"] = {"conv": _conv_spec(3, dims[s], dims[s + 1]),
                                         "norm": _ln_spec(dims[s + 1])}
        spec["norm"] = _ln_spec(dims[3])
        for s in range(3, -1, -1):
            for i in range(depth[s]):
                spec[f"stage_up{s + 1}_{i}"] = self._block_spec(s)
            if s > 0:
                spec[f"upsample{s + 1}"] = _carafe_spec(dims[s], dims[s - 1])
                spec[f"concat_linear{s + 1}"] = _dense_spec(2 * dims[s - 1], dims[s - 1])
        spec["norm_up"] = _ln_spec(ed)
        spec["upsample1"] = _carafe_spec(ed, ed, up=4)
        spec["output"] = {"kernel": torch_conv_kernel((1, 1, ed, self.num_classes))}
        return spec

    def init(self, rng, x) -> dict:
        """Fresh parameters ``{"params": tree}``; ``x`` is an example input
        (only its channel count is checked)."""
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected NHWC input with {self.in_chans} channels, "
                             f"got {x.shape}")
        return {"params": init_params(self.param_spec(), rng)}

    # -- forward ------------------------------------------------------------
    def _stage(self, params, x, s, prefix, dpr, off, next_rng):
        fn = functools.partial(
            cswin_block, num_heads=self.num_heads[s],
            split_size=self.split_size[s], last=self._is_last(s),
            qk_scale=self.qk_scale, drop=self.drop_rate, dtype=self.dtype)
        for i in range(self.depth[s]):
            blk = functools.partial(fn, drop_path=float(dpr[off + i]))
            if self.use_remat:
                blk = jax.checkpoint(blk)
            x = blk(params[f"{prefix}{s + 1}_{i}"], x, next_rng())
        return x

    def apply(self, variables, x, *, deterministic: bool = True, rngs=None,
              emit: str = "logits"):
        """Forward. ``rngs={"dropout": key}`` is required when
        ``deterministic`` is False; ``emit="labels"`` returns the per-pixel
        argmax (int32) instead of f32 logits."""
        if x.shape[-1] != self.in_chans:
            raise ValueError(f"expected NHWC input with {self.in_chans} channels, "
                             f"got {x.shape}")
        if emit not in ("logits", "labels"):
            raise ValueError(f"emit must be 'logits' or 'labels', got {emit!r}")
        p = variables["params"]
        dt = self.dtype
        dims, depth = self._dims(), list(self.depth)
        # Stochastic-depth schedule shared by encoder and decoder (ref :348).
        dpr = np.linspace(0, self.drop_path_rate, sum(depth))
        offs = np.cumsum([0] + depth)

        counter = iter(range(1 << 30))
        base = None if deterministic else rngs["dropout"]

        def next_rng():
            return None if base is None else jax.random.fold_in(base, next(counter))

        # --- Encoder -------------------------------------------------------
        # Stem: 7x7 stride-4 conv + LN (reference :338-342).
        x = conv(p["stage1_conv_embed_conv"], x, dt, stride=4, pad=2)
        x = layer_norm(p["stage1_conv_embed_norm"], x, dt)
        x = dropout(x, self.drop_rate, next_rng())

        skips = []
        for s in range(4):
            x = self._stage(p, x, s, "stage", dpr, int(offs[s]), next_rng)
            if s < 3:
                # Stage-transition downsample: 3x3 stride-2 conv + LN (ref :205-220).
                skips.append(x)
                m = p[f"merge{s + 1}"]
                x = layer_norm(m["norm"], conv(m["conv"], x, dt, stride=2, pad=1), dt)
        x = layer_norm(p["norm"], x, dt)

        # --- Decoder -------------------------------------------------------
        for s in range(3, -1, -1):
            x = self._stage(p, x, s, "stage_up", dpr, int(offs[s]), next_rng)
            if s > 0:
                u = p[f"upsample{s + 1}"]
                x = carafe(x, u["down_kernel"], u["down_bias"], u["encoder_kernel"],
                           u["encoder_bias"], u["out_kernel"], u["out_bias"],
                           kernel_size=3, up_factor=2)
                # Skip-concat: [skip, upsampled] then linear 2C->C (ref :509-510).
                x = jnp.concatenate([skips[s - 1], x], axis=-1)
                x = dense(p[f"concat_linear{s + 1}"], x, dt)
        x = layer_norm(p["norm_up"], x, dt)

        # Final x4 CARAFE + 1x1 classifier (reference :536-544), fused: both
        # 1x1 convs commute below the CARAFE reassembly, so the tap einsum and
        # the high-res write happen on num_classes channels instead of
        # embed_dim (exact — see ops.carafe.carafe_with_classifier).
        u = p["upsample1"]
        x = carafe_with_classifier(
            x.astype(dt), u["down_kernel"], u["down_bias"], u["encoder_kernel"],
            u["encoder_bias"], u["out_kernel"], u["out_bias"],
            p["output"]["kernel"], kernel_size=3, up_factor=4)
        if emit == "labels":
            return jnp.argmax(x.astype(jnp.float32), axis=-1).astype(jnp.int32)
        return x.astype(jnp.float32)
