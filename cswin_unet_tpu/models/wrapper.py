"""Model wrapper: config -> model, single-channel input handling.

Equivalent of the reference ``CSwinUnet`` (``networks/vision_transformer.py:
17-72``): repeats 1-channel CT slices to 3 channels before the backbone and
builds the backbone from the frozen config. Checkpoint surgery (envelope
unwrapping, encoder->decoder key mirroring, shape-mismatch dropping) lives in
``cswin_unet_tpu.utils.checkpoint`` as pure pytree transforms.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import jax.numpy as jnp

from .cswin_unet import CSWinUNet


def _three_channel(x):
    if x.shape[-1] == 1:
        x = jnp.repeat(x, 3, axis=-1)  # reference vision_transformer.py:40-41
    return x


@dataclasses.dataclass(frozen=True)
class CSwinUnet:
    """Thin wrapper: (B, H, W, 1|3) NHWC in, (B, H, W, num_classes) logits
    out. Parameters live under ``{"params": {"backbone": ...}}``."""

    backbone: CSWinUNet

    def init(self, rng, x) -> dict:
        inner = self.backbone.init(rng, _three_channel(x))
        return {"params": {"backbone": inner["params"]}}

    def apply(self, variables, x, *, deterministic: bool = True, rngs=None,
              emit: str = "logits"):
        return self.backbone.apply(
            {"params": variables["params"]["backbone"]}, _three_channel(x),
            deterministic=deterministic, rngs=rngs, emit=emit)


def build_model(
    config,
    img_size: int | None = None,
    num_classes: int = 9,
    *,
    dtype: Any = None,
    use_remat: bool | None = None,
) -> CSwinUnet:
    """Construct the model from a frozen CfgNode (reference vision_transformer.py:23-35)."""
    cs = config.MODEL.CSWIN
    if dtype is None:
        dtype = jnp.dtype(config.DEVICE.COMPUTE_DTYPE)
    if use_remat is None:
        use_remat = bool(config.TRAIN.USE_CHECKPOINT)
    backbone = CSWinUNet(
        img_size=img_size or config.DATA.IMG_SIZE,
        in_chans=cs.IN_CHANS,
        num_classes=num_classes,
        embed_dim=cs.EMBED_DIM,
        depth=tuple(cs.DEPTH),
        split_size=tuple(cs.SPLIT_SIZE),
        num_heads=tuple(cs.NUM_HEADS),
        mlp_ratio=cs.MLP_RATIO,
        qkv_bias=cs.QKV_BIAS,
        qk_scale=cs.QK_SCALE,
        drop_rate=config.MODEL.DROP_RATE,
        drop_path_rate=config.MODEL.DROP_PATH_RATE,
        use_remat=use_remat,
        dtype=dtype,
    )
    return CSwinUnet(backbone=backbone)
