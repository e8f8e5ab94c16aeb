"""Full-model numerical parity against the reference PyTorch CSWinTransformer.

Runs the reference network (imported from /root/reference, CPU, eval mode)
and this framework's CSWinUNet on the SAME weights — exported from torch and
converted through the real ``torch_to_jax`` import path — and asserts the
logits agree. This extends the per-module oracles (test_attention.py,
test_carafe.py) to the whole net: stem, all four stages (both stripe
orientations + last-stage full window), merges, CARAFE decoder, skip
concats, norm_up, CARAFE4+classifier tail (reference
networks/cswin_unet.py:322-554), plus the ``load_from`` checkpoint surgery
(encoder→decoder mirroring, shape-mismatch dropping, envelope unwrapping —
reference vision_transformer.py:45-72).

The reference needs timm only for DropPath/to_2tuple/trunc_normal_; a
minimal stub is injected (DropPath is identity in eval mode, which is the
only mode parity runs in).
"""

from __future__ import annotations

import importlib.util
import os
import sys
import types

import numpy as np
import pytest

REF = "/root/reference/networks/cswin_unet.py"
pytestmark = pytest.mark.skipif(
    not os.path.exists(REF), reason="reference repo not present"
)

# Small geometry covering every code path: two stripe orientations (stages
# 1-2), reso==split full window (stage 3), last-stage full window (stage 4),
# CARAFE x2 chain + CARAFE4 tail, skip concats. embed_dim MUST stay 64: the
# reference hardcodes concat_linear dims 512/256/128 (cswin_unet.py:404-428).
GEOM = dict(
    img_size=64, in_chans=3, num_classes=4, embed_dim=64,
    depth=[1, 1, 2, 1], split_size=[1, 2, 2, 2], num_heads=[2, 4, 8, 16],
)


def _stub_timm():
    import torch
    import torch.nn as nn

    if "timm.models.layers" in sys.modules:
        return
    timm = types.ModuleType("timm")
    models = types.ModuleType("timm.models")
    layers = types.ModuleType("timm.models.layers")

    def to_2tuple(x):
        return tuple(x) if isinstance(x, (tuple, list)) else (x, x)

    def trunc_normal_(tensor, mean=0.0, std=1.0, a=-2.0, b=2.0):
        with torch.no_grad():
            tensor.normal_(mean, std)
            tensor.clamp_(a, b)
        return tensor

    class DropPath(nn.Module):
        # Parity tests run eval-mode only, where timm DropPath is identity.
        def __init__(self, drop_prob=None):
            super().__init__()
            self.drop_prob = drop_prob

        def forward(self, x):
            return x

    layers.to_2tuple = to_2tuple
    layers.trunc_normal_ = trunc_normal_
    layers.DropPath = DropPath
    timm.models = models
    models.layers = layers
    sys.modules["timm"] = timm
    sys.modules["timm.models"] = models
    sys.modules["timm.models.layers"] = layers


@pytest.fixture(scope="module")
def ref_mod():
    _stub_timm()
    spec = importlib.util.spec_from_file_location("ref_cswin_unet", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_model(ref_mod):
    import torch

    torch.manual_seed(0)
    m = ref_mod.CSWinTransformer(drop_path_rate=0.0, **GEOM).eval()
    return m


@pytest.fixture(scope="module")
def our_model():
    import jax.numpy as jnp

    from cswin_unet_tpu.models import CSWinUNet

    return CSWinUNet(
        img_size=GEOM["img_size"], in_chans=3, num_classes=GEOM["num_classes"],
        embed_dim=GEOM["embed_dim"], depth=tuple(GEOM["depth"]),
        split_size=tuple(GEOM["split_size"]), num_heads=tuple(GEOM["num_heads"]),
        drop_path_rate=0.0, dtype=jnp.float32,
    )


def _import_state(our_model, torch_state):
    """torch state_dict -> our params tree via the production import path;
    asserts the conversion covered EVERY parameter (nothing left at init)."""
    import jax

    from cswin_unet_tpu.utils.checkpoint import (
        flatten, merge_matching, torch_to_jax, unflatten,
    )

    template = our_model.init(
        jax.random.PRNGKey(0),
        np.zeros((1, GEOM["img_size"], GEOM["img_size"], 3), np.float32),
    )
    tpl_flat = flatten(jax.device_get(template["params"]))
    incoming = torch_to_jax({k: v.numpy() for k, v in torch_state.items()})
    missing = set(tpl_flat) - set(incoming)
    assert not missing, f"torch_to_jax left params at init: {sorted(missing)[:10]}"
    merged = merge_matching(tpl_flat, incoming, log=lambda *_: None)
    return {"params": unflatten(merged)}


def _forward_both(ref_model, our_model, params, batch=2, seed=0):
    import jax
    import torch

    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 3, GEOM["img_size"], GEOM["img_size"])).astype(
        np.float32
    )
    with torch.no_grad():
        ref_out = ref_model(torch.from_numpy(x)).numpy()  # (B, cls, H, W)
    ours = jax.jit(lambda p, a: our_model.apply(p, a))(
        params, x.transpose(0, 2, 3, 1)
    )
    return ref_out, np.asarray(ours).transpose(0, 3, 1, 2)


def test_full_model_logit_parity(ref_model, our_model):
    """Same random weights through both frameworks: logits agree to f32
    tolerance across the ENTIRE network."""
    ref_out, our_out = _forward_both(
        ref_model, our_model, _import_state(our_model, ref_model.state_dict())
    )
    assert ref_out.shape == our_out.shape
    np.testing.assert_allclose(our_out, ref_out, rtol=1e-4, atol=2e-4)


def test_full_model_logit_parity_224(ref_mod):
    """Production-RESOLUTION parity: img 224 with the tiny config's split
    sizes (1/2/7/7) pins the exact production window geometries — 56²
    sp=1 stripes, 28² sp=2, 14² (7,14) stripes, 7² full windows — none of
    which the 64² GEOM exercises (its stage 3 degenerates to reso==split).
    depth=1 per stage keeps the CPU f32 compile affordable; per-block math
    is depth-independent, and the 21-deep production stack is covered by
    the oracle tests + the real-checkpoint import test."""
    import jax.numpy as jnp
    import torch

    from cswin_unet_tpu.models import CSWinUNet

    geom = dict(
        img_size=224, in_chans=3, num_classes=9, embed_dim=64,
        depth=[1, 1, 1, 1], split_size=[1, 2, 7, 7], num_heads=[2, 4, 8, 16],
    )
    torch.manual_seed(1)
    ref224 = ref_mod.CSWinTransformer(drop_path_rate=0.0, **geom).eval()
    ours224 = CSWinUNet(
        img_size=224, in_chans=3, num_classes=9, embed_dim=64,
        depth=(1, 1, 1, 1), split_size=(1, 2, 7, 7), num_heads=(2, 4, 8, 16),
        drop_path_rate=0.0, dtype=jnp.float32,
    )
    saved_geom = dict(GEOM)
    GEOM.update(geom)
    try:
        ref_out, our_out = _forward_both(
            ref224, ours224, _import_state(ours224, ref224.state_dict()),
            batch=1)
    finally:
        GEOM.clear()
        GEOM.update(saved_geom)
    assert ref_out.shape == our_out.shape == (1, 9, 224, 224)
    np.testing.assert_allclose(our_out, ref_out, rtol=1e-4, atol=5e-4)


def test_load_from_mirroring_parity(ref_model, our_model, tmp_path):
    """Encoder-only pretrain checkpoint (envelope + module. prefixes, like a
    real CSWin-tiny ImageNet ckpt) through our load_from_pretrained vs the
    reference load_from semantics (vision_transformer.py:52-70): unwrap,
    mirror stage*->stage_up*, drop shape mismatches, load non-strict."""
    import torch

    from cswin_unet_tpu.utils.checkpoint import load_from_pretrained

    full_state = ref_model.state_dict()

    # Perturbed encoder-only checkpoint (so a successful load is observable).
    encoder_keys = [
        k for k in full_state
        if k.startswith(("stage1_conv_embed", "stage1.", "stage2.", "stage3.",
                         "stage4.", "merge", "norm."))
    ]
    pretrain = {k: full_state[k] * 0.9 for k in encoder_keys}

    # --- reference side: vision_transformer.py:58-70 semantics ------------
    full_dict = dict(pretrain)
    for k in list(pretrain):
        if "stage" in k and not k.startswith("stage1_conv_embed"):
            full_dict["stage_up" + k[len("stage"):]] = pretrain[k]
    model_dict = ref_model.state_dict()
    for k in list(full_dict):
        if k in model_dict and full_dict[k].shape != model_dict[k].shape:
            del full_dict[k]
    ref_model.load_state_dict(full_dict, strict=False)

    # --- our side: the production import path on the same .pth ------------
    path = str(tmp_path / "pretrain.pth")
    torch.save({"state_dict_ema": {"module." + k: v for k, v in pretrain.items()}}, path)
    params = _import_state(our_model, full_state)  # sync non-mirrored leaves
    params = load_from_pretrained(params, path, log=lambda *_: None)

    ref_out, our_out = _forward_both(ref_model, our_model, params, seed=1)
    np.testing.assert_allclose(our_out, ref_out, rtol=1e-4, atol=2e-4)

    # restore (other tests share the module-scoped ref_model)
    ref_model.load_state_dict(full_state)
