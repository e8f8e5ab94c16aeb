"""CARAFE: the XLA reshape+einsum formulation must equal the reference's
pixel_shuffle + unfold composition (networks/cswin_unet.py:232-269).

The oracle below re-creates that composition with public torch ops
(F.pixel_shuffle / Tensor.unfold) on NCHW tensors, which is the canonical
definition of the op — validating that the XLA formulation is the same
function of the same weights.
"""

import numpy as np
import jax.numpy as jnp
import torch
import torch.nn.functional as F

from cswin_unet_tpu.ops.carafe import carafe, extract_patches_3x3


def torch_carafe_oracle(x_nchw, wd, bd, we, be, wo, bo, k, up):
    """Reference CARAFE semantics using torch public ops (NCHW weights)."""
    x = torch.from_numpy(x_nchw)
    B, C, H, W = x.shape
    kt = F.conv2d(x, torch.from_numpy(wd), torch.from_numpy(bd))
    kt = F.conv2d(kt, torch.from_numpy(we), torch.from_numpy(be), padding=k // 2)
    kt = F.pixel_shuffle(kt, up)
    kt = F.softmax(kt, dim=1)
    kt = kt.unfold(2, up, step=up).unfold(3, up, step=up)
    kt = kt.reshape(B, k * k, H, W, up * up).permute(0, 2, 3, 1, 4)

    w = F.pad(x, pad=(k // 2,) * 4)
    w = w.unfold(2, k, step=1).unfold(3, k, step=1)
    w = w.reshape(B, C, H, W, -1).permute(0, 2, 3, 1, 4)

    out = torch.matmul(w, kt).reshape(B, H, W, -1).permute(0, 3, 1, 2)
    out = F.pixel_shuffle(out, up)
    out = F.conv2d(out, torch.from_numpy(wo), torch.from_numpy(bo))
    return out.numpy()


def test_patches_match_torch_unfold(rng):
    x = rng.standard_normal((2, 5, 6, 4)).astype(np.float32)
    got = np.asarray(extract_patches_3x3(jnp.asarray(x)))  # (B,H,W,C,9)
    t = torch.from_numpy(x.transpose(0, 3, 1, 2))
    t = F.pad(t, (1, 1, 1, 1))
    t = t.unfold(2, 3, step=1).unfold(3, 3, step=1)  # (B,C,H,W,3,3)
    want = t.reshape(2, 4, 5, 6, 9).permute(0, 2, 3, 1, 4).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=0)


def _run_case(rng, B, H, W, C, C_out, up):
    k = 3
    c_mid = C // 4
    c_enc = up * up * k * k
    # torch OIHW weights
    wd = rng.standard_normal((c_mid, C, 1, 1)).astype(np.float32) * 0.2
    bd = rng.standard_normal(c_mid).astype(np.float32) * 0.1
    we = rng.standard_normal((c_enc, c_mid, k, k)).astype(np.float32) * 0.2
    be = rng.standard_normal(c_enc).astype(np.float32) * 0.1
    wo = rng.standard_normal((C_out, C, 1, 1)).astype(np.float32) * 0.2
    bo = rng.standard_normal(C_out).astype(np.float32) * 0.1
    x = rng.standard_normal((B, C, H, W)).astype(np.float32)

    want = torch_carafe_oracle(x, wd, bd, we, be, wo, bo, k, up)

    # jax HWIO weights
    got = carafe(
        jnp.asarray(x.transpose(0, 2, 3, 1)),
        jnp.asarray(wd.transpose(2, 3, 1, 0)), jnp.asarray(bd),
        jnp.asarray(we.transpose(2, 3, 1, 0)), jnp.asarray(be),
        jnp.asarray(wo.transpose(2, 3, 1, 0)), jnp.asarray(bo),
        kernel_size=k, up_factor=up,
    )
    got = np.asarray(got).transpose(0, 3, 1, 2)
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)


def test_carafe_up2_matches_reference_composition(rng):
    _run_case(rng, B=2, H=7, W=7, C=8, C_out=4, up=2)


def test_carafe_up4_matches_reference_composition(rng):
    _run_case(rng, B=1, H=6, W=6, C=16, C_out=16, up=4)


def test_fast_impl_matches_reference_impl(rng):
    """The conv-hoisted, patch-free 'fast' path must be numerically
    equivalent to the reference-shaped composition."""
    import jax.numpy as jnp
    from cswin_unet_tpu.ops.carafe import carafe as carafe_fn

    for B, H, W, C, C_out, up in [(2, 7, 7, 8, 4, 2), (1, 6, 6, 16, 16, 4)]:
        k = 3
        c_mid, c_enc = C // 4, up * up * k * k
        args = dict(
            down_kernel=jnp.asarray(rng.standard_normal((1, 1, C, c_mid)).astype(np.float32) * 0.2),
            down_bias=jnp.asarray(rng.standard_normal(c_mid).astype(np.float32) * 0.1),
            encoder_kernel=jnp.asarray(rng.standard_normal((k, k, c_mid, c_enc)).astype(np.float32) * 0.2),
            encoder_bias=jnp.asarray(rng.standard_normal(c_enc).astype(np.float32) * 0.1),
            out_kernel=jnp.asarray(rng.standard_normal((1, 1, C, C_out)).astype(np.float32) * 0.2),
            out_bias=jnp.asarray(rng.standard_normal(C_out).astype(np.float32) * 0.1),
        )
        x = jnp.asarray(rng.standard_normal((B, H, W, C)).astype(np.float32))
        ref = carafe_fn(x, **args, kernel_size=k, up_factor=up, impl="reference")
        fast = carafe_fn(x, **args, kernel_size=k, up_factor=up, impl="fast")
        np.testing.assert_allclose(np.asarray(fast), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_carafe_with_classifier_matches_composition(rng):
    """Fused CARAFE4+classifier tail == CARAFE then 1x1 classifier, exactly."""
    import jax.numpy as jnp
    from jax import lax
    from cswin_unet_tpu.ops.carafe import carafe as carafe_fn
    from cswin_unet_tpu.ops.carafe import carafe_with_classifier

    B, H, W, C, NC, up, k = 2, 6, 6, 16, 5, 4, 3
    c_mid, c_enc = C // 4, up * up * k * k
    a = dict(
        down_kernel=jnp.asarray(rng.standard_normal((1, 1, C, c_mid)).astype(np.float32) * 0.2),
        down_bias=jnp.asarray(rng.standard_normal(c_mid).astype(np.float32) * 0.1),
        encoder_kernel=jnp.asarray(rng.standard_normal((k, k, c_mid, c_enc)).astype(np.float32) * 0.2),
        encoder_bias=jnp.asarray(rng.standard_normal(c_enc).astype(np.float32) * 0.1),
        out_kernel=jnp.asarray(rng.standard_normal((1, 1, C, C)).astype(np.float32) * 0.2),
        out_bias=jnp.asarray(rng.standard_normal(C).astype(np.float32) * 0.1),
    )
    cls_kernel = jnp.asarray(rng.standard_normal((1, 1, C, NC)).astype(np.float32) * 0.2)
    x = jnp.asarray(rng.standard_normal((B, H, W, C)).astype(np.float32))

    ref = carafe_fn(x, **a, kernel_size=k, up_factor=up, impl="reference")
    ref = lax.conv_general_dilated(ref, cls_kernel, (1, 1), ((0, 0), (0, 0)),
                                   dimension_numbers=("NHWC", "HWIO", "NHWC"))
    got = carafe_with_classifier(x, **a, cls_kernel=cls_kernel,
                                 kernel_size=k, up_factor=up)
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=3e-5, atol=3e-5)
