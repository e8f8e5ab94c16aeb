"""CARAFE content-aware upsampling, XLA-native formulation.

Behavioral spec from the reference ``CARAFE``/``CARAFE4``
(``networks/cswin_unet.py:222-319``): a kernel-prediction module (1x1
compress to C/4, then kxk conv to up²·k² maps, pixel-shuffled and softmaxed
over the k² taps) and a reassembly module (each output pixel is a predicted
k²-tap weighted sum of the source pixel's 3x3 neighborhood).

The reference composes this from ``F.pixel_shuffle`` + two ``Tensor.unfold``
calls + ``F.pad``/``unfold`` — hostile to XLA. Here the identical math is
expressed as reshapes + one einsum:

  * pixel_shuffle(enc, up) followed by per-position unfold collapses to a
    plain reshape of the encoder output to (..., k², up²): PyTorch
    pixel_shuffle reads input channel ``c_out * up² + i * up + j`` for
    shuffled offset (i, j), so the encoder's channel axis already carries
    the (k², up²) layout (k²-major).
  * the pad+unfold neighborhood gathering is 9 static slices of a padded
    array (k=3), which XLA fuses; the tap order is (di, dj) row-major,
    matching torch unfold's (dim2 then dim3) order.

The final ``jnp.einsum`` contracts the k² taps.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def extract_patches_3x3(x: jnp.ndarray, kernel_size: int = 3) -> jnp.ndarray:
    """(B, H, W, C) -> (B, H, W, C, k²) zero-padded neighborhoods.

    Tap order is (di, dj) row-major over the kxk neighborhood, equivalent to
    torch ``unfold(2, k).unfold(3, k)`` (reference cswin_unet.py:253-258).
    """
    k = kernel_size
    p = k // 2
    B, H, W, C = x.shape
    xp = jnp.pad(x, ((0, 0), (p, p), (p, p), (0, 0)))
    taps = [
        xp[:, di : di + H, dj : dj + W, :]
        for di in range(k)
        for dj in range(k)
    ]
    return jnp.stack(taps, axis=-1)


def carafe(
    x: jnp.ndarray,
    down_kernel: jnp.ndarray,
    down_bias: jnp.ndarray,
    encoder_kernel: jnp.ndarray,
    encoder_bias: jnp.ndarray,
    out_kernel: jnp.ndarray,
    out_bias: jnp.ndarray,
    *,
    kernel_size: int = 3,
    up_factor: int = 2,
    impl: str = "fast",
) -> jnp.ndarray:
    """CARAFE upsample: (B, H, W, C) -> (B, up·H, up·W, C_out).

    ``impl="fast"`` is the model's path; ``"reference"`` keeps the
    reference's operation order and serves as the test oracle.

    down_kernel:    (1, 1, C, C//4)
    encoder_kernel: (k, k, C//4, up²·k²)  — output channel layout (k², up²), k²-major
    out_kernel:     (1, 1, C, C_out)
    """
    B, H, W, C = x.shape
    k2 = kernel_size * kernel_size
    up2 = up_factor * up_factor

    def conv(inp, kern, bias, pad):
        y = lax.conv_general_dilated(
            inp,
            kern.astype(inp.dtype),
            window_strides=(1, 1),
            padding=((pad, pad), (pad, pad)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        return y + bias.astype(y.dtype)

    # Kernel prediction (reference :240-249). Softmax over the k² taps in f32.
    enc = conv(conv(x, down_kernel, down_bias, 0), encoder_kernel, encoder_bias, kernel_size // 2)
    kern = enc.reshape(B, H, W, k2, up2)
    kern = jax.nn.softmax(kern.astype(jnp.float32), axis=3).astype(x.dtype)

    if impl == "fast":
        # Numerically identical reformulation: the 1x1 out-conv WEIGHT
        # commutes with reassembly + pixel_shuffle (reassembly applies the
        # same per-pixel scalar weights to every channel); running it BEFORE
        # the up²-fold area expansion cuts its FLOPs by up², and when
        # C_out < C it also shrinks the patch tensor and the tap einsum.
        # The BIAS is added after reassembly — hoisting it through the
        # zero-padded border taps would scale it by the (<1) in-bounds tap
        # mass at image borders.
        y = lax.conv_general_dilated(
            x, out_kernel.astype(x.dtype), (1, 1), ((0, 0), (0, 0)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )  # (B, H, W, C_out), no bias
        C_out = y.shape[-1]
        patches = extract_patches_3x3(y, kernel_size)  # (B, H, W, C_out, k²)
        out = jnp.einsum(
            "bhwck,bhwks->bhwcs", patches, kern, preferred_element_type=jnp.float32
        )
        out = (out + out_bias.astype(jnp.float32)[:, None]).astype(x.dtype)
        out = out.reshape(B, H, W, C_out, up_factor, up_factor)
        out = out.transpose(0, 1, 4, 2, 5, 3)
        return out.reshape(B, H * up_factor, W * up_factor, C_out)

    # Reference-shaped composition (test oracle path).
    patches = extract_patches_3x3(x, kernel_size)  # (B, H, W, C, k²)
    out = jnp.einsum(
        "bhwck,bhwks->bhwcs", patches, kern, preferred_element_type=jnp.float32
    ).astype(x.dtype)

    # pixel_shuffle by up: offset s = i·up + j lands at (h·up + i, w·up + j).
    out = out.reshape(B, H, W, C, up_factor, up_factor)
    out = out.transpose(0, 1, 4, 2, 5, 3)  # (B, H, i, W, j, C)
    out = out.reshape(B, H * up_factor, W * up_factor, C)

    return conv(out, out_kernel, out_bias, 0)


def carafe_with_classifier(
    x: jnp.ndarray,
    down_kernel: jnp.ndarray,
    down_bias: jnp.ndarray,
    encoder_kernel: jnp.ndarray,
    encoder_bias: jnp.ndarray,
    out_kernel: jnp.ndarray,
    out_bias: jnp.ndarray,
    cls_kernel: jnp.ndarray,
    *,
    kernel_size: int = 3,
    up_factor: int = 4,
) -> jnp.ndarray:
    """CARAFE upsample followed by a bias-free 1x1 classifier, fused EXACTLY.

    The final model stage is CARAFE4(C→C) then output conv C→num_classes
    (reference cswin_unet.py:536-544). Both 1x1 convs commute below the
    per-channel reassembly+pixel_shuffle, so the whole tail becomes

        logits = reassemble(x · (W_out · W_cls)) + b_out · W_cls

    and the class projection can run before the pixel shuffle, so the
    shuffle transpose and the high-res write happen on num_classes channels
    instead of C, and the 224² classifier conv disappears entirely. Exact
    because the softmaxed taps sum to 1 (the constant b_out·W_cls passes
    through reassembly unchanged) and reassembly weights are per-pixel
    scalars shared by all channels.
    """
    B, H, W, C = x.shape
    k2 = kernel_size * kernel_size
    up2 = up_factor * up_factor

    def conv(inp, kern, bias, pad):
        y = lax.conv_general_dilated(
            inp, kern.astype(inp.dtype), (1, 1), ((pad, pad), (pad, pad)),
            dimension_numbers=("NHWC", "HWIO", "NHWC"),
        )
        return y if bias is None else y + bias.astype(y.dtype)

    enc = conv(conv(x, down_kernel, down_bias, 0), encoder_kernel, encoder_bias,
               kernel_size // 2)
    kern = enc.reshape(B, H, W, k2, up2)
    kern = jax.nn.softmax(kern.astype(jnp.float32), axis=3).astype(x.dtype)

    # Reassemble on C channels, project to NC with one contraction BEFORE
    # pixel-shuffle (the classifier commutes with the shuffle), so the
    # shuffle transpose and the high-res write happen on NC channels.
    w_cls = cls_kernel[0, 0].astype(jnp.float32)        # (C, NC)
    bias_comb = out_bias.astype(jnp.float32) @ w_cls    # (NC,)
    nc = w_cls.shape[-1]

    y = conv(x, out_kernel, None, 0)                    # (B, H, W, C), no bias
    patches = extract_patches_3x3(y, kernel_size)       # (B, H, W, C, k²)
    out64 = jnp.einsum("bhwck,bhwks->bhwcs", patches, kern,
                       preferred_element_type=jnp.float32)
    logits = jnp.einsum("bhwcs,cn->bhwns", out64, w_cls.astype(x.dtype),
                        preferred_element_type=jnp.float32)
    logits = (logits + bias_comb[:, None]).astype(x.dtype)
    logits = logits.reshape(B, H, W, nc, up_factor, up_factor)
    logits = logits.transpose(0, 1, 4, 2, 5, 3)
    return logits.reshape(B, H * up_factor, W * up_factor, nc)

