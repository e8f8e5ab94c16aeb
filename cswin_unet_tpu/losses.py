"""Segmentation losses — pure JAX functions over logits/labels.

Formula-level parity with the reference:
  * soft Dice over ALL classes including background, per-class
    (2·Σpq + ε)/(Σp² + Σq² + ε) with ε=1e-5 averaged over classes
    (reference ``utils.py:9-45``);
  * pixel-mean cross entropy (torch ``CrossEntropyLoss`` default);
  * focal loss with class weights, α·(1-pt)^γ·CE, mean over pixels; the
    weighted CE uses torch's weighted-mean reduction semantics per-element
    (reference ``universal_train.py:141-190`` uses reduction='none' then
    .mean(), i.e. an UNWEIGHTED mean of weighted per-pixel CE — reproduced);
  * KD loss KL(log_softmax(new/T) ‖ softmax(old/T))·T² with batchmean
    reduction (reference ``universal_train.py:618-623``).

All take NHWC logits (B, H, W, C) and integer labels (B, H, W); every loss
reduces to a scalar f32. Computation is f32 regardless of input dtype.

Layout note: every loss transposes to CLASS-MAJOR (B, C, H, W) before any
math, so the tiny class dim (9-14) is not the minor dimension of the
elementwise work, the class reduction is a small-axis fold, and the label
lookup is a one-hot multiply instead of a gather. ``segmentation_loss``
additionally shares ONE softmax between the CE and Dice terms.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def one_hot(labels: jnp.ndarray, num_classes: int) -> jnp.ndarray:
    return jax.nn.one_hot(labels, num_classes, dtype=jnp.float32)


def _class_major(logits: jnp.ndarray) -> jnp.ndarray:
    """(..., C) f32 with the class axis moved to position 1 (B, C, *spatial)."""
    x = logits.astype(jnp.float32)
    return jnp.moveaxis(x, -1, 1)


def _log_softmax_cm(x_cm: jnp.ndarray):
    """Shared-stats softmax over the class axis (axis 1) of a class-major
    tensor: returns (logp, probs), both f32, one exp/sum pass."""
    m = jnp.max(x_cm, axis=1, keepdims=True)
    s = x_cm - m
    e = jnp.exp(s)
    z = jnp.sum(e, axis=1, keepdims=True)
    return s - jnp.log(z), e / z


def _one_hot_cm(labels: jnp.ndarray, num_classes: int) -> jnp.ndarray:
    """(B, *spatial) int -> (B, C, *spatial) f32 one-hot (class-major)."""
    shape = (1, num_classes) + (1,) * (labels.ndim - 1)
    cls = jnp.arange(num_classes, dtype=labels.dtype).reshape(shape)
    return (labels[:, None] == cls).astype(jnp.float32)


def _dice_from_probs_cm(probs_cm, onehot_cm, num_classes, class_weights):
    """Per-class soft dice from class-major probs/one-hot. Sums over batch
    and spatial dims jointly — the reference's _dice_loss sums the whole
    (B, H, W) slab per class (utils.py:22-30)."""
    axes = (0,) + tuple(range(2, probs_cm.ndim))
    smooth = 1e-5
    intersect = jnp.sum(probs_cm * onehot_cm, axis=axes)
    z = jnp.sum(probs_cm * probs_cm, axis=axes)
    y = jnp.sum(onehot_cm, axis=axes)  # target² == target for one-hot
    per_class = 1.0 - (2.0 * intersect + smooth) / (z + y + smooth)
    if class_weights is not None:
        per_class = per_class * class_weights
    return jnp.sum(per_class) / num_classes


def dice_loss(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    num_classes: int,
    class_weights: jnp.ndarray | None = None,
    *,
    apply_softmax: bool = True,
) -> jnp.ndarray:
    """Soft Dice averaged over all classes (background included)."""
    x = _class_major(logits)
    probs = _log_softmax_cm(x)[1] if apply_softmax else x
    return _dice_from_probs_cm(probs, _one_hot_cm(labels, num_classes),
                               num_classes, class_weights)


def cross_entropy_loss(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    class_weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Pixel cross entropy. With class_weights, uses torch's weighted-mean
    reduction: Σ w_y·CE / Σ w_y."""
    num_classes = logits.shape[-1]
    logp, _ = _log_softmax_cm(_class_major(logits))
    onehot = _one_hot_cm(labels, num_classes)
    nll = -jnp.sum(logp * onehot, axis=1)
    if class_weights is None:
        return jnp.mean(nll)
    w = jnp.sum(onehot * class_weights.reshape((1, -1) + (1,) * (nll.ndim - 1)),
                axis=1)
    return jnp.sum(w * nll) / jnp.maximum(jnp.sum(w), 1e-12)


def focal_loss(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    *,
    alpha: float = 1.0,
    gamma: float = 4.0,
    class_weights: jnp.ndarray | None = None,
) -> jnp.ndarray:
    """Focal loss as the reference computes it: per-pixel weighted CE
    (reduction='none'), pt = exp(-ce), mean over pixels."""
    num_classes = logits.shape[-1]
    labels = jnp.clip(labels, 0, num_classes - 1)
    logp, _ = _log_softmax_cm(_class_major(logits))
    onehot = _one_hot_cm(labels, num_classes)
    ce = -jnp.sum(logp * onehot, axis=1)
    if class_weights is not None:
        w = jnp.sum(
            onehot * class_weights.reshape((1, -1) + (1,) * (ce.ndim - 1)),
            axis=1)
        ce = ce * w
    # Defensive numerics (reference universal_train.py:167-179): NaN/Inf in
    # the per-pixel CE fall back to small/large constants, and a non-finite
    # final value falls back to 1e-3, so one bad batch can't kill a run.
    ce = jnp.nan_to_num(ce, nan=1e-6, posinf=10.0, neginf=1e-6)
    pt = jnp.exp(-ce)
    focal = alpha * (1.0 - pt) ** gamma * ce
    result = jnp.mean(focal)
    return jnp.where(jnp.isfinite(result), result, 1e-3)


def kd_loss(
    logits: jnp.ndarray,
    teacher_logits: jnp.ndarray,
    temperature: float = 3.0,
) -> jnp.ndarray:
    """KL(log_softmax(new/T) ‖ softmax(old/T)) · T², batchmean over the
    leading axis (torch kl_div(reduction='batchmean') divides the total KL
    by batch size only — spatial dims are summed, not averaged)."""
    t = temperature
    logp, _ = _log_softmax_cm(_class_major(logits) / t)
    logq, q = _log_softmax_cm(_class_major(teacher_logits) / t)
    kl = jnp.sum(q * (logq - logp))
    return kl / logits.shape[0] * (t * t)


def segmentation_loss(
    logits: jnp.ndarray,
    labels: jnp.ndarray,
    num_classes: int,
    *,
    ce_weight: float = 0.4,
    dice_weight: float = 0.6,
) -> tuple[jnp.ndarray, dict]:
    """The base training loss 0.4·CE + 0.6·Dice (reference trainer.py:55-57),
    computed from ONE shared class-major softmax pass."""
    logp, probs = _log_softmax_cm(_class_major(logits))
    onehot = _one_hot_cm(labels, num_classes)
    l_ce = jnp.mean(-jnp.sum(logp * onehot, axis=1))
    l_dice = _dice_from_probs_cm(probs, onehot, num_classes, None)
    total = ce_weight * l_ce + dice_weight * l_dice
    return total, {"loss": total, "loss_ce": l_ce, "loss_dice": l_dice}
