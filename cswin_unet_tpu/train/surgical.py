"""Surgical fine-tuning: per-tensor LR selection from gradient statistics.

Semantics from the reference (``universal_train.py:626-748``):

  * layer set = all params whose name contains neither "bn" nor "norm"
    (:626-632);
  * per-tensor metric over ``gradient_batches`` batches of the task loss:
      - RGN:  ‖g‖ / ‖θ‖            (:673-678)
      - eb-criterion: mean(g² / Var(g, dim=0))   (:669-672)
    averaged over batches;
  * per epoch, RGN weights are normalized by their max; eb weights are
    binarized at threshold 0.95 (:876-891);
  * the optimizer is AdamW(weight_decay=0.01) with per-tensor
    lr = weight·base_lr (absent → 0 = frozen), REBUILT every epoch (fresh
    moments — reference :893), under a cosine schedule over epochs (:894);
  * grad-norm clip 1.0 before the step (:937).

In optax this is a chain: clip → scale_by_adam → add_decayed_weights →
per-leaf weight scale → -base_lr·cosine(epoch). The per-leaf weights are a
pytree argument of the jitted step, so re-weighting each epoch does NOT
recompile.
"""

from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..utils.checkpoint import flatten, unflatten


def surgical_layer_names(params) -> list[str]:
    """Names eligible for surgical tuning (norm/bn excluded)."""
    return [
        name
        for name in flatten(jax.device_get(params))
        if "bn" not in name.lower() and "norm" not in name.lower()
    ]


def make_grad_fn(model, loss_fn: Callable):
    """grad of the criterion w.r.t. params, eval mode (reference :644)."""

    def objective(params, image, label):
        logits = model.apply(params, image, deterministic=True)
        return loss_fn(logits, label)

    return jax.jit(jax.grad(objective))


def get_lr_weights(
    model,
    params,
    batches,
    loss_fn: Callable,
    *,
    method: str = "RGN",
    label_map: Callable | None = None,
    grad_fn=None,
) -> dict[str, float]:
    """Average per-tensor gradient metric over the given batches."""
    if grad_fn is None:
        grad_fn = make_grad_fn(model, loss_fn)
    layer_names = set(surgical_layer_names(params))
    flat_p = flatten(jax.device_get(params))

    metrics: dict[str, list[float]] = {}
    for batch in batches:
        label = batch["label"]
        if label_map is not None:
            label = label_map(label)
        grads = grad_fn(params, batch["image"], label)
        flat_g = flatten(jax.device_get(grads))
        for name, g in flat_g.items():
            if name not in layer_names:
                continue
            g = g.astype(np.float64)
            if method == "eb-criterion":
                if g.ndim == 0:
                    continue
                var = g.var(axis=0, keepdims=True, ddof=1) if g.shape[0] > 1 else np.zeros_like(g)
                val = float(((g * g) / (var + 1e-8)).mean())
            else:  # RGN
                pn = float(np.linalg.norm(flat_p[name].astype(np.float64)))
                val = float(np.linalg.norm(g)) / pn if pn > 1e-8 else 0.0
            metrics.setdefault(name, []).append(val)

    return {k: float(np.mean(v)) for k, v in metrics.items() if v}


def normalize_weights(weights: dict[str, float], method: str) -> dict[str, float]:
    """Per-epoch post-processing (reference :876-891)."""
    if not weights:
        return {}
    if method == "eb-criterion":
        threshold = 0.95
        return {k: (1.0 if v >= threshold else 0.0) for k, v in weights.items()}
    max_w = max(weights.values())
    if max_w <= 0:
        return {k: 0.0 for k in weights}
    return {k: v / max_w for k, v in weights.items()}


def weight_tree(params, weights: dict[str, float]):
    """Flat weight dict -> pytree matching params (absent names -> 0.0)."""
    flat = flatten(jax.device_get(params))
    return unflatten(
        {k: np.asarray(weights.get(k, 0.0), np.float32) for k in flat}
    )


_GROUP_PATTERNS = (
    ("stage1_conv_embed", "stem"),
    ("stage_up1", "decoder1"), ("stage_up2", "decoder2"),
    ("stage_up3", "decoder3"), ("stage_up4", "decoder4"),
    ("stage1", "encoder1"), ("stage2", "encoder2"),
    ("stage3", "encoder3"), ("stage4", "encoder4"),
    ("merge1", "merge1"), ("merge2", "merge2"), ("merge3", "merge3"),
    ("upsample1", "upsample1"), ("upsample2", "upsample2"),
    ("upsample3", "upsample3"), ("upsample4", "upsample4"),
    ("concat_linear2", "concat2"), ("concat_linear3", "concat3"),
    ("concat_linear4", "concat4"),
    ("norm_up", "norm_up"), ("norm", "bottleneck"), ("output", "output"),
)


def parameter_group_of(name: str) -> str:
    """Architectural group of a flat param name (reference finetune.py:77-113:
    stem / encoderN / mergeN / bottleneck / decoderN / upsampleN / concatN /
    norm_up / output)."""
    base = name.split("/")
    # strip the 'params'/'backbone' envelope components
    parts = [p for p in base if p not in ("params", "backbone")]
    head = parts[0] if parts else name
    for prefix, group in _GROUP_PATTERNS:
        if head.startswith(prefix):
            return group
    return "other"


def get_group_lr_weights(model, params, batch, loss_fn, *, grad_fn=None,
                         label_map=None) -> dict[str, float]:
    """Per-GROUP relative gradient norms from one batch, normalized to sum 1
    (reference finetune.py:115-144): group norm = sqrt(Σ‖g_p‖²) over the
    group's tensors."""
    if grad_fn is None:
        grad_fn = make_grad_fn(model, loss_fn)
    label = batch["label"]
    if label_map is not None:
        label = label_map(label)
    grads = grad_fn(params, batch["image"], label)
    flat_g = flatten(jax.device_get(grads))
    sq: dict[str, float] = {}
    for name, g in flat_g.items():
        group = parameter_group_of(name)
        sq[group] = sq.get(group, 0.0) + float((np.asarray(g, np.float64) ** 2).sum())
    norms = {k: float(np.sqrt(v)) for k, v in sq.items()}
    total = sum(norms.values())
    if total <= 0:
        return {k: 0.0 for k in norms}
    return {k: v / total for k, v in norms.items()}


def group_weights_to_param_weights(params, group_weights: dict[str, float]) -> dict[str, float]:
    """Expand group-level weights to flat per-param weights."""
    flat = flatten(jax.device_get(params))
    return {name: group_weights.get(parameter_group_of(name), 0.0) for name in flat}


def cosine_epoch_lr(base_lr: float, max_epochs: int):
    """torch CosineAnnealingLR(T_max=max_epochs), stepped per epoch."""

    def schedule(epoch):
        return base_lr * 0.5 * (1.0 + jnp.cos(jnp.pi * epoch / max_epochs))

    return schedule


class SurgicalOptimizer:
    """AdamW with per-tensor lr weights, epoch-rebuilt moments, cosine LR.

    The jitted step takes (params, opt_state, weights, epoch, batch...) so
    epoch-level reweighting never recompiles.
    """

    def __init__(self, base_lr: float, max_epochs: int, *, weight_decay: float = 0.01,
                 clip_norm: float = 1.0):
        self.base_lr = base_lr
        self.schedule = cosine_epoch_lr(base_lr, max_epochs)
        self._inner = optax.chain(
            optax.clip_by_global_norm(clip_norm),
            optax.scale_by_adam(),
            optax.add_decayed_weights(weight_decay),
        )

    def init(self, params):
        return self._inner.init(params)

    def update(self, grads, opt_state, params, weights, epoch):
        updates, opt_state = self._inner.update(grads, opt_state, params)
        lr = self.schedule(epoch)
        updates = jax.tree.map(lambda u, w: -lr * w * u, updates, weights)
        return updates, opt_state


def log_layer_learning_rates(weights: dict[str, float], base_lr: float, logger, *,
                             stage: int, method: str) -> None:
    """Reference :728-748 table."""
    logger.info("\n" + "=" * 80)
    logger.info(
        f"CONTINUAL LEARNING STAGE {stage} - SURGICAL FINE-TUNING - {method.upper()} METHOD"
    )
    logger.info("=" * 80)
    logger.info(f"{'Layer Name':<50} {'Weight':<12} {'Learning Rate':<15}")
    logger.info("-" * 80)
    items = sorted(weights.items(), key=lambda kv: kv[1] * base_lr, reverse=True)
    active = 0
    for name, w in items:
        lr = w * base_lr
        status = "ACTIVE" if lr > 0 else "FROZEN"
        if lr > 0:
            active += 1
        logger.info(f"{name:<50} {w:<12.6f} {lr:<15.8f} [{status}]")
    logger.info("-" * 80)
    logger.info(
        f"Total layers: {len(items)}, Active layers: {active}, "
        f"Frozen layers: {len(items) - active}"
    )
    logger.info("=" * 80 + "\n")
