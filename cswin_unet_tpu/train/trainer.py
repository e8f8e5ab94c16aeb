"""Base trainer: SGD+momentum, poly LR decay, 0.4·CE + 0.6·Dice.

Recipe parity with reference ``trainer_synapse`` (``trainer.py:20-95``):
SGD(momentum 0.9, weight_decay 1e-4), per-iteration poly decay
``lr = base·(1 − iter/max_iter)^0.9``, loss 0.4·CE + 0.6·Dice, TB scalars
every iteration and image triptychs every 20, checkpoints every 3 epochs
after the halfway point plus the final epoch, identical log-line format.

Differences from the reference:
  * one jit-compiled train step (forward+backward+update fused into a single
    XLA program, donated buffers — no Python in the hot path);
  * data parallelism via a device mesh: batches arrive sharded on the
    ``data`` axis, parameters are replicated, XLA all-reduces gradients
    across the devices (replaces ``nn.DataParallel``, trainer.py:37-38);
  * host loading is a threaded prefetcher with device double-buffering, so
    H2D copies overlap compute.
"""

from __future__ import annotations

import logging
import os
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

from ..data import DataLoader, RandomGenerator, SynapseDataset, device_prefetch
from ..losses import segmentation_loss
from ..parallel import (
    batch_sharding,
    make_mesh_for_batch,
    multihost_barrier,
    replicate,
    process_shard_info,
    replicated_sharding,
)
from ..utils.checkpoint import restore_train_state, save_checkpoint, save_train_state
from ..utils.logging_utils import MetricBuffer, SummaryWriter, setup_logging


def poly_lr_schedule(base_lr: float, max_iterations: int, power: float = 0.9):
    def schedule(step):
        frac = jnp.clip(1.0 - step / max_iterations, 0.0, 1.0)
        return base_lr * frac**power

    return schedule


def make_optimizer(base_lr: float, max_iterations: int, *, momentum=0.9, weight_decay=1e-4):
    return optax.chain(
        optax.add_decayed_weights(weight_decay),
        optax.sgd(poly_lr_schedule(base_lr, max_iterations), momentum=momentum),
    )


def make_train_step(model, optimizer, num_classes: int, *, loss_fn=None,
                    device_augment: bool = False):
    """Build the jitted (params, opt_state, batch, rng) -> updated step.

    ``loss_fn(logits, labels)`` defaults to 0.4·CE + 0.6·Dice and must
    return (scalar, aux_dict). With ``device_augment`` the rot90/flip/rotate
    augmentation runs inside the jitted step (ops/augment.py) and the host
    loader only decodes+resizes.
    """
    if loss_fn is None:
        def loss_fn(logits, labels):
            return segmentation_loss(logits, labels, num_classes)

    def step(params, opt_state, image, label, rng):
        if device_augment:
            from ..ops.augment import augment_batch

            aug_rng, rng = jax.random.split(rng)
            image, label = augment_batch(image, label, aug_rng)

        def objective(p):
            logits = model.apply(p, image, deterministic=False, rngs={"dropout": rng})
            total, aux = loss_fn(logits, label)
            # Prediction map of sample 1 for TB image triptychs (reference
            # trainer.py:72-79) — free, the logits are already here.
            vis = jnp.argmax(logits[min(1, logits.shape[0] - 1)], axis=-1)
            return total, dict(aux, pred_vis=vis)

        (_, aux), grads = jax.value_and_grad(objective, has_aux=True)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return params, opt_state, aux

    return jax.jit(step, donate_argnums=(0, 1))


def trainer_synapse(args, model, params, snapshot_path: str) -> str:
    """End-to-end base training (reference trainer.py:20-95)."""
    setup_logging(snapshot_path)
    logging.info(str(args))

    base_lr = args.base_lr
    num_classes = args.num_classes
    batch_size = args.batch_size * getattr(args, "n_gpu", 1)

    device_augment = bool(getattr(args, "device_augment", False))
    if device_augment:
        from ..data.transforms import EvalResize

        transform = EvalResize(output_size=[args.img_size, args.img_size])
    else:
        transform = RandomGenerator(output_size=[args.img_size, args.img_size])
    db_train = SynapseDataset(
        base_dir=args.root_path,
        list_dir=args.list_dir,
        split="train",
        transform=transform,
    )
    print(f"The length of train set is: {len(db_train)}")

    # Multi-host pods: each process loads a disjoint shard of every epoch and
    # a per-host slice of the global batch; the global array is assembled in
    # device_prefetch. Single-host: (0, 1) → no sharding.
    shard_index, num_shards = process_shard_info()
    if batch_size % num_shards:
        raise ValueError(f"batch_size {batch_size} not divisible by {num_shards} hosts")
    trainloader = DataLoader(
        db_train,
        batch_size // num_shards,
        shuffle=True,
        seed=args.seed,
        num_workers=getattr(args, "num_workers", 8),
        num_shards=num_shards,
        shard_index=shard_index,
    )

    mesh = make_mesh_for_batch(batch_size)
    bsh = batch_sharding(mesh)
    rsh = replicated_sharding(mesh)
    params = replicate(params, rsh)

    max_epoch = args.max_epochs
    max_iterations = max_epoch * len(trainloader)
    logging.info(
        f"{len(trainloader)} iterations per epoch. {max_iterations} max iterations "
    )

    optimizer = make_optimizer(base_lr, max_iterations)
    opt_state = replicate(optimizer.init(jax.device_get(params)), rsh)
    train_step = make_train_step(
        model, optimizer, num_classes, device_augment=device_augment
    )

    writer = SummaryWriter(os.path.join(snapshot_path, "log"))
    rng = jax.random.PRNGKey(args.seed)
    iter_num = 0
    start_epoch = 0

    # Full resume incl. optimizer state — the reference's AUTO_RESUME is
    # dead config; here --resume <train_state_dir> continues exactly.
    resume = getattr(args, "resume", None)
    if resume:
        params_t, opt_t, iter_num = restore_train_state(
            resume, jax.device_get(params), jax.device_get(opt_state)
        )
        params = replicate(params_t, rsh)
        opt_state = replicate(opt_t, rsh)
        start_epoch = iter_num // max(1, len(trainloader))
        trainloader.set_epoch(start_epoch)
        logging.info(f"resumed from {resume} at iteration {iter_num} (epoch {start_epoch})")

    t_start = time.time()

    metrics = MetricBuffer(flush_every=20)

    def emit_step(it, v):
        writer.add_scalar("info/lr", v["lr"], it)
        writer.add_scalar("info/total_loss", float(v["loss"]), it)
        writer.add_scalar("info/loss_ce", float(v["loss_ce"]), it)
        logging.info(
            "iteration %d : loss : %f, loss_ce: %f"
            % (it, float(v["loss"]), float(v["loss_ce"]))
        )
        if "image" in v:
            # Image triptych every 20 iters (reference trainer.py:72-79).
            img = np.asarray(v["image"])[..., 0]
            rng_img = img.max() - img.min()
            img_norm = (img - img.min()) / (rng_img if rng_img > 0 else 1.0)
            writer.add_image("train/Image", img_norm[None], it)
            writer.add_image(
                "train/Prediction",
                np.asarray(v["pred_vis"])[None].astype(np.float32) * 50, it,
            )
            writer.add_image(
                "train/GroundTruth",
                np.asarray(v["label"])[None].astype(np.float32) * 50, it,
            )

    for epoch_num in range(start_epoch, max_epoch):
        for batch in device_prefetch(iter(trainloader), bsh):
            step_rng = jax.random.fold_in(rng, iter_num)
            params, opt_state, aux = train_step(
                params, opt_state, batch["image"], batch["label"], step_rng
            )
            # Host-side poly LR mirror (no device dispatch in the hot loop).
            lr_ = base_lr * max(0.0, 1.0 - iter_num / max_iterations) ** 0.9
            iter_num += 1

            vals = {"lr": lr_, "loss": aux["loss"], "loss_ce": aux["loss_ce"]}
            if iter_num % 20 == 0:
                s = min(1, batch["image"].shape[0] - 1)
                vals["image"] = batch["image"][s]
                vals["label"] = batch["label"][s]
                vals["pred_vis"] = aux["pred_vis"]
            metrics.append(iter_num, vals, emit_step)
        metrics.flush()

        save_interval = 3
        is_last = epoch_num >= max_epoch - 1
        if (epoch_num > int(max_epoch / 2) and (epoch_num + 1) % save_interval == 0) or is_last:
            multihost_barrier("pre-checkpoint")  # all hosts done with the epoch
            if shard_index == 0:  # params are replicated; one host writes
                save_mode_path = os.path.join(snapshot_path, f"epoch_{epoch_num}.npz")
                save_checkpoint(save_mode_path, params)
                logging.info(f"save model to {save_mode_path}")
                save_train_state(
                    os.path.join(snapshot_path, "train_state"), params, opt_state,
                    iter_num,
                )
            multihost_barrier("post-checkpoint")
        if is_last:
            break

    logging.info(
        f"Training finished in {time.time() - t_start:.1f}s ({iter_num} iterations)"
    )
    writer.close()
    return "Training Finished!"
