"""Volume inference: batched slice-wise segmentation + per-case metrics.

Behavioral parity with reference ``test_single_volume`` (``utils.py:61-102``)
and ``inference`` (``test.py:103-165``): slices are bicubic-zoomed to the
model's patch size, segmented, argmaxed, nearest-zoomed back to native
resolution; per-class Dice/HD95 over classes 1..C-1; identical log lines
('idx %d case %s mean_dice %f mean_hd95 %f', per-class means, overall).

The main difference is the throughput lever: the reference runs one slice per
forward at batch size 1 (``utils.py:70-74``), paying a host<->device round
trip and an under-utilized device per slice. Here all slices of a volume are
batched into fixed-size chunks processed by one jitted forward (static
shapes -> one compile), with host-side resizing parallelized across a thread
pool. Class-channel gathers for continual models happen on device.
"""

from __future__ import annotations

import logging
import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
from scipy.ndimage import zoom as nd_zoom

from ..metrics import volume_metrics
from ..utils.nifti import write_nifti


class VolumeInferencer:
    """Jit-compiled batched slice segmentation.

    ``class_indices`` (optional) gathers a subset of output channels before
    argmax — the continual-learning test wrapper (universal_test.py:18-54).

    ``data_parallel`` (default: on when >1 device is visible) shards each
    slice chunk over the device mesh's ``data`` axis with replicated
    params — slices are independent, so eval/serving scales linearly over
    chips with zero collectives (SURVEY §2.7's DataParallel duty, applied
    to inference)."""

    def __init__(self, model, params, *, patch_size=(224, 224), batch_slices=32,
                 class_indices=None, data_parallel=None):
        self.patch = tuple(patch_size)
        # Local (addressable) devices only: in a multi-process run
        # jax.devices() includes non-addressable devices, and device_put to
        # a mesh over those would fail — auto-enable is per-host.
        n_dev = len(jax.local_devices())
        if data_parallel is None:
            data_parallel = n_dev > 1 and jax.process_count() == 1
        n_mesh = 1
        if data_parallel and n_dev > 1:
            from ..parallel import (batch_sharding, make_mesh, replicate,
                                    replicated_sharding)

            n_mesh = min(n_dev, batch_slices)
            while batch_slices % n_mesh:
                n_mesh -= 1
            mesh = make_mesh(n_mesh)
            self._in_sharding = batch_sharding(mesh)
            params = replicate(params, replicated_sharding(mesh))
        else:
            self._in_sharding = None
            params = jax.device_put(params)  # once, not with every chunk
        self.batch = batch_slices
        # Tail buckets: smaller compiled shapes for the last chunk so a
        # 33-slice volume at batch 32 runs 32+8 slices, not 32+32 (the
        # small-volume serving case). Halving keeps mesh divisibility.
        self._buckets = [batch_slices]
        while (self._buckets[0] % 2 == 0 and self._buckets[0] // 2 >= 8
               and self._buckets[0] // 2 % n_mesh == 0):
            self._buckets.insert(0, self._buckets[0] // 2)
        self.params = params
        idx = None if class_indices is None else jnp.asarray(class_indices)

        def forward(params, images):
            if idx is None:
                # full-channel argmax inside the model (emit="labels"), no
                # softmax pass: softmax is monotone so labels are identical
                # (utils.py:74)
                return model.apply(params, images, deterministic=True,
                                   emit="labels")
            logits = model.apply(params, images, deterministic=True)
            logits = logits[..., idx]
            probs = jax.nn.softmax(logits, axis=-1)
            return jnp.argmax(probs, axis=-1).astype(jnp.int32)

        self._fn = jax.jit(forward)

    def predict_slices(self, slices: np.ndarray) -> np.ndarray:
        """(N, H, W) float32 at patch size -> (N, H, W) int32 labels.

        All chunks are dispatched before any result is pulled: jax's async
        dispatch queues the H2D copies and forwards back-to-back, so
        transfer overlaps compute instead of serializing with it (the
        per-chunk D2H pull was the pipeline bubble)."""
        n = slices.shape[0]
        out = np.empty((n,) + self.patch, dtype=np.int32)
        x = slices[..., None]  # NHWC, C=1
        pending = []

        def drain(item):
            start, real, pred = item
            out[start : start + real] = np.asarray(pred)[:real]

        start = 0
        while start < n:
            real = min(self.batch, n - start)
            # tail chunks run at the smallest compiled bucket that fits
            size = next(b for b in self._buckets if b >= real)
            chunk = x[start : start + real]
            if real < size:  # pad to the compiled shape
                pad = np.repeat(chunk[-1:], size - real, axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            dev = jnp.asarray(chunk)
            if self._in_sharding is not None:
                dev = jax.device_put(dev, self._in_sharding)
            pending.append((start, real, self._fn(self.params, dev)))
            # Keep a sliding window of in-flight chunks: enough overlap to
            # hide transfers, bounded device memory on deep volumes.
            if len(pending) > 6:
                drain(pending.pop(0))
            start += real
        for item in pending:
            drain(item)
        return out

    def predict_slices_device(self, slices: np.ndarray) -> "jnp.ndarray":
        """(N, H, W) float32 -> (N, H, W) int32 predictions kept ON DEVICE
        (for the device-metrics path: no D2H pull of the volume)."""
        n = slices.shape[0]
        x = slices[..., None]
        parts = []
        start = 0
        while start < n:
            real = min(self.batch, n - start)
            size = next(b for b in self._buckets if b >= real)
            chunk = x[start : start + real]
            if real < size:
                pad = np.repeat(chunk[-1:], size - real, axis=0)
                chunk = np.concatenate([chunk, pad], axis=0)
            dev = jnp.asarray(chunk)
            if self._in_sharding is not None:
                dev = jax.device_put(dev, self._in_sharding)
            parts.append(self._fn(self.params, dev)[:real])
            start += real
        return jnp.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]


def test_single_volume(
    image: np.ndarray,
    label: np.ndarray,
    inferencer: VolumeInferencer,
    classes: int,
    patch_size=(224, 224),
    test_save_path: str | None = None,
    case: str | None = None,
    z_spacing: int = 1,
    device_metrics: bool = False,
):
    """Segment one volume and compute per-class (dice, hd95).

    image/label: (D, H, W) numpy (or (H, W) single slice).

    ``device_metrics`` keeps the whole tail on device: predictions never
    leave HBM — the inverse zoom is the scipy-parity nearest gather
    (ops/edt.zoom_nearest) and (dice, hd95) come from the device EDT
    (ops/edt.volume_metrics_device); only the (C-1, 2) metric array is
    pulled. Volumes are depth-padded to buckets of 16 so recompiles are
    per-bucket, not per-case (all-background padded slices are exact:
    they add no class voxels and no boundary). Falls back to the host
    path for 2D inputs (2D boundary semantics) and when saving NIfTI.
    """
    image = np.asarray(image)
    label = np.asarray(label)
    single = image.ndim == 2
    if single:
        image = image[None]

    x, y = image.shape[1], image.shape[2]
    ph, pw = patch_size
    needs_zoom = (x, y) != (ph, pw)

    if device_metrics and not single and test_save_path is None:
        from ..ops import edt as edt_ops

        if needs_zoom:
            with ThreadPoolExecutor(8) as pool:
                slices = np.stack(
                    list(pool.map(
                        lambda s: nd_zoom(s, (ph / x, pw / y), order=3), image
                    ))
                ).astype(np.float32)
        else:
            slices = image.astype(np.float32)
        preds_dev = inferencer.predict_slices_device(slices)
        if needs_zoom:
            preds_dev = edt_ops.zoom_nearest(preds_dev, (x, y))
        d = preds_dev.shape[0]
        d_pad = (-d) % 16
        if d_pad:
            z = jnp.zeros((d_pad,) + preds_dev.shape[1:], preds_dev.dtype)
            preds_dev = jnp.concatenate([preds_dev, z], axis=0)
            lab = np.concatenate(
                [label, np.zeros((d_pad,) + label.shape[1:], label.dtype)], 0)
        else:
            lab = label
        metrics = np.asarray(edt_ops.volume_metrics_device(
            preds_dev, jnp.asarray(lab.astype(np.int32)), classes))
        return [tuple(row) for row in metrics]

    with ThreadPoolExecutor(8) as pool:
        if needs_zoom:
            slices = np.stack(
                list(
                    pool.map(
                        lambda s: nd_zoom(s, (ph / x, pw / y), order=3), image
                    )
                )
            ).astype(np.float32)
        else:
            slices = image.astype(np.float32)

        preds = inferencer.predict_slices(slices)

        if needs_zoom:
            prediction = np.stack(
                list(
                    pool.map(
                        lambda s: nd_zoom(s, (x / ph, y / pw), order=0), preds
                    )
                )
            )
        else:
            prediction = preds
    prediction = prediction.astype(label.dtype, copy=False)
    if single:
        prediction = prediction[0]

    metric_list = volume_metrics(prediction, label, classes)

    if test_save_path is not None and case is not None:
        os.makedirs(test_save_path, exist_ok=True)
        spacing = (1, 1, z_spacing)
        write_nifti(os.path.join(test_save_path, f"{case}_pred.nii.gz"),
                    prediction.astype(np.float32), spacing)
        write_nifti(os.path.join(test_save_path, f"{case}_img.nii.gz"),
                    image.astype(np.float32), spacing)
        write_nifti(os.path.join(test_save_path, f"{case}_gt.nii.gz"),
                    label.astype(np.float32), spacing)
    return metric_list


def save_visuals(image, label, prediction, case_name, slice_idx, save_dir,
                 num_classes):
    """Side-by-side input / ground truth / prediction PNG (reference
    test.py:73-100)."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(1, 3, figsize=(18, 6))
    axes[0].imshow(np.squeeze(image), cmap="gray")
    axes[0].set_title("Input Image")
    axes[1].imshow(np.squeeze(label), cmap="jet", vmin=0, vmax=num_classes - 1)
    axes[1].set_title("Ground Truth")
    axes[2].imshow(np.squeeze(prediction), cmap="jet", vmin=0, vmax=num_classes - 1)
    axes[2].set_title("Model Prediction")
    for ax in axes:
        ax.axis("off")
    fig.savefig(
        os.path.join(save_dir, f"{case_name}_slice_{slice_idx}.png"),
        bbox_inches="tight", pad_inches=0.1,
    )
    plt.close(fig)


def inference(args, inferencer: VolumeInferencer, db_test, test_save_path=None,
              visual_save_dir=None, max_visuals: int = 5):
    """Per-case evaluation loop with the reference's log-line format
    (test.py:103-165); mid-slice visuals for the first ``max_visuals``
    cases when ``visual_save_dir`` is set (test.py:128-153)."""
    logging.info(f"{len(db_test)} test iterations per epoch")
    if visual_save_dir:
        try:
            import matplotlib  # noqa: F401 — visuals are an optional output
        except ImportError:
            logging.info("matplotlib is not installed: no visuals written")
            visual_save_dir = None
    metric_sum = 0.0
    num_visuals_saved = 0
    for i_batch in range(len(db_test)):
        sample = db_test[i_batch]
        image, label = sample["image"], sample["label"]
        case_name = sample["case_name"]

        if visual_save_dir and num_visuals_saved < max_visuals and image.ndim == 3:
            mid = image.shape[0] // 2
            ph = pw = args.img_size
            x, y = image.shape[1], image.shape[2]
            mid_in = nd_zoom(image[mid], (ph / x, pw / y), order=3).astype(np.float32)
            pred_mid = inferencer.predict_slices(mid_in[None])[0]
            pred_mid = nd_zoom(pred_mid, (x / ph, y / pw), order=0)
            os.makedirs(visual_save_dir, exist_ok=True)
            save_visuals(image[mid], label[mid], pred_mid, case_name, mid,
                         visual_save_dir, args.num_classes)
            num_visuals_saved += 1
        metric_i = test_single_volume(
            image, label, inferencer, classes=args.num_classes,
            patch_size=(args.img_size, args.img_size),
            test_save_path=test_save_path, case=case_name,
            z_spacing=getattr(args, "z_spacing", 1),
            device_metrics=getattr(args, "device_metrics", False),
        )
        metric_sum = metric_sum + np.array(metric_i)
        logging.info(
            "idx %d case %s mean_dice %f mean_hd95 %f"
            % (
                i_batch,
                case_name,
                np.mean(metric_i, axis=0)[0],
                np.mean(metric_i, axis=0)[1],
            )
        )
    metric_list = metric_sum / len(db_test)
    for i in range(1, args.num_classes):
        logging.info(
            "Mean class %d mean_dice %f mean_hd95 %f"
            % (i, metric_list[i - 1][0], metric_list[i - 1][1])
        )
    performance = np.mean(metric_list, axis=0)[0]
    mean_hd95 = np.mean(metric_list, axis=0)[1]
    logging.info(
        "Testing performance in best val model: mean_dice : %f mean_hd95 : %f"
        % (performance, mean_hd95)
    )
    return performance, mean_hd95
