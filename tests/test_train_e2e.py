"""End-to-end: train the small model on synthetic data across the 8-device
CPU mesh, watch the loss fall, then run batched volume inference."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cswin_unet_tpu.data import (
    DataLoader,
    RandomGenerator,
    SynapseDataset,
    device_prefetch,
    make_synthetic_dataset,
)
from cswin_unet_tpu.eval import VolumeInferencer
from cswin_unet_tpu.eval import test_single_volume as run_single_volume
from cswin_unet_tpu.models import CSWinUNet, CSwinUnet
from cswin_unet_tpu.parallel import batch_sharding, make_mesh, replicated_sharding
from cswin_unet_tpu.train.trainer import make_optimizer, make_train_step

SMALL = dict(
    img_size=32, num_classes=4, embed_dim=16,
    depth=(1, 1, 1, 1), split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8),
    drop_path_rate=0.1,
)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    root = tmp_path_factory.mktemp("synth_e2e")
    return make_synthetic_dataset(str(root), num_train_slices=16, num_volumes=1,
                                  size=48, depth=4, num_classes=4)


def test_train_loss_decreases_on_mesh(synth):
    assert jax.device_count() == 8
    model = CSwinUnet(backbone=CSWinUNet(**SMALL))
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))

    mesh = make_mesh()
    bsh = batch_sharding(mesh)
    rsh = replicated_sharding(mesh)
    params = jax.device_put(params, rsh)

    ds = SynapseDataset(synth["train_dir"], synth["list_dir"], "train",
                        transform=RandomGenerator([32, 32]))
    loader = DataLoader(ds, batch_size=8, shuffle=True, seed=0, num_workers=2)

    steps = 30
    optimizer = make_optimizer(base_lr=0.05, max_iterations=steps)
    opt_state = jax.device_put(optimizer.init(jax.device_get(params)), rsh)
    train_step = make_train_step(model, optimizer, num_classes=4)

    losses = []
    it = 0
    while it < steps:
        for batch in device_prefetch(iter(loader), bsh):
            rng = jax.random.fold_in(jax.random.PRNGKey(0), it)
            params, opt_state, aux = train_step(
                params, opt_state, batch["image"], batch["label"], rng
            )
            losses.append(float(aux["loss"]))
            it += 1
            if it >= steps:
                break

    first = np.mean(losses[:5])
    last = np.mean(losses[-5:])
    assert last < first * 0.8, f"loss did not decrease: {first} -> {last}"

    # Batched volume inference on the trained params.
    vol_ds = SynapseDataset(synth["vol_dir"], synth["list_dir"], "test_vol")
    sample = vol_ds[0]
    inf = VolumeInferencer(model, params, patch_size=(32, 32), batch_slices=4)
    metrics = run_single_volume(sample["image"], sample["label"], inf,
                                 classes=4, patch_size=(32, 32))
    assert len(metrics) == 3
    for dice, h in metrics:
        assert 0.0 <= dice <= 1.0
        assert h >= 0.0


def test_inference_padding_consistency(synth):
    """Predictions must not depend on the inference chunk size."""
    model = CSwinUnet(backbone=CSWinUNet(**SMALL))
    params = model.init(jax.random.PRNGKey(1), jnp.zeros((1, 32, 32, 1)))
    vol_ds = SynapseDataset(synth["vol_dir"], synth["list_dir"], "test_vol")
    image = vol_ds[0]["image"]  # (4, 48, 48)

    from scipy.ndimage import zoom as nd_zoom
    slices = np.stack([nd_zoom(s, (32 / 48, 32 / 48), order=3) for s in image]).astype(np.float32)

    p1 = VolumeInferencer(model, params, patch_size=(32, 32), batch_slices=3).predict_slices(slices)
    p2 = VolumeInferencer(model, params, patch_size=(32, 32), batch_slices=8).predict_slices(slices)
    np.testing.assert_array_equal(p1, p2)


def test_device_metrics_match_host(synth):
    """test_single_volume(device_metrics=True) — the plain-jnp EDT on-device
    tail (predict on device -> nearest zoom -> volume_metrics_device) must
    reproduce the host path (scipy zoom + metrics.py EDT) bit-for-bit on
    the same predictions, including the depth-16 padding."""
    model = CSwinUnet(backbone=CSWinUNet(**SMALL))
    params = model.init(jax.random.PRNGKey(2), jnp.zeros((1, 32, 32, 1)))
    vol_ds = SynapseDataset(synth["vol_dir"], synth["list_dir"], "test_vol")
    sample = vol_ds[0]
    inf = VolumeInferencer(model, params, patch_size=(32, 32), batch_slices=4)
    host = np.array(run_single_volume(sample["image"], sample["label"], inf,
                                      classes=4, patch_size=(32, 32)))
    dev = np.array(run_single_volume(sample["image"], sample["label"], inf,
                                     classes=4, patch_size=(32, 32),
                                     device_metrics=True))
    np.testing.assert_allclose(dev, host, rtol=1e-5, atol=1e-4)
