"""On-device EDT / HD95 vs the scipy + metrics.py host oracle.

The device path (ops/edt.py) must reproduce, with static shapes: the
squared EDT (scipy distance_transform_edt), the
boundary extraction (scipy binary_erosion cross/zero-border semantics),
medpy-convention HD95 (np.percentile linear interpolation over the
concatenated directed distances — metrics.hd95), and the
calculate_metric_percase edge rules (reference utils.py:48-58).
"""

import numpy as np
import pytest
from scipy import ndimage

import jax
import jax.numpy as jnp

from cswin_unet_tpu.metrics import hd95, metric_per_case
from cswin_unet_tpu.ops import edt


def _blob(rng, shape, p=0.2, smooth=1.2):
    x = rng.standard_normal(shape)
    x = ndimage.gaussian_filter(x, smooth)
    return x > np.quantile(x, 1 - p)


@pytest.mark.parametrize("shape", [(6, 24, 24), (1, 40, 40), (5, 17, 33)])
def test_edt_sq_matches_scipy(shape):
    rng = np.random.default_rng(0)
    seeds = _blob(rng, shape, p=0.05)
    if not seeds.any():
        seeds.flat[0] = True
    got = np.asarray(edt.edt_sq(jnp.asarray(seeds)))
    want = ndimage.distance_transform_edt(~seeds) ** 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)


def test_boundary_matches_scipy():
    rng = np.random.default_rng(1)
    m = _blob(rng, (7, 30, 30), p=0.3)
    conn = ndimage.generate_binary_structure(3, 1)
    want = m ^ ndimage.binary_erosion(m, structure=conn, iterations=1)
    got = np.asarray(edt.boundary(jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)


def test_boundary_singleton_axis():
    # scipy erodes a depth-1 volume away entirely (OOB neighbours false).
    m = np.ones((1, 8, 8), bool)
    conn = ndimage.generate_binary_structure(3, 1)
    want = m ^ ndimage.binary_erosion(m, structure=conn, iterations=1)
    got = np.asarray(edt.boundary(jnp.asarray(m)))
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hd95_matches_host(seed):
    rng = np.random.default_rng(seed)
    pred = _blob(rng, (5, 28, 28), p=0.25)
    gt = _blob(rng, (5, 28, 28), p=0.25)
    if not pred.any():
        pred[2, 10, 10] = True
    if not gt.any():
        gt[2, 12, 12] = True
    got = float(edt.hd95_pair(jnp.asarray(pred), jnp.asarray(gt)))
    want = hd95(pred, gt, use_native=False)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_volume_metrics_device_edge_rules():
    rng = np.random.default_rng(3)
    num_classes = 4
    label = rng.integers(0, 3, size=(4, 20, 20)).astype(np.int32)
    pred = label.copy()
    # class 1: imperfect overlap; class 2: present in both; class 3:
    # pred-only (edge rule (1, 0)); absent-everywhere would be (0, 0).
    pred[label == 1] = np.where(rng.random((label == 1).sum()) < 0.8, 1, 0)
    pred[0, 0, :3] = 3
    got = np.asarray(edt.volume_metrics_device(
        jnp.asarray(pred), jnp.asarray(label), num_classes))
    want = np.array([metric_per_case(pred == c, label == c)
                     for c in range(1, num_classes)])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


def test_volume_metrics_device_both_empty():
    label = np.zeros((3, 16, 16), np.int32)
    pred = np.zeros((3, 16, 16), np.int32)
    got = np.asarray(edt.volume_metrics_device(
        jnp.asarray(pred), jnp.asarray(label), 3))
    np.testing.assert_allclose(got, np.zeros((2, 2)), atol=0)


@pytest.mark.parametrize("out_hw", [(224, 224), (512, 512), (100, 317)])
def test_zoom_nearest_matches_scipy(out_hw):
    rng = np.random.default_rng(5)
    x = rng.integers(0, 9, size=(3, 224, 224)).astype(np.int32)
    want = np.stack([
        ndimage.zoom(s, (out_hw[0] / x.shape[1], out_hw[1] / x.shape[2]),
                     order=0) for s in x])
    got = np.asarray(edt.zoom_nearest(jnp.asarray(x), out_hw))
    np.testing.assert_array_equal(got, want)


def _edt_pass_oracle(f):
    L = f.shape[-1]
    i = np.arange(L, dtype=np.float64)
    return np.min((i[:, None] - i[None, :]) ** 2 + f[..., None, :], axis=-1)


def _seeded(rng, shape, p=0.03):
    seeds = rng.random(shape) < p
    return np.where(seeds, 0.0, 1e12).astype(np.float32)


@pytest.mark.parametrize("rows,L,chunk_rows", [(7, 16, 3), (1, 9, 4)])
def test_edt_pass_rows_not_a_multiple_of_the_chunk(rows, L, chunk_rows):
    """Row counts that leave a partial last chunk (padded, then cropped)."""
    f = _seeded(np.random.default_rng(rows), (rows, L))
    got = np.asarray(edt.edt_pass(jnp.asarray(f), chunk_bytes=4 * L * L * chunk_rows))
    np.testing.assert_allclose(got, _edt_pass_oracle(f), rtol=1e-6)


def test_edt_sq_512_wide_in_chunks():
    """A 512-wide volume through several small chunks per pass."""
    rng = np.random.default_rng(11)
    seeds = rng.random((2, 6, 512)) < 0.01
    f = np.where(seeds, 0.0, 1e12).astype(np.float32)
    got = np.asarray(edt.edt_pass(jnp.asarray(f), chunk_bytes=4 * 512 * 512 * 5))
    np.testing.assert_allclose(got, _edt_pass_oracle(f), rtol=1e-6)
    full = np.asarray(edt.edt_sq(jnp.asarray(seeds)))
    want = ndimage.distance_transform_edt(~seeds) ** 2
    np.testing.assert_allclose(full, want, rtol=1e-5, atol=1e-3)


def test_edt_sq_anisotropic_3d():
    """Three different axis lengths, so every pass has its own L."""
    rng = np.random.default_rng(12)
    seeds = _blob(rng, (3, 11, 29), p=0.04)
    if not seeds.any():
        seeds[1, 5, 7] = True
    got = np.asarray(edt.edt_sq(jnp.asarray(seeds)))
    want = ndimage.distance_transform_edt(~seeds) ** 2
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-3)
