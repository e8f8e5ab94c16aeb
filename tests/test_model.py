"""Model-level tests on a small geometry (img 32, embed 16) to keep CPU
compiles fast; full-size runs happen in bench.py and chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cswin_unet_tpu.models import CSWinUNet, CSwinUnet

SMALL = dict(
    img_size=32,
    num_classes=4,
    embed_dim=16,
    depth=(1, 1, 2, 1),
    split_size=(1, 2, 2, 1),
    num_heads=(2, 2, 4, 8),
    drop_path_rate=0.1,
)


@pytest.fixture(scope="module")
def small_model_and_params():
    m = CSWinUNet(**SMALL)
    x = jnp.zeros((2, 32, 32, 3))
    params = m.init(jax.random.PRNGKey(0), x)
    return m, params


def test_forward_shape_and_dtype(small_model_and_params):
    m, params = small_model_and_params
    y = m.apply(params, jnp.zeros((2, 32, 32, 3)))
    assert y.shape == (2, 32, 32, 4)
    assert y.dtype == jnp.float32


def test_deterministic_eval(small_model_and_params):
    m, params = small_model_and_params
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32, 3))
    y1 = m.apply(params, x)
    y2 = m.apply(params, x)
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y2))


def test_train_mode_droppath_stochastic(small_model_and_params):
    m, params = small_model_and_params
    x = jax.random.normal(jax.random.PRNGKey(1), (2, 32, 32, 3))
    y1 = m.apply(params, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(2)})
    y2 = m.apply(params, x, deterministic=False, rngs={"dropout": jax.random.PRNGKey(3)})
    assert np.abs(np.asarray(y1) - np.asarray(y2)).max() > 1e-6


def test_gradients_flow_everywhere(small_model_and_params):
    m, params = small_model_and_params
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, 3))

    def loss_fn(p):
        return jnp.sum(m.apply(p, x) ** 2)

    grads = jax.grad(loss_fn)(params)
    flat = jax.tree_util.tree_leaves_with_path(grads)
    zero = [jax.tree_util.keystr(k) for k, g in flat if float(jnp.abs(g).max()) == 0.0]
    assert not zero, f"dead params: {zero[:10]}"


def test_remat_matches_no_remat():
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, 3))
    m1 = CSWinUNet(**SMALL)
    m2 = CSWinUNet(**SMALL, use_remat=True)
    p = m1.init(jax.random.PRNGKey(0), x)
    y1 = m1.apply(p, x)
    y2 = m2.apply(p, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y2), rtol=1e-6, atol=1e-6)


def test_wrapper_repeats_single_channel():
    m = CSwinUnet(backbone=CSWinUNet(**SMALL))
    x1 = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, 1))
    params = m.init(jax.random.PRNGKey(0), x1)
    y1 = m.apply(params, x1)
    y3 = m.apply(params, jnp.repeat(x1, 3, axis=-1))
    np.testing.assert_array_equal(np.asarray(y1), np.asarray(y3))


def test_bf16_compute_close_to_f32(small_model_and_params):
    m, params = small_model_and_params
    mb = CSWinUNet(**SMALL, dtype=jnp.bfloat16)
    x = jax.random.normal(jax.random.PRNGKey(1), (1, 32, 32, 3))
    y32 = np.asarray(m.apply(params, x))
    y16 = np.asarray(mb.apply(params, x))
    assert y16.dtype == np.float32  # output cast back
    # bf16 activations: loose agreement is expected
    denom = np.abs(y32).mean() + 1e-6
    assert np.abs(y16 - y32).mean() / denom < 0.15
