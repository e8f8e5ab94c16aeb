"""``carafe_with_classifier`` (the model's CARAFE + 1x1 classifier tail)
against the numpy unfold + softmax + pixel-shuffle oracle, for up-factors
2 and 4, in f32 and bf16, forward and gradient; and the labels the eval
forward takes from it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

import reference_ops as ref
from cswin_unet_tpu.ops.carafe import carafe_with_classifier

C, NC, H, W = 16, 5, 6, 5


def _inputs(up, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda *s, sc=0.3: rng.standard_normal(s).astype(np.float32) * sc  # noqa: E731
    c_mid, c_enc = C // 4, up * up * 9
    p = {"down_kernel": mk(1, 1, C, c_mid), "down_bias": mk(c_mid),
         "encoder_kernel": mk(3, 3, c_mid, c_enc), "encoder_bias": mk(c_enc),
         "out_kernel": mk(1, 1, C, C), "out_bias": mk(C)}
    return p, mk(1, 1, C, NC), mk(2, H, W, C, sc=1.0)


def _run(p, cls, x, up, dtype):
    return carafe_with_classifier(x.astype(dtype), **p, cls_kernel=cls,
                                  kernel_size=3, up_factor=up)


@pytest.mark.parametrize("up", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_forward_matches_oracle(up, dtype):
    p, cls, x = _inputs(up)
    got = jax.jit(_run, static_argnums=(3, 4))(p, cls, jnp.asarray(x), up, jnp.dtype(dtype))
    assert got.shape == (2, H * up, W * up, NC)
    want = ref.carafe_classifier(x, p, cls, up)
    got = np.asarray(got, np.float64)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-5)
    else:
        assert np.linalg.norm(got - want) / np.linalg.norm(want) < 2e-2


@pytest.mark.parametrize("up", [2, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tail_gradient(up, dtype):
    p, cls, x = _inputs(up, seed=1)
    p, cls, x = jax.tree.map(jnp.asarray, (p, cls, x))

    def loss(p, cls, x, dt):
        y = _run(p, cls, x, up, dt).astype(jnp.float32)
        # positive-mean weights: the bias gradients are not a cancelling sum
        w = 1.0 + 0.5 * jnp.cos(jnp.arange(y.size, dtype=jnp.float32))
        return jnp.sum(y * w.reshape(y.shape))

    if dtype == "float32":
        check_grads(lambda *a: loss(*a, jnp.float32), (p, cls, x), order=1,
                    modes=("rev",), eps=1e-2, atol=5e-2, rtol=5e-2)
    else:
        # bf16 gradients against the f32 ones of the same function
        g16 = jax.grad(loss, argnums=(0, 1, 2))(p, cls, x, jnp.bfloat16)
        g32 = jax.grad(loss, argnums=(0, 1, 2))(p, cls, x, jnp.float32)
        for a, b in zip(jax.tree.leaves(g16), jax.tree.leaves(g32)):
            a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
            assert np.linalg.norm(a - b) <= 5e-2 * np.linalg.norm(b) + 1e-6


def test_tail_labels_match_oracle_argmax():
    p, cls, x = _inputs(4, seed=2)
    got = np.asarray(jnp.argmax(_run(p, cls, jnp.asarray(x), 4, jnp.float32), -1))
    want = ref.carafe_classifier(x, p, cls, 4)
    srt = np.sort(want, -1)
    clear = (srt[..., -1] - srt[..., -2]) > 1e-4   # ignore exact near-ties
    np.testing.assert_array_equal(got[clear], want.argmax(-1)[clear])
    assert clear.mean() > 0.99
