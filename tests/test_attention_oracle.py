"""``cswin_attention_xla`` against the numpy loop oracle at every production
window class: tiny-224 stages 1-4 (reso 56/28/14/7, split 1/2/7/7) and
base-384 stages 1-4 (reso 96/48/24/12, split 1/2/12/12), each stripe
orientation (vertical: H x split, horizontal: split x W; the last stage's
single full window), forward and gradient."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

import reference_ops as ref
from cswin_unet_tpu.ops.attention import cswin_attention_xla

# (name, reso, split, last): channel counts are reduced, head dim kept >= 4
CLASSES = [
    ("tiny-s1", 56, 1, False), ("tiny-s2", 28, 2, False),
    ("tiny-s3", 14, 7, False), ("tiny-s4", 7, 7, True),
    ("base-s1", 96, 1, False), ("base-s2", 48, 2, False),
    ("base-s3", 24, 12, False), ("base-s4", 12, 12, True),
]
CASES = []
for name, reso, split, last in CLASSES:
    if last:
        CASES.append((f"{name}-full", reso, reso, reso))
    else:
        CASES.append((f"{name}-vertical", reso, reso, split))
        CASES.append((f"{name}-horizontal", reso, split, reso))
IDS = [c[0] for c in CASES]
C, HEADS = 8, 2


def _inputs(reso, seed):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((1, reso, reso, C)).astype(np.float32)
               for _ in range(3))
    lk = rng.standard_normal((3, 3, 1, C)).astype(np.float32) * 0.3
    lb = rng.standard_normal(C).astype(np.float32) * 0.1
    return q, k, v, lk, lb


@pytest.mark.parametrize("name,reso,h_sp,w_sp", CASES, ids=IDS)
def test_attention_matches_oracle(name, reso, h_sp, w_sp):
    q, k, v, lk, lb = _inputs(reso, 0)
    scale = (C // HEADS) ** -0.5
    got = jax.jit(lambda *a: cswin_attention_xla(
        *a, h_sp=h_sp, w_sp=w_sp, num_heads=HEADS, scale=scale))(q, k, v, lk, lb)
    want = ref.stripe_attention(q, k, v, lk[:, :, 0], lb, h_sp, w_sp, HEADS, scale)
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("name,reso,h_sp,w_sp", CASES, ids=IDS)
def test_attention_gradient(name, reso, h_sp, w_sp):
    q, k, v, lk, lb = (jnp.asarray(a) for a in _inputs(reso, 1))
    scale = (C // HEADS) ** -0.5
    f = jax.jit(lambda *a: cswin_attention_xla(
        *a, h_sp=h_sp, w_sp=w_sp, num_heads=HEADS, scale=scale))

    def loss(*args):
        y = f(*args)
        return jnp.sum(y * jnp.sin(jnp.arange(y.size, dtype=jnp.float32)).reshape(y.shape))

    check_grads(loss, (q, k, v, lk, lb), order=1, modes=("rev",),
                eps=1e-2, atol=5e-2, rtol=5e-2)
