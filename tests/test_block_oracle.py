"""CSWin block (models.cswin_block) against the numpy loop oracle.

Covers the block geometries the model builds: both stripe orientations,
split 1 and split > 1, reso == split (single full-window branch), the last
stage, and every production window class of tiny-224 (reso 56/28/14/7,
split 1/2/7/7) and base-384 (reso 96/48/24/12, split 1/2/12/12) at reduced
channel counts. Each geometry is checked in f32, in bf16, and for its
gradient (``jax.test_util.check_grads``, reverse mode).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.test_util import check_grads

import reference_ops as ref
from cswin_unet_tpu.models import cswin_block

# (name, H, W, C, heads, split, last)
GEOMETRIES = [
    ("s1-8", 8, 8, 16, 2, 1, False),
    ("s2-8", 8, 8, 16, 2, 2, False),
    ("s4-8", 8, 8, 32, 4, 4, False),
    ("last-4", 4, 4, 32, 4, 4, True),
    ("s12-24", 24, 24, 32, 4, 12, False),
    ("last-12", 12, 12, 32, 4, 12, True),
    # tiny-224 stages 1-4
    ("tiny-56", 56, 56, 8, 2, 1, False),
    ("tiny-28", 28, 28, 8, 2, 2, False),
    ("tiny-14", 14, 14, 16, 4, 7, False),
    ("tiny-7", 7, 7, 16, 4, 7, True),
    # base-384 stages 1-4
    ("base-96", 96, 96, 8, 2, 1, False),
    ("base-48", 48, 48, 8, 2, 2, False),
    ("base-24", 24, 24, 16, 4, 12, False),
    ("base-12", 12, 12, 16, 4, 12, True),
]
IDS = [g[0] for g in GEOMETRIES]


def _params(rng, C, last):
    def mk(*shape, s=0.2):
        return rng.standard_normal(shape).astype(np.float32) * s

    cb = C if last else C // 2
    p = {
        "norm1": {"scale": 1.0 + mk(C), "bias": mk(C)},
        "qkv": {"kernel": mk(C, 3 * C, s=C ** -0.5), "bias": mk(3 * C)},
        "attns_0": {"get_v_kernel": mk(3, 3, 1, cb), "get_v_bias": mk(cb)},
        "proj": {"kernel": mk(C, C, s=C ** -0.5), "bias": mk(C)},
        "norm2": {"scale": 1.0 + mk(C), "bias": mk(C)},
        "mlp": {"fc1": {"kernel": mk(C, 4 * C, s=C ** -0.5), "bias": mk(4 * C)},
                "fc2": {"kernel": mk(4 * C, C, s=(4 * C) ** -0.5), "bias": mk(C)}},
    }
    if not last:
        p["attns_1"] = {"get_v_kernel": mk(3, 3, 1, cb), "get_v_bias": mk(cb)}
    return p


def _case(geom, seed=0, B=1):
    _, H, W, C, heads, split, last = geom
    rng = np.random.default_rng(seed)
    p = _params(rng, C, last)
    x = rng.standard_normal((B, H, W, C)).astype(np.float32)
    fn = functools.partial(cswin_block, rng=None, num_heads=heads,
                           split_size=split, last=last, qk_scale=None,
                           drop=0.0, drop_path=0.0)
    want = ref.cswin_block(x, p, heads=heads, split=split, last=last)
    return fn, p, x, want


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_block_f32_matches_oracle(geom):
    fn, p, x, want = _case(geom)
    got = jax.jit(functools.partial(fn, dtype=jnp.float32))(p, jnp.asarray(x))
    np.testing.assert_allclose(np.asarray(got), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_block_bf16_close_to_oracle(geom):
    fn, p, x, want = _case(geom)
    got = jax.jit(functools.partial(fn, dtype=jnp.bfloat16))(
        p, jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == jnp.bfloat16
    got = np.asarray(got, np.float64)
    # bf16 keeps 8 mantissa bits: ~0.4% per rounding, a dozen roundings deep
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < 2e-2, rel


@pytest.mark.parametrize("geom", GEOMETRIES, ids=IDS)
def test_block_gradient(geom):
    fn, p, x, _ = _case(geom, seed=1)
    f = jax.jit(functools.partial(fn, dtype=jnp.float32))

    def loss(params, inp):
        y = f(params, inp)
        return jnp.sum(y * jnp.cos(jnp.arange(y.size, dtype=jnp.float32)).reshape(y.shape))

    check_grads(loss, (p, jnp.asarray(x)), order=1, modes=("rev",),
                eps=1e-2, atol=5e-2, rtol=5e-2)
