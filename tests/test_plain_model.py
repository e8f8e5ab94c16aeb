"""The plain-JAX model against a golden record of the flax.linen model it
replaced (recorded at commit 73d54ce, CPU, f32).

``tests/data/golden_ckpt.npz`` is a checkpoint written by that commit's
``save_checkpoint`` (flat ``params/backbone/...`` keys, float16 values) for
a width-6 model. ``tests/data/golden.npz`` holds, for two geometries that
share those parameters, the input, the f32 logits and three projections of
every parameter gradient (sum, L2 norm, and the dot with
cos(0.7·i + 0.3)) of ``sum(logits · cos(i)) / batch``; plus the key-path /
shape / dtype manifests of the flax parameter trees for tiny-224,
base-384 and the CLI test config.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cswin_unet_tpu.config import get_config
from cswin_unet_tpu.models import CSWinUNet, CSwinUnet, build_model, cswin_block
from cswin_unet_tpu.utils.checkpoint import (flatten, load_checkpoint,
                                             merge_matching, unflatten)

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = dict(num_classes=4, embed_dim=6, depth=(1, 1, 1, 1),
             num_heads=(2, 2, 4, 8), drop_path_rate=0.1, dtype=jnp.float32)
GEOMS = {
    "g32": dict(img_size=32, split_size=(1, 2, 1, 1)),
    "g64": dict(img_size=64, split_size=(2, 4, 2, 2)),
}
TEST_CFG = """MODEL:
  TYPE: cswin
  NAME: cswin_test_tiny
  DROP_PATH_RATE: 0.1
  PRETRAIN_CKPT: ""
  CSWIN:
    EMBED_DIM: 16
    DEPTH: [1, 1, 1, 1]
    NUM_HEADS: [2, 2, 4, 8]
    SPLIT_SIZE: [1, 2, 2, 1]
"""


@pytest.fixture(scope="module")
def golden():
    with np.load(os.path.join(DATA, "golden.npz")) as g:
        return {k: g[k] for k in g.files}


def _model(name):
    return CSwinUnet(backbone=CSWinUNet(**WIDTH, **GEOMS[name]))


def _golden_params(model, img):
    """The old checkpoint through the production load path."""
    loaded, _ = load_checkpoint(os.path.join(DATA, "golden_ckpt.npz"))
    template = model.init(jax.random.PRNGKey(1), jnp.zeros((1, img, img, 1)))
    return unflatten(merge_matching(flatten(jax.device_get(template)),
                                    flatten(loaded), log=pytest.fail))


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_golden_logits(golden, name):
    m = _model(name)
    params = _golden_params(m, GEOMS[name]["img_size"])
    y = jax.jit(m.apply)(params, jnp.asarray(golden[f"{name}/x"]))
    np.testing.assert_allclose(np.asarray(y), golden[f"{name}/logits"],
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_golden_grads(golden, name):
    m = _model(name)
    params = _golden_params(m, GEOMS[name]["img_size"])
    x = jnp.asarray(golden[f"{name}/x"])
    shape = golden[f"{name}/logits"].shape
    w = jnp.cos(jnp.arange(np.prod(shape), dtype=jnp.float32)).reshape(shape)
    grads = flatten(jax.jit(jax.grad(
        lambda p: jnp.sum(m.apply(p, x) * w) / shape[0]))(params))
    keys = [str(k) for k in golden[f"{name}/grad_keys"]]
    assert sorted(grads) == keys
    got = []
    for k in keys:
        g = np.asarray(grads[k], np.float64).ravel()
        c = np.cos(0.7 * np.arange(g.size) + 0.3)
        got.append([g.sum(), np.sqrt((g * g).sum()), (g * c).sum()])
    want = golden[f"{name}/grad_proj"]
    # each projection against the leaf's gradient norm
    err = np.abs(np.asarray(got) - want) / (want[:, 1:2] + 1e-12)
    assert err.max() < 1e-4, keys[int(err.max(axis=1).argmax())]


def _manifest(model, img):
    tree = jax.eval_shape(model.init, jax.random.PRNGKey(0), jnp.zeros((1, img, img, 1)))
    return {k: [list(v.shape), str(v.dtype)] for k, v in flatten(tree).items()}


@pytest.mark.parametrize("key,cfg,img", [
    ("tiny224", "cswin_unet_tpu/configs/cswin_tiny_224_lite.yaml", 224),
    ("base384", "cswin_unet_tpu/configs/cswin_base_384.yaml", 384),
    ("test32", None, 32),
])
def test_param_tree_matches_flax_manifest(golden, tmp_path, key, cfg, img):
    if cfg is None:
        path = tmp_path / "tiny.yaml"
        path.write_text(TEST_CFG)
        cfg = str(path)
    else:
        cfg = os.path.join(REPO, cfg)
    config = get_config(type("A", (), {"cfg": cfg, "opts": None})())
    got = _manifest(build_model(config, img_size=img, num_classes=9), img)
    want = json.loads(bytes(golden["manifests"]).decode())[key]
    assert got == want


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_emit_labels_is_argmax(golden, name):
    m = _model(name)
    params = _golden_params(m, GEOMS[name]["img_size"])
    x = jnp.asarray(golden[f"{name}/x"])
    labels = m.apply(params, x, emit="labels")
    assert labels.dtype == jnp.int32
    np.testing.assert_array_equal(
        np.asarray(labels), np.asarray(m.apply(params, x)).argmax(-1))


def test_old_checkpoint_loads_unchanged():
    """Every key of the old file lands on a leaf of the same shape, and the
    values come through bit-exact (float16 -> float32 is exact)."""
    loaded, _ = load_checkpoint(os.path.join(DATA, "golden_ckpt.npz"))
    m = _model("g32")
    params = _golden_params(m, 32)
    flat_old, flat_new = flatten(loaded), flatten(params)
    assert set(flat_old) == set(flat_new)
    for k, v in flat_old.items():
        assert flat_new[k].dtype == np.float32
        np.testing.assert_array_equal(flat_new[k], v.astype(np.float32))


def _block_inputs():
    rng = np.random.default_rng(0)
    C = 8
    m = CSWinUNet(img_size=32, embed_dim=C, depth=(1, 1, 1, 1),
                  split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8))
    p = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))["params"]["stage1_0"]
    x = jnp.asarray(rng.standard_normal((16, 8, 8, C)).astype(np.float32))
    return p, x


def test_drop_path_is_per_sample_and_rescaled():
    """Each residual branch of each sample is either dropped or kept and
    scaled by 1/(1-p) (timm DropPath): the output equals one of the four
    keep/drop combinations, computed from deterministic pieces."""
    p, x = _block_inputs()
    rate = 0.4
    kw = dict(num_heads=2, split_size=1, last=False, qk_scale=None, drop=0.0,
              dtype=jnp.float32)
    run = lambda params, inp, dp, key: cswin_block(params, inp, key, drop_path=dp, **kw)  # noqa: E731
    zero = lambda t: jax.tree.map(jnp.zeros_like, t)  # noqa: E731
    p_attn_only = dict(p, mlp=dict(p["mlp"], fc2=zero(p["mlp"]["fc2"])))
    p_mlp_only = dict(p, proj=zero(p["proj"]))
    out = run(p, x, rate, jax.random.PRNGKey(3))
    kept_any = set()
    for b in range(x.shape[0]):
        xb = x[b:b + 1]
        att = run(p_attn_only, xb, 0.0, None) - xb           # attention branch
        matches = []
        for a_keep in (0.0, 1.0 / (1 - rate)):
            x1 = xb + a_keep * att
            mlp = run(p_mlp_only, x1, 0.0, None) - x1        # MLP branch of x1
            for m_keep in (0.0, 1.0 / (1 - rate)):
                if np.allclose(out[b:b + 1], x1 + m_keep * mlp, rtol=1e-5, atol=1e-5):
                    matches.append((a_keep > 0, m_keep > 0))
        assert len(matches) == 1, (b, matches)
        kept_any.add(matches[0])
    # 16 samples x 2 branches at p = 0.4: both outcomes occur
    assert {k[0] for k in kept_any} == {True, False}


def test_drop_path_off_when_deterministic():
    p, x = _block_inputs()
    kw = dict(num_heads=2, split_size=1, last=False, qk_scale=None, drop=0.0,
              dtype=jnp.float32)
    det = cswin_block(p, x, None, drop_path=0.4, **kw)
    no_dp = cswin_block(p, x, jax.random.PRNGKey(0), drop_path=0.0, **kw)
    np.testing.assert_array_equal(np.asarray(det), np.asarray(no_dp))
    # and the model's rng is only consumed in training mode
    m = CSWinUNet(img_size=32, embed_dim=8, depth=(1, 1, 1, 1),
                  split_size=(1, 2, 2, 1), num_heads=(2, 2, 4, 8),
                  drop_path_rate=0.5)
    variables = m.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    xin = jnp.ones((2, 32, 32, 3))
    a = m.apply(variables, xin)
    b = m.apply(variables, xin, deterministic=True, rngs={"dropout": jax.random.PRNGKey(9)})
    c = m.apply(variables, xin, deterministic=False, rngs={"dropout": jax.random.PRNGKey(9)})
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert np.abs(np.asarray(a) - np.asarray(c)).max() > 1e-6
