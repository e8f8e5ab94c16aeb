"""Train-state save/restore (one .npz) and trainer resume semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from cswin_unet_tpu.utils.checkpoint import restore_train_state, save_train_state


def test_train_state_roundtrip(tmp_path):
    params = {"params": {"w": jnp.arange(6.0).reshape(2, 3), "b": jnp.zeros(3)}}
    opt = optax.chain(optax.add_decayed_weights(1e-4), optax.sgd(0.1, momentum=0.9))
    opt_state = opt.init(params)

    # take two steps so momentum is nontrivial
    for i in range(2):
        grads = jax.tree.map(lambda x: jnp.ones_like(x) * (i + 1), params)
        updates, opt_state = opt.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)

    path = str(tmp_path / "state")
    save_train_state(path, params, opt_state, step=17)

    params0 = jax.tree.map(jnp.zeros_like, params)
    opt_state0 = opt.init(params0)
    p, s, step = restore_train_state(path, params0, opt_state0)
    assert step == 17
    np.testing.assert_allclose(np.asarray(p["params"]["w"]),
                               np.asarray(params["params"]["w"]))
    # momentum buffers restored exactly
    flat_a = jax.tree.leaves(s)
    flat_b = jax.tree.leaves(opt_state)
    for a, b in zip(flat_a, flat_b):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b))


def _trainer_state():
    from cswin_unet_tpu.train.trainer import make_optimizer

    params = {"params": {"backbone": {"qkv": {"kernel": jnp.ones((4, 12)),
                                              "bias": jnp.zeros(12)}}}}
    opt = make_optimizer(0.01, 100)
    state = opt.init(params)
    grads = jax.tree.map(lambda x: jnp.full_like(x, 0.5), params)
    _, state = opt.update(grads, state, params)
    return params, opt, state


def test_train_state_npz_roundtrip_with_trainer_optimizer(tmp_path):
    """The trainer's optimizer (decayed weights + SGD momentum + poly
    schedule): every leaf, including the schedule count, comes back."""
    params, opt, state = _trainer_state()
    path = str(tmp_path / "train_state")
    save_train_state(path, params, state, step=3)
    p, s, step = restore_train_state(path, jax.tree.map(jnp.zeros_like, params),
                                     opt.init(params))
    assert step == 3
    assert jax.tree.structure(s) == jax.tree.structure(state)
    for a, b in zip(jax.tree.leaves((p, s)), jax.tree.leaves((params, state))):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_train_state_restore_rejects_a_different_model(tmp_path):
    params, opt, state = _trainer_state()
    save_train_state(str(tmp_path / "ts"), params, state, step=1)
    other = {"params": {"backbone": {"qkv": {"kernel": jnp.ones((4, 24)),
                                             "bias": jnp.zeros(24)}}}}
    with pytest.raises(ValueError, match="stored shape"):
        restore_train_state(str(tmp_path / "ts"), other, opt.init(other))
