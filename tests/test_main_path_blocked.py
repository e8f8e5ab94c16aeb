"""The main path needs none of flax, yaml, orbax, h5py or matplotlib: train
(with both checkpoint kinds) and volume eval (with visuals requested) run in
a fresh process in which importing any of them fails."""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PRELUDE = textwrap.dedent("""
    import sys
    for name in ("flax", "yaml", "orbax", "orbax.checkpoint", "h5py", "matplotlib"):
        sys.modules[name] = None
    sys.path.insert(0, {repo!r})
    import jax
    jax.config.update("jax_platforms", "cpu")
    import os
    from types import SimpleNamespace
    import numpy as np
    import jax.numpy as jnp
    from cswin_unet_tpu.config import get_config
    from cswin_unet_tpu.models import build_model
    work = sys.argv[1]
    cfg = os.path.join(work, "tiny.yaml")
    with open(cfg, "w") as f:
        f.write("MODEL:\\n  DROP_PATH_RATE: 0.1\\n  CSWIN:\\n    EMBED_DIM: 16\\n"
                "    DEPTH: [1, 1, 1, 1]\\n    NUM_HEADS: [2, 2, 4, 8]\\n"
                "    SPLIT_SIZE: [1, 2, 2, 1]\\n")
    model = build_model(get_config(SimpleNamespace(cfg=cfg, opts=None)),
                        img_size=32, num_classes=4)
    params = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 1)))
""")

TRAIN = textwrap.dedent("""
    from cswin_unet_tpu.data.synthetic import make_synthetic_dataset
    from cswin_unet_tpu.train import trainer_synapse
    from cswin_unet_tpu.train.trainer import make_optimizer
    from cswin_unet_tpu.utils.checkpoint import load_checkpoint, restore_train_state
    data = make_synthetic_dataset(os.path.join(work, "d"), num_train_slices=4,
                                  num_volumes=0, size=32, num_classes=4)
    args = SimpleNamespace(base_lr=0.01, num_classes=4, batch_size=2, img_size=32,
                           root_path=data["train_dir"], list_dir=data["list_dir"],
                           seed=0, max_epochs=1, num_workers=2)
    host = jax.device_get(params)
    trainer_synapse(args, model, params, os.path.join(work, "run"))
    load_checkpoint(os.path.join(work, "run", "epoch_0.npz"))
    _, _, step = restore_train_state(os.path.join(work, "run", "train_state"), host,
                                     make_optimizer(0.01, 2).init(host))
    assert step == 2, step
    print("TRAIN-OK")
""")

EVAL = textwrap.dedent("""
    import logging
    from cswin_unet_tpu.data.synthetic import make_volume
    from cswin_unet_tpu.eval import VolumeInferencer, inference
    logging.basicConfig(level=logging.INFO, stream=sys.stdout, format="%(message)s")
    image, label = make_volume(np.random.default_rng(0), 3, 40, 4)
    db = [{"image": image, "label": label, "case_name": "case0000"}]
    args = SimpleNamespace(img_size=32, num_classes=4, z_spacing=1, device_metrics=True)
    inference(args, VolumeInferencer(model, params, patch_size=(32, 32)), db,
              visual_save_dir=os.path.join(work, "visuals"))
    assert not os.path.exists(os.path.join(work, "visuals"))
    print("EVAL-OK")
""")


def _run(body, tmp_path):
    script = PRELUDE.format(repo=REPO) + body
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    proc = subprocess.run([sys.executable, "-c", script, str(tmp_path)], env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return proc.stdout


def test_train_path_without_optional_packages(tmp_path):
    assert "TRAIN-OK" in _run(TRAIN, tmp_path)


def test_eval_path_without_optional_packages(tmp_path):
    out = _run(EVAL, tmp_path)
    assert "matplotlib is not installed" in out
    assert "idx 0 case case0000 mean_dice" in out
    assert "EVAL-OK" in out
