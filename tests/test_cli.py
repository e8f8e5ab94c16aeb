"""CLI integration: run the actual entry-point scripts end-to-end on tiny
synthetic data in a scratch cwd (CPU-forced subprocesses)."""

import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY_CFG = """
MODEL:
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


def run_cli(script, cwd, *argv, timeout=420):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    # Persistent compile cache + XLA O0: these one-shot subprocesses compile
    # full train/eval programs whose speed is irrelevant — only the compile
    # wall time matters, and cached runs skip it entirely.
    env["JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS"] = "0"
    env["JAX_PERSISTENT_CACHE_MIN_ENTRY_SIZE_BYTES"] = "-1"
    env["XLA_FLAGS"] = (
        env.get("XLA_FLAGS", "") + " --xla_backend_optimization_level=0"
    ).strip()
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, script), *argv],
        cwd=cwd, env=env, capture_output=True, text=True, timeout=timeout,
    )
    assert proc.returncode == 0, f"{script} failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}"
    return proc


@pytest.fixture(scope="module")
def workspace(tmp_path_factory):
    """Scratch cwd with synthetic Synapse(9cls) + kits23(4cls) + config."""
    from cswin_unet_tpu.data.synthetic import make_synthetic_dataset

    ws = tmp_path_factory.mktemp("cli_ws")
    cfg = ws / "tiny.yaml"
    cfg.write_text(TINY_CFG)

    # train.py joins root_path + "train_npz" for Synapse, so the synthetic
    # train_npz/ dir already sits where the CLI expects it.
    syn = make_synthetic_dataset(str(ws / "synapse"), num_train_slices=8,
                                 num_volumes=2, size=48, depth=3,
                                 num_classes=9, seed=0)

    kits = make_synthetic_dataset(str(ws / "kits23"), num_train_slices=8,
                                  num_volumes=1, size=48, depth=3,
                                  num_classes=4, seed=1)

    # reference-style list dirs resolved relative to cwd
    lists = ws / "lists"
    for name, src in (
        ("lists_Synapse_blurred", syn["list_dir"]),
        ("lists_Synapse", syn["list_dir"]),
        ("kits23", kits["list_dir"]),
    ):
        d = lists / name
        os.makedirs(d, exist_ok=True)
        for f in ("train.txt", "test_vol.txt"):
            with open(os.path.join(src, f)) as fh:
                (d / f).write_text(fh.read())
    return {
        "ws": str(ws), "cfg": str(cfg),
        "syn_root": str(ws / "synapse"),
        "syn_vols": str(ws / "synapse"),
        "kits_root": kits["train_dir"],
    }


@pytest.fixture(scope="module")
def trained(workspace):
    """Run train.py once; returns its output dir with epoch_0.npz."""
    out = os.path.join(workspace["ws"], "run_train")
    if not os.path.exists(os.path.join(out, "epoch_0.npz")):
        run_cli(
            "train.py", workspace["ws"],
            "--cfg", workspace["cfg"],
            "--root_path", workspace["syn_root"],
            "--dataset", "Synapse",
            "--output_dir", out,
            "--max_epochs", "1",
            "--batch_size", "4",
            "--img_size", "32",
        )
    return out


def test_train_cli(workspace, trained):
    assert os.path.exists(os.path.join(trained, "epoch_0.npz"))
    log = open(os.path.join(trained, "log.txt")).read()
    assert "iteration" in log and "loss" in log


def test_test_cli(workspace, trained):
    out = trained  # checkpoint from train run
    run_cli(
        "test.py", workspace["ws"],
        "--cfg", workspace["cfg"],
        "--volume_path", workspace["syn_vols"],
        "--dataset", "Synapse",
        "--output_dir", out,
        "--max_epochs", "1",
        "--img_size", "32",
        "--is_savenii",
    )
    logf = os.path.join(workspace["ws"], "test_log", "test_log_", "log_Synapse.txt")
    text = open(logf).read()
    assert "mean_dice" in text and "mean_hd95" in text
    assert "Testing performance in best val model" in text
    preds = os.listdir(os.path.join(out, "predictions"))
    assert any(p.endswith("_pred.nii.gz") for p in preds)


@pytest.fixture(scope="module")
def continual_out(workspace, trained):
    pre = os.path.join(trained, "epoch_0.npz")
    out = os.path.join(workspace["ws"], "run_continual")
    run_cli(
        "universal_train.py", workspace["ws"],
        "--cfg", workspace["cfg"],
        "--stage", "1",
        "--root_path", workspace["kits_root"],
        "--list_dir", "./lists/kits23",
        "--dataset", "kits23",
        "--pretrained_path", pre,
        "--output_dir", out,
        "--max_epochs", "1",
        "--batch_size", "4",
        "--img_size", "32",
        "--base_lr", "0.001",
        "--kd_weight", "0.2",
        "--auto_tune", "RGN",
        "--gradient_batches", "1",
        # TPGM itself is covered by tests/test_continual_e2e.py (in-process);
        # disabling it here drops one full fwd+bwd compile from this
        # subprocess, which otherwise times out under CPU contention.
        "--disable_tpgm",
        timeout=900,
    )
    return out


def test_universal_train_cli(workspace, continual_out):
    final = os.path.join(continual_out, "continual_surgical_tpgm_stage1_final.npz")
    assert os.path.exists(final)
    data = np.load(final)
    out_kernel = [k for k in data.files if k.endswith("output/kernel")]
    assert data[out_kernel[0]].shape[-1] == 12  # 9 + 4 - 1


def test_universal_test_cli(workspace, continual_out):
    final_dir = continual_out
    out = os.path.join(workspace["ws"], "run_continual_eval")
    run_cli(
        "universal_test.py", workspace["ws"],
        "--cfg", workspace["cfg"],
        "--volume_path", os.path.join(workspace["ws"], "kits23", "test_vol_h5"),
        "--test_dataset", "kits23",
        "--model_path", final_dir,       # directory glob discovery
        "--list_dir", "./lists/kits23",
        "--output_dir", out,
        "--img_size", "32",
    )
    text = open(os.path.join(out, "test_kits23.txt")).read()
    assert "mean_dice" in text
