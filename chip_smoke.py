#!/usr/bin/env python
"""Smoke run of CSWin-UNet's main path on an NVIDIA GPU.

    python chip_smoke.py [--seed N]        one GPU: all phases below
    python chip_smoke.py --four [--seed N] four GPUs: data-parallel train
                                           step and eval against one GPU

Phases on one GPU, in order; the first failure ends the run with a
non-zero exit code:

  device   the GPU JAX sees, the card's name and power limit (nvidia-smi),
           versions, XLA_FLAGS and the compile-cache directory;
  forward  tiny-224 (configs/cswin_tiny_224_lite.yaml) at full width, bs 8:
           bf16 logits against f32 at matmul precision "highest"; GPU f32
           against the CPU backend's f32 at depth (1,1,1,1); base-384
           (configs/cswin_base_384.yaml) forward at bs 32; memory analysis
           of the tiny train step and the base forward;
  train    ``trainer_synapse`` on synthetic 224² Synapse slices at the
           recipe's bs 24: loss finite and falling, checkpoints re-load;
  eval     ``VolumeInferencer`` + ``inference()`` on two synthetic 512²
           volumes with the trained checkpoint; device metrics (plain-jnp
           EDT) against the host metrics on the same predictions;
  rates    one reading each of bench.py's three metrics.

The last line of stdout is the JSON result
``{"ok": true, "device": {"platform": ..., "kind": ..., "count": ...}}``.
Everything runs in this one process: a second JAX process on the card
would find most of its memory already reserved.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import logging
import os
import re
import subprocess
import sys
import tempfile
import time
from types import SimpleNamespace

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import bench  # noqa: E402
from cswin_unet_tpu.config import get_config  # noqa: E402
from cswin_unet_tpu.utils.compile_cache import enable_compile_cache  # noqa: E402

CONFIGS = os.path.join(REPO, "cswin_unet_tpu", "configs")
TINY_CFG = os.path.join(CONFIGS, "cswin_tiny_224_lite.yaml")
BASE_CFG = os.path.join(CONFIGS, "cswin_base_384.yaml")
NUM_CLASSES = 9

# bf16 activations against the same params in f32 ("highest"), full-width
# tiny-224 at random init. bf16 keeps 8 mantissa bits (2^-9 ≈ 0.2% per
# rounding); over 26 residual blocks, each with ~10 rounded ops, the errors
# add roughly as a random walk, sqrt(260)·0.2% ≈ 3%. The bound leaves 2x.
BF16_REL_L2 = 0.06
BF16_LABEL_AGREE = 0.95
# GPU f32 at "highest" against the CPU backend's f32: the tolerances of
# tests/test_full_model_parity.py::test_full_model_parity_224.
GPU_CPU_RTOL, GPU_CPU_ATOL = 1e-4, 5e-4
# Device metrics (f32) against host metrics (f64) on the same predictions.
DICE_TOL, HD95_TOL = 1e-6, 1e-3
# Four GPUs against one. The train step runs in f32 at "highest", so the
# only difference is the order of the gradient sums (f32 rounding, ~1e-7
# per element); a lost or doubled shard moves the update by O(1). bf16
# would bury that under its own rounding of the per-shard weight gradients
# (measured 2.6e-2 rel L2 between 1 and 4 CPU devices at a tiny width).
# Eval runs the production bf16 forward: per-device batch sizes differ, so
# a near-tie pixel may flip.
FOUR_LOSS_RTOL, FOUR_UPDATE_REL_L2, FOUR_LABEL_AGREE = 1e-5, 1e-3, 0.999


class SmokeFailure(AssertionError):
    """A phase's output is outside its stated bound."""


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    log(("ok   " if ok else "FAIL ") + msg)
    if not ok:
        raise SmokeFailure(msg)


def load_config(path: str):
    return get_config(SimpleNamespace(cfg=path, opts=None))


def memory_line(compiled) -> str:
    m = compiled.memory_analysis()
    if m is None:
        return "unavailable"
    mib = lambda b: f"{b / 2**20:.1f} MiB"  # noqa: E731
    return (f"args {mib(m.argument_size_in_bytes)}, out {mib(m.output_size_in_bytes)}, "
            f"temp {mib(m.temp_size_in_bytes)}, alias {mib(m.alias_size_in_bytes)}, "
            f"code {mib(m.generated_code_size_in_bytes)}")


def synthetic_slices(seed: int, n: int, img: int) -> np.ndarray:
    from cswin_unet_tpu.data.synthetic import make_volume

    image, _ = make_volume(np.random.default_rng(seed), n, img, NUM_CLASSES)
    return image[..., None].astype(np.float32)


def nvidia_smi() -> list[str]:
    """The cards' name and power limit, from a child that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return [line.strip() for line in out.splitlines() if line.strip()]


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_device(count: int) -> dict:
    import jax
    import jaxlib

    dev = bench.require_gpu()
    if dev["device_count"] < count:
        raise SmokeFailure(f"need {count} GPUs, JAX sees {dev['device_count']}")
    for line in nvidia_smi():
        print(line, flush=True)
    log(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}, "
        f"devices {jax.devices()}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache: {jax.config.jax_compilation_cache_dir}")
    return dev


def phase_forward(cfg_path: str, img: int, batch: int, seed: int, *,
                  base_cfg_path: str | None = None, base_img: int = 384,
                  base_batch: int = 32) -> None:
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.models import CSwinUnet, build_model

    config = load_config(cfg_path)
    model16 = build_model(config, img_size=img, num_classes=NUM_CLASSES)
    model32 = build_model(config, img_size=img, num_classes=NUM_CLASSES,
                          dtype=jnp.float32)
    params = model16.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 1)))
    x = jnp.asarray(synthetic_slices(seed, batch, img))

    t0 = time.perf_counter()
    y16 = np.asarray(jax.jit(model16.apply)(params, x))
    with jax.default_matmul_precision("highest"):
        y32 = np.asarray(jax.jit(model32.apply)(params, x))
    rel = float(np.linalg.norm(y16 - y32) / np.linalg.norm(y32))
    agree = float(np.mean(y16.argmax(-1) == y32.argmax(-1)))
    log(f"forward {model16.backbone.embed_dim}-wide depth {model16.backbone.depth} "
        f"img {img} bs {batch}: {time.perf_counter() - t0:.1f}s incl. compile")
    check(bool(np.isfinite(y16).all()) and y16.shape == (batch, img, img, NUM_CLASSES),
          f"bf16 logits finite, shape {y16.shape}")
    check(rel <= BF16_REL_L2, f"bf16 vs f32-highest logits rel L2 {rel:.6f} <= {BF16_REL_L2}")
    check(agree >= BF16_LABEL_AGREE,
          f"bf16 vs f32-highest label agreement {agree:.6f} >= {BF16_LABEL_AGREE}")

    # The default device against the CPU backend, f32, one block per stage.
    shallow = CSwinUnet(backbone=dataclasses.replace(
        model32.backbone, depth=(1, 1, 1, 1)))
    p1 = shallow.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, img, img, 1)))
    x1 = x[:1]
    with jax.default_matmul_precision("highest"):
        y_dev = np.asarray(jax.jit(shallow.apply)(p1, x1))
    cpu = jax.devices("cpu")[0]
    y_cpu = np.asarray(jax.jit(shallow.apply)(jax.device_put(p1, cpu),
                                              jax.device_put(x1, cpu)))
    err = np.abs(y_dev - y_cpu)
    bad = int(np.sum(err > GPU_CPU_ATOL + GPU_CPU_RTOL * np.abs(y_cpu)))
    check(bad == 0, f"{jax.devices()[0].platform} f32-highest vs cpu f32 at depth "
          f"(1,1,1,1): max abs err {float(err.max()):.3e}, {bad} elements outside "
          f"rtol {GPU_CPU_RTOL} atol {GPU_CPU_ATOL}")

    # Memory of the tiny train step (the same program bench.py times).
    step, args = bench.train_setup(model16, batch=24, img=img)
    log(f"tiny train step bs 24 memory: {memory_line(step.lower(*args).compile())}")

    if base_cfg_path is None:
        return
    base = build_model(load_config(base_cfg_path), img_size=base_img,
                       num_classes=NUM_CLASSES)
    pb = base.init(jax.random.PRNGKey(seed), jnp.zeros((1, base_img, base_img, 1)))
    xb = jnp.asarray(synthetic_slices(seed, base_batch, base_img))
    t0 = time.perf_counter()
    compiled = jax.jit(base.apply).lower(pb, xb).compile()
    log(f"base forward bs {base_batch} compiled in {time.perf_counter() - t0:.1f}s, "
        f"memory: {memory_line(compiled)}")
    yb = np.asarray(compiled(pb, xb))
    check(bool(np.isfinite(yb).all())
          and yb.shape == (base_batch, base_img, base_img, NUM_CLASSES),
          f"base-{base_img} logits finite, shape {yb.shape}")


def _losses(log_path: str) -> list[float]:
    pat = re.compile(r"iteration (\d+) : loss : ([-+0-9.eEnaif]+), loss_ce")
    with open(log_path) as f:
        return [float(m.group(2)) for m in map(pat.search, f) if m]


def phase_train(cfg_path: str, workdir: str, seed: int, *, img: int = 224,
                batch: int = 24, n_slices: int = 96, epochs: int = 8):
    """Returns (model, trained params loaded back from the last epoch file)."""
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.data.synthetic import make_synthetic_dataset
    from cswin_unet_tpu.models import build_model
    from cswin_unet_tpu.train import trainer_synapse
    from cswin_unet_tpu.train.trainer import make_optimizer
    from cswin_unet_tpu.utils.checkpoint import (flatten, load_checkpoint,
                                                 merge_matching, restore_train_state,
                                                 unflatten)

    data = make_synthetic_dataset(os.path.join(workdir, "synapse"),
                                  num_train_slices=n_slices, num_volumes=0,
                                  size=img, num_classes=NUM_CLASSES, seed=seed)
    model = build_model(load_config(cfg_path), img_size=img, num_classes=NUM_CLASSES)
    params = model.init(jax.random.PRNGKey(seed), jnp.zeros((1, img, img, 1)))
    template = jax.device_get(params)
    args = SimpleNamespace(
        base_lr=0.01, num_classes=NUM_CLASSES, batch_size=batch, n_gpu=1,
        img_size=img, root_path=data["train_dir"], list_dir=data["list_dir"],
        seed=seed, max_epochs=epochs, num_workers=8, device_augment=False,
        resume=None)
    snap = os.path.join(workdir, "run")
    t0 = time.perf_counter()
    trainer_synapse(args, model, params, snap)
    log(f"trainer_synapse: {time.perf_counter() - t0:.1f}s incl. compile")

    losses = _losses(os.path.join(snap, "log.txt"))
    iters = epochs * (-(-n_slices // batch))
    check(len(losses) == iters, f"{len(losses)} iterations logged, expected {iters}")
    first, last = float(np.mean(losses[:3])), float(np.mean(losses[-3:]))
    check(bool(np.isfinite(losses).all()), "all losses finite")
    check(last < first, f"loss falls: mean of first 3 {first:.6f} > mean of last 3 {last:.6f}")
    stats = jax.devices()[0].memory_stats() or {}
    log(f"peak_bytes_in_use {stats.get('peak_bytes_in_use', 'not reported')}")

    ckpts = sorted(glob.glob(os.path.join(snap, "epoch_*.npz")),
                   key=lambda p: int(re.search(r"epoch_(\d+)", p).group(1)))
    check(bool(ckpts), f"epoch checkpoints written: {[os.path.basename(c) for c in ckpts]}")
    loaded, _ = load_checkpoint(ckpts[-1])
    flat_t, flat_l = flatten(template), flatten(loaded)
    check(set(flat_t) == set(flat_l)
          and all(flat_t[k].shape == flat_l[k].shape for k in flat_t),
          f"{os.path.basename(ckpts[-1])} re-loads: {len(flat_l)} leaves, same shapes")
    opt_template = make_optimizer(args.base_lr, iters).init(template)
    _, _, step = restore_train_state(os.path.join(snap, "train_state"), template,
                                     opt_template)
    check(step == iters, f"train_state re-loads at step {step}")
    return model, unflatten(merge_matching(flat_t, flat_l))


def _host_predictions(inferencer, image, img):
    """The host path of test_single_volume: zoom in, segment, zoom back."""
    from scipy.ndimage import zoom

    d, h, w = image.shape
    slices = np.stack([zoom(s, (img / h, img / w), order=3) for s in image])
    preds = inferencer.predict_slices(slices.astype(np.float32))
    return np.stack([zoom(p, (h / img, w / img), order=0) for p in preds])


def phase_eval(model, params, seed: int, *, img: int = 224, size: int = 512,
               depths=(64, 64)) -> None:
    import jax.numpy as jnp

    from cswin_unet_tpu.data.synthetic import make_volume
    from cswin_unet_tpu.eval import VolumeInferencer, inference
    from cswin_unet_tpu.metrics import volume_metrics
    from cswin_unet_tpu.ops.edt import volume_metrics_device

    logging.basicConfig(level=logging.INFO, stream=sys.stdout,
                        format="%(message)s", force=True)
    rng = np.random.default_rng(seed + 7)
    volumes = [make_volume(rng, d, size, NUM_CLASSES) for d in depths]
    db = [{"image": im, "label": lab, "case_name": f"case{i:04d}"}
          for i, (im, lab) in enumerate(volumes)]
    inferencer = VolumeInferencer(model, params, patch_size=(img, img))
    args = SimpleNamespace(img_size=img, num_classes=NUM_CLASSES, z_spacing=1,
                           device_metrics=False)
    t0 = time.perf_counter()
    dice, hd = inference(args, inferencer, db)
    log(f"inference on {len(db)} volumes: {time.perf_counter() - t0:.1f}s incl. compile")
    check(bool(np.isfinite([dice, hd]).all()), f"mean dice {dice:.6f}, mean hd95 {hd:.6f}")

    for case in db:
        image, label = case["image"], case["label"].astype(np.int32)
        pred = _host_predictions(inferencer, image, img).astype(np.int32)
        # A prediction with every class present, so the HD95 path is exercised
        # whatever the briefly trained model predicts.
        shifted = np.roll(label, (2, -3), axis=(1, 2))
        for name, p in (("model", pred), ("shifted-label", shifted)):
            host = np.asarray(volume_metrics(p, label, NUM_CLASSES), np.float64)
            dev = np.asarray(volume_metrics_device(jnp.asarray(p), jnp.asarray(label),
                                                   NUM_CLASSES), np.float64)
            d_err = float(np.abs(dev[:, 0] - host[:, 0]).max())
            h_err = float(np.abs(dev[:, 1] - host[:, 1]).max())
            check(d_err <= DICE_TOL and h_err <= HD95_TOL,
                  f"{case['case_name']} {name}: device vs host metrics, dice err "
                  f"{d_err:.2e} <= {DICE_TOL}, hd95 err {h_err:.2e} <= {HD95_TOL} "
                  f"(host mean hd95 {host[:, 1].mean():.4f})")


def phase_rates(smi: list[str]) -> None:
    for fn in (bench.bench_infer, bench.bench_train, bench.bench_infer384):
        line = fn()
        log(f"{line['metric']} {line['value']} {line['unit']} on {smi[0]}")


def phase_four(seed: int, *, cfg_path: str = TINY_CFG, img: int = 224,
               batch: int = 96, depth: int = 64, n: int = 4) -> None:
    """Data-parallel train step and eval on an n-device ``data`` mesh against
    the same work on one device."""
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.eval import VolumeInferencer
    from cswin_unet_tpu.models import build_model
    from cswin_unet_tpu.parallel import (batch_sharding, make_mesh, replicate,
                                         replicated_sharding)
    from cswin_unet_tpu.train.trainer import make_optimizer, make_train_step

    config = load_config(cfg_path)
    model = build_model(config, img_size=img, num_classes=NUM_CLASSES)
    model32 = build_model(config, img_size=img, num_classes=NUM_CLASSES,
                          dtype=jnp.float32)
    params = jax.device_get(model.init(jax.random.PRNGKey(seed),
                                                jnp.zeros((1, img, img, 1))))
    optimizer = make_optimizer(0.01, 1000)
    rng = np.random.default_rng(seed)
    image = synthetic_slices(seed, batch, img)
    label = rng.integers(0, NUM_CLASSES, size=(batch, img, img)).astype(np.int32)
    key = jax.random.PRNGKey(seed + 3)

    def one_step(n_dev):
        mesh = make_mesh(n_dev)
        rsh, bsh = replicated_sharding(mesh), batch_sharding(mesh)
        p = replicate(params, rsh)
        s = replicate(optimizer.init(params), rsh)
        step = make_train_step(model32, optimizer, NUM_CLASSES)
        with jax.default_matmul_precision("highest"):
            new_p, _, aux = step(p, s, jax.device_put(image, bsh),
                                 jax.device_put(label, bsh), key)
        return jax.device_get(new_p), float(aux["loss"])

    t0 = time.perf_counter()
    p1, loss1 = one_step(1)
    pn, lossn = one_step(n)
    log(f"f32 train steps at bs {batch} on 1 and {n} devices: "
        f"{time.perf_counter() - t0:.1f}s incl. compile")
    upd1 = np.concatenate([(a - b).ravel() for a, b in
                           zip(jax.tree.leaves(p1), jax.tree.leaves(params))])
    updn = np.concatenate([(a - b).ravel() for a, b in
                           zip(jax.tree.leaves(pn), jax.tree.leaves(params))])
    rel_loss = abs(lossn - loss1) / abs(loss1)
    rel_upd = float(np.linalg.norm(updn - upd1) / np.linalg.norm(upd1))
    check(rel_loss <= FOUR_LOSS_RTOL,
          f"loss {n} devices {lossn:.6f} vs 1 device {loss1:.6f}: rel {rel_loss:.2e} "
          f"<= {FOUR_LOSS_RTOL}")
    check(rel_upd <= FOUR_UPDATE_REL_L2,
          f"param update rel L2 {rel_upd:.2e} <= {FOUR_UPDATE_REL_L2} "
          f"(update norm {np.linalg.norm(upd1):.4e})")

    slices = synthetic_slices(seed + 5, depth, img)[..., 0]
    labels = []
    for dp in (False, True):
        inf = VolumeInferencer(model, p1, patch_size=(img, img), batch_slices=32,
                               data_parallel=dp)
        labels.append(inf.predict_slices(slices))
    agree = float(np.mean(labels[0] == labels[1]))
    check(agree >= FOUR_LABEL_AGREE,
          f"predict_slices {n} devices vs 1 device: label agreement {agree:.6f} "
          f">= {FOUR_LABEL_AGREE}")


# ---------------------------------------------------------------------------

def _keep_cpu_backend() -> None:
    """The forward phase compares with the CPU backend: keep it available
    when JAX_PLATFORMS names only accelerators."""
    import jax

    platforms = os.environ.get("JAX_PLATFORMS") or jax.config.jax_platforms
    if platforms and "cpu" not in platforms.split(","):
        jax.config.update("jax_platforms", platforms + ",cpu")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--four", action="store_true",
                        help="run the 4-GPU data-parallel check only")
    args = parser.parse_args(argv)

    import jax

    enable_compile_cache()
    _keep_cpu_backend()
    t_start = time.perf_counter()
    count = 4 if args.four else 1
    log("phase device")
    dev = phase_device(count)
    smi = nvidia_smi()
    if args.four:
        log("phase four")
        phase_four(args.seed)
    else:
        with tempfile.TemporaryDirectory(prefix="chip_smoke_") as workdir:
            log("phase forward")
            phase_forward(TINY_CFG, 224, 8, args.seed, base_cfg_path=BASE_CFG)
            log("phase train")
            model, params = phase_train(TINY_CFG, workdir, args.seed)
            log("phase eval")
            phase_eval(model, params, args.seed)
        log("phase rates")
        phase_rates(smi)
    log(f"all phases passed in {time.perf_counter() - t_start:.1f}s on {smi[0]}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev["platform"], "kind": dev["device_kind"],
        "count": len(jax.devices())}}), flush=True)
    return 0


def run(argv=None) -> int:
    """``main`` with its expected failures turned into exit code 1."""
    try:
        return main(argv)
    except (bench.NoGpuError, SmokeFailure) as e:
        print(f"chip_smoke.py: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(run())
