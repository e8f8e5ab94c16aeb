#!/usr/bin/env python
"""Benchmark on an NVIDIA GPU. Prints one JSON line per metric:

  {"metric": "slices_per_sec_per_chip", ...}        tiny-224 eval forward, bs 128
  {"metric": "train_samples_per_sec_per_chip", ...} tiny-224 train step at the
                                                    reference recipe (bs 24,
                                                    SGD poly, 0.4CE+0.6Dice)
  {"metric": "slices384_per_sec_per_chip", ...}     base-384 eval forward, bs 32

Every line names the device it ran on (``platform``, ``device_kind``,
``device_count``). The script refuses to run when JAX finds no GPU, and any
failed phase makes it exit non-zero.

Method: one jitted step is dispatched ``n_a`` and then ``n_b`` times in a
row from Python and the device is waited on once per run; per-step time is
(t_b − t_a) / (n_b − n_a), which cancels the fixed cost of the final sync.
Compilation and a warm-up run come first and are not timed.

Baseline note: the reference repo records NO throughput anywhere (SURVEY.md
§6); its inference runs batch-size-1, one slice per forward (utils.py:70-74).
BASELINE is an estimate of that pipeline on an A100: a ~25 GFLOP forward at
bs=1 is launch/overhead-bound at ~15-20 ms/slice => 60 slices/s (ESTIMATE,
not a measurement — vs_baseline is quoted against it). The train baseline is
the reference recipe's measured-class A100 bs-24 step (~1.4 it/s => ~34
samples/s, same-class estimate).

Usage: ``python bench.py [all|infer|train|infer384]`` (default ``all``).
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

A100_BS1_BASELINE = 60.0  # slices/s, estimated reference pipeline (see above)
A100_TRAIN_BASELINE = 34.0  # samples/s, estimated reference bs-24 train step

# Every emitted vs_baseline is quoted against the ESTIMATES above — the
# reference records no throughput anywhere (SURVEY.md §6). The label rides
# in each JSON line so the artifact cannot be read as a measured ratio.
BASELINE_LABEL = "estimated-a100 (reference records no throughput)"


class NoGpuError(RuntimeError):
    """JAX found no GPU: a measurement here would not be a device number."""


def device_fields() -> dict:
    """The device every metric line names."""
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": jax.device_count()}


def require_gpu() -> dict:
    """Return ``device_fields()``; raise ``NoGpuError`` unless the default
    device is a GPU."""
    fields = device_fields()
    if fields["platform"] != "gpu":
        raise NoGpuError(f"no GPU: JAX's default device is {fields['platform']}")
    return fields


def _emit(obj):
    print(json.dumps(obj), flush=True)
    return obj


def tiny_model():
    """configs/cswin_tiny_224_lite.yaml at full width, bf16 activations."""
    import jax.numpy as jnp

    from cswin_unet_tpu.models import CSWinUNet, CSwinUnet

    return CSwinUnet(backbone=CSWinUNet(
        img_size=224, num_classes=9, embed_dim=64, depth=(1, 2, 9, 1),
        split_size=(1, 2, 7, 7), num_heads=(2, 4, 8, 16),
        drop_path_rate=0.2, dtype=jnp.bfloat16))


def base384_model():
    """configs/cswin_base_384.yaml at full width (stage resos 96/48/24/12)."""
    import jax.numpy as jnp

    from cswin_unet_tpu.models import CSWinUNet, CSwinUnet

    return CSwinUnet(backbone=CSWinUNet(
        img_size=384, num_classes=9, embed_dim=96, depth=(2, 4, 32, 2),
        split_size=(1, 2, 12, 12), num_heads=(4, 8, 16, 32),
        drop_path_rate=0.5, dtype=jnp.bfloat16))


def _per_step(run, n_a, n_b, repeats=3):
    """Seconds per step from the difference of two run lengths (best of
    ``repeats`` each)."""
    def best(n):
        times = []
        for _ in range(repeats):
            t0 = time.perf_counter()
            run(n)
            times.append(time.perf_counter() - t0)
        return min(times)

    return (best(n_b) - best(n_a)) / (n_b - n_a)


def bench_infer(batch=128, n_a=10, n_b=30, img=224,
                metric="slices_per_sec_per_chip", baseline=A100_BS1_BASELINE,
                model_fn=tiny_model):
    """Eval forward (per-pixel labels, what test_single_volume runs)."""
    import jax
    import jax.numpy as jnp

    dev = require_gpu()
    model = model_fn()
    params = jax.device_put(model.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 1))))
    fwd = jax.jit(lambda p, x: model.apply(p, x, emit="labels"))
    x = jnp.asarray(
        np.random.default_rng(0).normal(size=(batch, img, img, 1)).astype(np.float32))

    def run(n):
        out = None
        for _ in range(n):
            out = fwd(params, x)
        jax.block_until_ready(out)

    t0 = time.perf_counter()
    run(1)  # compile
    compile_s = time.perf_counter() - t0
    run(2)  # warm-up
    per_fwd = _per_step(run, n_a, n_b)
    value = batch / per_fwd
    return _emit({
        "metric": metric, "value": value, "unit": "slices/s",
        "batch": batch, "step_ms": per_fwd * 1e3, "compile_s": compile_s,
        "vs_baseline": value / baseline, "baseline": BASELINE_LABEL, **dev,
    })


def train_setup(model, batch=24, img=224):
    """The timed train step and its arguments: fwd+bwd+SGD update with
    drop-path live, at the reference recipe (trainer.py:42,61-63: SGD
    momentum 0.9, poly), built by the trainer's own ``make_train_step``.
    Returns (jitted step, (params, opt_state, image, label, rng))."""
    import jax
    import jax.numpy as jnp

    from cswin_unet_tpu.train.trainer import make_optimizer, make_train_step

    params = jax.device_put(model.init(jax.random.PRNGKey(0), jnp.zeros((1, img, img, 1))))
    optimizer = make_optimizer(0.05, 10_000)
    opt_state = optimizer.init(params)
    rng = np.random.default_rng(0)
    image = jnp.asarray(rng.normal(size=(batch, img, img, 1)).astype(np.float32))
    label = jnp.asarray(rng.integers(0, 9, size=(batch, img, img)).astype(np.int32))
    step = make_train_step(model, optimizer, 9)
    return step, (params, opt_state, image, label, jax.random.PRNGKey(0))


def bench_train(batch=24, n_a=5, n_b=15):
    """Tiny-224 train step at the reference recipe, bs 24 (``train_setup``)."""
    import jax

    dev = require_gpu()
    step, (params, opt_state, image, label, key) = train_setup(tiny_model(), batch)
    state = [params, opt_state]

    def run(n):
        aux = None
        for i in range(n):
            # the step donates params/opt_state: carry the new ones forward
            state[0], state[1], aux = step(state[0], state[1], image, label,
                                           jax.random.fold_in(key, i))
        jax.block_until_ready(aux["loss"])

    t0 = time.perf_counter()
    run(1)  # compile
    compile_s = time.perf_counter() - t0
    run(2)  # warm-up
    per_step = _per_step(run, n_a, n_b)
    value = batch / per_step
    return _emit({
        "metric": "train_samples_per_sec_per_chip", "value": value,
        "unit": "samples/s", "batch": batch, "step_ms": per_step * 1e3,
        "compile_s": compile_s, "vs_baseline": value / A100_TRAIN_BASELINE,
        "baseline": BASELINE_LABEL, **dev,
    })


def bench_infer384(batch=32, n_a=5, n_b=15):
    return bench_infer(
        batch=batch, n_a=n_a, n_b=n_b, img=384,
        metric="slices384_per_sec_per_chip",
        baseline=A100_BS1_BASELINE / 4.0,  # ~9.4x FLOPs, bs1 A100 est.
        model_fn=base384_model)


PHASES = {
    "infer": bench_infer,
    "train": bench_train,
    "infer384": bench_infer384,
}


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    mode = args[0] if args else "all"
    if mode != "all" and mode not in PHASES:
        print(f"usage: bench.py [all|{'|'.join(PHASES)}]", file=sys.stderr)
        return 2

    from cswin_unet_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    require_gpu()
    for name in (PHASES if mode == "all" else [mode]):
        PHASES[name]()
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except NoGpuError as e:
        print(f"bench.py: {e}", file=sys.stderr)
        sys.exit(1)
