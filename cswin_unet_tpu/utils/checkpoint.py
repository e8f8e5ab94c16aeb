"""Checkpointing: flat-numpy pytrees + the reference's checkpoint surgery.

The reference's checkpoint loading is rich (SURVEY.md §5): envelope
unwrapping (``state_dict_ema``/``state_dict``/``model``), encoder→decoder
key mirroring (``stage*`` → ``stage_up*``, vision_transformer.py:60-63),
shape-mismatch dropping (:64-68), ``module.``/``base_model.`` prefix
stripping (universal_test.py:206-218), classifier-row expansion
(universal_train.py:302-344), and head-shape task autodetection
(universal_test.py:140-182). All of it is reproduced here as pure pytree
transforms.

On-disk format: ``.npz`` of '/'-joined flat keys (portable, no pickle).
PyTorch ``.pth`` checkpoints (from the reference) are importable when torch
is present; layout conversion (OIHW→HWIO, Linear transposes) happens in
``torch_to_jax``.
"""

from __future__ import annotations

import math
import os
import re
from typing import Callable

import jax
import numpy as np

SEP = "/"


# ---------------------------------------------------------------------------
# flat <-> nested
# ---------------------------------------------------------------------------

def flatten(tree: dict, prefix: str = "") -> dict[str, np.ndarray]:
    """'/'-joined flat dict. Leaves pass through unchanged (works on numpy
    arrays AND jax tracers — callers needing numpy convert themselves)."""
    out = {}
    for k, v in tree.items():
        key = f"{prefix}{SEP}{k}" if prefix else str(k)
        if isinstance(v, dict):
            out.update(flatten(v, key))
        else:
            out[key] = v
    return out


def unflatten(flat: dict[str, np.ndarray]) -> dict:
    tree: dict = {}
    for key, v in flat.items():
        parts = key.split(SEP)
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_checkpoint(path: str, params, extra: dict | None = None) -> None:
    flat = {k: np.asarray(v) for k, v in flatten(jax.device_get(params)).items()}
    if extra:
        flat.update({f"__extra__{SEP}{k}": np.asarray(v) for k, v in extra.items()})
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    np.savez(path if path.endswith(".npz") else path + ".npz", **flat)


def load_checkpoint(path: str) -> tuple[dict, dict]:
    """Returns (params_tree, extra)."""
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        path = path + ".npz"
    data = np.load(path)
    flat, extra = {}, {}
    for k in data.files:
        if k.startswith(f"__extra__{SEP}"):
            extra[k.split(SEP, 1)[1]] = data[k]
        else:
            flat[k] = data[k]
    return unflatten(flat), extra


# ---------------------------------------------------------------------------
# full train-state checkpointing (params + optimizer state + step)
# ---------------------------------------------------------------------------
# The reference cannot resume optimizer state (TRAIN.AUTO_RESUME/MODEL.RESUME
# are dead config, SURVEY.md §5); here resume is first-class. A train-state
# directory holds one ``state.npz`` with ``params/...``, ``opt_state/...``
# (optax states keyed by their tree paths) and ``step``; restore reads it back
# into the caller's templates.

def _state_file(path: str) -> str:
    return os.path.join(os.path.abspath(path), "state.npz")


def _keyed(tree) -> dict[str, np.ndarray]:
    leaves = jax.tree_util.tree_flatten_with_path(jax.device_get(tree))[0]
    return {jax.tree_util.keystr(k, simple=True, separator=SEP): np.asarray(v)
            for k, v in leaves}


def save_train_state(path: str, params, opt_state, step: int) -> None:
    """Write params, optimizer state and step to ``<path>/state.npz``."""
    flat = {f"params{SEP}{k}": v for k, v in flatten(jax.device_get(params)).items()}
    flat.update({f"opt_state{SEP}{k}": v for k, v in _keyed(opt_state).items()})
    flat["step"] = np.asarray(step, np.int64)
    file = _state_file(path)
    os.makedirs(os.path.dirname(file), exist_ok=True)
    np.savez(file, **{k: np.asarray(v) for k, v in flat.items()})


def restore_train_state(path: str, params_template, opt_state_template):
    """Restore (params, opt_state, step) into the given pytree structures.
    Every template leaf must be present in the file with the same shape."""
    with np.load(_state_file(path)) as data:
        stored = {k: data[k] for k in data.files}

    def take(prefix, key, like):
        name = f"{prefix}{SEP}{key}"
        if name not in stored:
            raise KeyError(f"train state at {path} has no entry {name!r}")
        value = stored[name]
        if value.shape != np.shape(like):
            raise ValueError(f"{name}: stored shape {value.shape} != {np.shape(like)}")
        return value.astype(np.asarray(like).dtype)

    params = unflatten({k: take("params", k, v)
                        for k, v in flatten(jax.device_get(params_template)).items()})
    leaves, treedef = jax.tree_util.tree_flatten_with_path(
        jax.device_get(opt_state_template))
    opt_state = jax.tree_util.tree_unflatten(treedef, [
        take("opt_state", jax.tree_util.keystr(k, simple=True, separator=SEP), v)
        for k, v in leaves])
    return params, opt_state, int(stored["step"])


# ---------------------------------------------------------------------------
# torch state_dict import
# ---------------------------------------------------------------------------

def strip_prefixes(state: dict, prefixes=("module.", "base_model.")) -> dict:
    """Reference universal_test.py:206-218."""
    out = {}
    for k, v in state.items():
        for p in prefixes:
            if k.startswith(p):
                k = k[len(p):]
        out[k] = v
    return out


def unwrap_envelope(ckpt: dict) -> dict:
    """Reference vision_transformer.py:52-57."""
    for key in ("state_dict_ema", "state_dict", "model"):
        if key in ckpt and isinstance(ckpt[key], dict):
            return ckpt[key]
    return ckpt


_CONV_T = (2, 3, 1, 0)  # OIHW -> HWIO


def torch_to_jax(state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Map a reference backbone state_dict (flat torch keys, numpy values)
    to this framework's flat param keys with layout conversion.

    Handles keys relative to the backbone (``CSWinTransformer``); callers
    strip ``cswin_unet.`` / ``module.`` / ``base_model.`` prefixes first.
    """
    out: dict[str, np.ndarray] = {}
    for key, val in state.items():
        val = np.asarray(val)
        m = re.match(r"stage1_conv_embed\.(\d)\.(weight|bias)", key)
        if m:
            idx, wb = m.group(1), m.group(2)
            if idx == "0":
                out[f"stage1_conv_embed_conv{SEP}" + ("kernel" if wb == "weight" else "bias")] = (
                    val.transpose(_CONV_T) if wb == "weight" else val
                )
            else:  # LayerNorm at index 2
                out[f"stage1_conv_embed_norm{SEP}" + ("scale" if wb == "weight" else "bias")] = val
            continue

        m = re.match(r"(stage_up|stage)(\d)\.(\d+)\.(.+)", key)
        if m:
            pre, s, i, rest = m.groups()
            base = f"{pre}{s}_{i}"
            out.update(_block_param(base, rest, val))
            continue

        m = re.match(r"merge(\d)\.(conv|norm)\.(weight|bias)", key)
        if m:
            s, mod, wb = m.groups()
            if mod == "conv":
                out[f"merge{s}{SEP}conv{SEP}" + ("kernel" if wb == "weight" else "bias")] = (
                    val.transpose(_CONV_T) if wb == "weight" else val
                )
            else:
                out[f"merge{s}{SEP}norm{SEP}" + ("scale" if wb == "weight" else "bias")] = val
            continue

        m = re.match(r"upsample(\d)\.(down|encoder|out)\.(weight|bias)", key)
        if m:
            s, mod, wb = m.groups()
            name = f"{mod}_kernel" if wb == "weight" else f"{mod}_bias"
            out[f"upsample{s}{SEP}{name}"] = (
                val.transpose(_CONV_T) if wb == "weight" else val
            )
            continue

        m = re.match(r"concat_linear(\d)\.(weight|bias)", key)
        if m:
            s, wb = m.groups()
            out[f"concat_linear{s}{SEP}" + ("kernel" if wb == "weight" else "bias")] = (
                val.T if wb == "weight" else val
            )
            continue

        m = re.match(r"(norm_up|norm)\.(weight|bias)", key)
        if m:
            mod, wb = m.groups()
            out[f"{mod}{SEP}" + ("scale" if wb == "weight" else "bias")] = val
            continue

        if key == "output.weight":
            out[f"output{SEP}kernel"] = val.transpose(_CONV_T)
            continue
        # Unknown keys are dropped (matches strict=False load semantics).
    return out


def _block_param(base: str, rest: str, val: np.ndarray) -> dict[str, np.ndarray]:
    out = {}
    m = re.match(r"(qkv|proj)\.(weight|bias)", rest)
    if m:
        mod, wb = m.groups()
        out[f"{base}{SEP}{mod}{SEP}" + ("kernel" if wb == "weight" else "bias")] = (
            val.T if wb == "weight" else val
        )
        return out
    m = re.match(r"(norm1|norm2)\.(weight|bias)", rest)
    if m:
        mod, wb = m.groups()
        out[f"{base}{SEP}{mod}{SEP}" + ("scale" if wb == "weight" else "bias")] = val
        return out
    m = re.match(r"mlp\.(fc1|fc2)\.(weight|bias)", rest)
    if m:
        mod, wb = m.groups()
        out[f"{base}{SEP}mlp{SEP}{mod}{SEP}" + ("kernel" if wb == "weight" else "bias")] = (
            val.T if wb == "weight" else val
        )
        return out
    m = re.match(r"attns\.(\d)\.get_v\.(weight|bias)", rest)
    if m:
        j, wb = m.groups()
        name = "get_v_kernel" if wb == "weight" else "get_v_bias"
        out[f"{base}{SEP}attns_{j}{SEP}{name}"] = (
            val.transpose(_CONV_T) if wb == "weight" else val
        )
        return out
    return out


def load_torch_state_dict(path: str) -> dict[str, np.ndarray]:
    import torch

    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    state = unwrap_envelope(ckpt)
    return {k: v.numpy() if hasattr(v, "numpy") else np.asarray(v) for k, v in state.items()}


# ---------------------------------------------------------------------------
# surgery
# ---------------------------------------------------------------------------

def mirror_encoder_to_decoder(flat: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """Add ``stage_up*`` copies of every encoder ``stage*`` entry that lacks
    one (reference vision_transformer.py:60-63: pretrained encoder weights
    initialize the mirrored decoder stages)."""
    out = dict(flat)
    for k, v in flat.items():
        if k.startswith("stage") and not k.startswith("stage_up") and not k.startswith(
            "stage1_conv_embed"
        ):
            up_key = "stage_up" + k[len("stage"):]
            out.setdefault(up_key, v)
    return out


def merge_matching(template_flat: dict, incoming: dict, log: Callable = print) -> dict:
    """Overlay incoming onto template, dropping shape mismatches
    (reference vision_transformer.py:64-68) and unknown keys."""
    out = dict(template_flat)
    for k, v in incoming.items():
        if k in out:
            if out[k].shape == v.shape:
                out[k] = v.astype(out[k].dtype)
            else:
                log(f"delete:{k};shape pretrain:{v.shape};shape model:{out[k].shape}")
    return out


def load_from_pretrained(params, ckpt_path: str, log: Callable = print):
    """Full ``load_from`` semantics (vision_transformer.py:45-72) onto a
    params tree ``{'params': {'backbone': ...}}`` or a bare backbone tree."""
    if ckpt_path.endswith(".npz") or os.path.exists(ckpt_path + ".npz"):
        loaded, _ = load_checkpoint(ckpt_path)
        incoming = flatten(_backbone_of(loaded))
    else:
        state = strip_prefixes(load_torch_state_dict(ckpt_path))
        state = {k[len("cswin_unet."):] if k.startswith("cswin_unet.") else k: v for k, v in state.items()}
        incoming = torch_to_jax(state)
    incoming = mirror_encoder_to_decoder(incoming)

    tree = jax.device_get(params)
    backbone = _backbone_of(tree)
    merged = unflatten(merge_matching(flatten(backbone), incoming, log))
    return _with_backbone(tree, merged)


def _backbone_of(tree: dict) -> dict:
    node = tree
    if "params" in node:
        node = node["params"]
    if "backbone" in node:
        node = node["backbone"]
    return node


def _with_backbone(tree: dict, new_backbone: dict) -> dict:
    if "params" in tree:
        inner = dict(tree["params"])
        if "backbone" in inner:
            inner["backbone"] = new_backbone
            return {**tree, "params": inner}
        return {**tree, "params": new_backbone}
    return new_backbone


# ---------------------------------------------------------------------------
# classifier expansion (continual learning)
# ---------------------------------------------------------------------------

def expand_classifier(params, num_classes_total: int, seed: int = 0):
    """Expand the final 1x1 ``output`` conv from C_old to C_total classes,
    keeping old rows and kaiming-normal-initializing the new ones
    (reference universal_train.py:302-344; the layer has no bias)."""
    tree = jax.device_get(params)
    backbone = _backbone_of(tree)
    flat = flatten(backbone)
    key = f"output{SEP}kernel"
    old = flat[key]  # (1, 1, C_in, C_old)
    c_in, c_old = old.shape[2], old.shape[3]
    if num_classes_total <= c_old:
        raise ValueError(f"cannot expand {c_old} -> {num_classes_total}")
    rng = np.random.default_rng(seed)
    # kaiming_normal (fan_in mode over torch OIHW rows): std = sqrt(2/fan_in),
    # fan_in = C_in * kh * kw.
    std = math.sqrt(2.0 / c_in)
    new_rows = rng.normal(0.0, std, (1, 1, c_in, num_classes_total - c_old)).astype(
        old.dtype
    )
    flat[key] = np.concatenate([old, new_rows], axis=-1)
    return _with_backbone(tree, unflatten(flat))


def detect_num_classes(path: str) -> int:
    """Head-shape autodetection (reference universal_test.py:140-182)."""
    if path.endswith(".npz") or os.path.exists(path + ".npz"):
        loaded, _ = load_checkpoint(path)
        flat = flatten(_backbone_of(loaded))
        return int(flat[f"output{SEP}kernel"].shape[-1])
    state = strip_prefixes(load_torch_state_dict(path))
    for k, v in state.items():
        if "output" in k and k.endswith("weight") and np.asarray(v).ndim == 4:
            return int(np.asarray(v).shape[0])
    raise RuntimeError("Could not detect number of classes from checkpoint")


def find_checkpoint(model_path: str) -> str:
    """File or directory glob fallback (reference universal_test.py:185-203)."""
    if os.path.isfile(model_path):
        return model_path
    if os.path.isdir(model_path):
        import glob

        for pattern in ("*_final.npz", "*_final.pth", "task*_final.pth", "*_epoch_*.npz", "*_epoch_*.pth", "epoch_*.npz"):
            files = glob.glob(os.path.join(model_path, pattern))
            if files:
                return max(files, key=os.path.getctime)
    raise FileNotFoundError(f"Could not find checkpoint at {model_path}")
