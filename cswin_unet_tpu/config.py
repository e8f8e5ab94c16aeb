"""Hierarchical frozen config system.

Re-creates the config *surface* of the reference (yacs ``CfgNode`` with
recursive ``BASE`` YAML inheritance, ``--opts KEY VALUE`` merging and CLI
overrides — reference ``config.py:170-224``) without the yacs dependency.
Keys and defaults match the reference so YAML files and command lines are
interchangeable between the two frameworks.

Config files are read by ``load_yaml``, a reader for the YAML subset the
configs use (see its docstring) — no PyYAML needed.
"""

from __future__ import annotations

import ast
import copy
import os
import re
from typing import Any, Iterable


# ---------------------------------------------------------------------------
# YAML subset reader
# ---------------------------------------------------------------------------

class YamlSubsetError(ValueError):
    """A construct outside the supported YAML subset, with file and line."""


# YAML 1.1 scalar resolution (what PyYAML's safe_load applies to plain
# scalars); quoted scalars are always strings.
_NULL = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE", "yes", "Yes", "YES", "on", "On", "ON"}
_FALSE = {"false", "False", "FALSE", "no", "No", "NO", "off", "Off", "OFF"}
_INT = re.compile(r"[-+]?(0|[1-9][0-9_]*)$")
_FLOAT = re.compile(r"[-+]?([0-9][0-9_]*)?\.[0-9_]*([eE][-+][0-9]+)?$")
_INF = re.compile(r"[-+]?\.(inf|Inf|INF)$")
_NAN = re.compile(r"\.(nan|NaN|NAN)$")
_UNSUPPORTED = tuple("&*!|>{%@`")


def _strip_comment(text: str) -> str:
    """Drop a trailing `` #`` comment that is outside quotes."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


def _split_flow(body: str, where: str) -> list[str]:
    """Split the inside of ``[...]`` on top-level commas."""
    items, cur, quote = [], "", None
    for ch in body:
        if quote:
            cur += ch
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
            cur += ch
        elif ch in "[]{}":
            raise YamlSubsetError(f"{where}: nested flow collections are not supported")
        elif ch == ",":
            items.append(cur.strip())
            cur = ""
        else:
            cur += ch
    if cur.strip():
        items.append(cur.strip())
    elif items:
        raise YamlSubsetError(f"{where}: empty item in flow list")
    return items


def _scalar(text: str, where: str) -> Any:
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise YamlSubsetError(f"{where}: unterminated flow list")
        return [_scalar(t, where) for t in _split_flow(text[1:-1], where)]
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        body = text[1:-1]
        if text[0] == "'":
            return body.replace("''", "'")
        if "\\" in body:
            raise YamlSubsetError(f"{where}: escapes in double-quoted strings are not supported")
        return body
    if text[:1] in _UNSUPPORTED or text[:1] in "'\"":
        raise YamlSubsetError(f"{where}: unsupported scalar {text!r}")
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) and any(c.isdigit() for c in text):
        return float(text.replace("_", ""))
    if _INF.match(text):
        return float("-inf") if text.startswith("-") else float("inf")
    if _NAN.match(text):
        return float("nan")
    return text


def load_yaml(path: str) -> dict:
    """Parse a config file written in the YAML subset the configs use.

    Supported: block mappings nested by indentation, block lists
    (``- item``) of scalars, inline lists of scalars (``[1, 2]``), plain,
    single- and double-quoted scalars resolved as PyYAML's ``safe_load``
    resolves them (YAML 1.1 bools, nulls, ints, floats), and ``#``
    comments. Anything else (anchors, tags, flow mappings, block scalars,
    multiple documents, tabs) raises ``YamlSubsetError`` naming the file and
    line.
    """
    with open(path) as f:
        lines = f.read().splitlines()
    rows = []  # (indent, text, where)
    for n, raw in enumerate(lines, 1):
        where = f"{path}:{n}"
        if "\t" in raw[: len(raw) - len(raw.lstrip())]:
            raise YamlSubsetError(f"{where}: tab indentation is not supported")
        text = _strip_comment(raw)
        if not text.strip():
            continue
        if text.strip() in ("---", "...") or text.startswith("%"):
            raise YamlSubsetError(f"{where}: document markers are not supported")
        rows.append((len(text) - len(text.lstrip()), text.strip(), where))

    def block(i, indent):
        """Parse the block starting at rows[i] with this indent."""
        if rows[i][1].startswith("- ") or rows[i][1] == "-":
            out, is_list = [], True
        else:
            out, is_list = {}, False
        while i < len(rows):
            ind, text, where = rows[i]
            if ind < indent:
                break
            if ind > indent:
                raise YamlSubsetError(f"{where}: unexpected indentation")
            if is_list:
                if not (text.startswith("- ") or text == "-"):
                    raise YamlSubsetError(f"{where}: expected a list item")
                item = text[1:].strip()
                if ":" in item and not item.startswith(("[", "'", '"')):
                    raise YamlSubsetError(f"{where}: mappings inside lists are not supported")
                out.append(_scalar(item, where))
                i += 1
                continue
            key, sep, rest = text.partition(":")
            if not sep or (rest and not rest.startswith(" ")):
                raise YamlSubsetError(f"{where}: expected 'key: value'")
            key = key.strip()
            if not key or key[0] in _UNSUPPORTED or key[0] in "-[":
                raise YamlSubsetError(f"{where}: unsupported key {key!r}")
            if key in out:
                raise YamlSubsetError(f"{where}: duplicate key {key!r}")
            rest = rest.strip()
            i += 1
            if rest:
                out[key] = _scalar(rest, where)
            elif i < len(rows) and (rows[i][0] > ind or (
                    rows[i][0] == ind and rows[i][1].startswith("-"))):
                out[key], i = block(i, rows[i][0])
            else:
                out[key] = None
        return out, i

    if not rows:
        return {}
    data, i = block(0, rows[0][0])
    if i != len(rows):
        raise YamlSubsetError(f"{rows[i][2]}: unexpected dedent")
    if not isinstance(data, dict):
        raise YamlSubsetError(f"{path}: top level must be a mapping")
    return data


class CfgNode(dict):
    """A dict with attribute access, freezing, and recursive merge."""

    _FROZEN = "_is_frozen"

    def __init__(self, init: dict | None = None):
        super().__init__()
        object.__setattr__(self, CfgNode._FROZEN, False)
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute access ---------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"CfgNode is frozen; cannot set {name}")
        self[name] = value

    def __setitem__(self, key: str, value: Any) -> None:
        if object.__getattribute__(self, CfgNode._FROZEN):
            raise AttributeError(f"CfgNode is frozen; cannot set {key}")
        super().__setitem__(key, value)

    # -- freeze / defrost ---------------------------------------------------
    def freeze(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, True)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.freeze()

    def defrost(self) -> None:
        object.__setattr__(self, CfgNode._FROZEN, False)
        for v in self.values():
            if isinstance(v, CfgNode):
                v.defrost()

    def is_frozen(self) -> bool:
        return object.__getattribute__(self, CfgNode._FROZEN)

    # -- merging ------------------------------------------------------------
    def merge_from_dict(self, other: dict) -> None:
        for k, v in other.items():
            if isinstance(v, dict) and isinstance(self.get(k), CfgNode):
                self[k].merge_from_dict(v)
            elif isinstance(v, dict):
                self[k] = CfgNode(v)
            else:
                self[k] = _coerce(v, self.get(k))

    def merge_from_file(self, cfg_file: str) -> None:
        data = load_yaml(cfg_file)
        # Recursive BASE inheritance, depth-first (reference config.py:175-179).
        for base in data.pop("BASE", [""]) or [""]:
            if base:
                self.merge_from_file(os.path.join(os.path.dirname(cfg_file), base))
        self.merge_from_dict(data)

    def merge_from_list(self, opts: Iterable[str]) -> None:
        opts = list(opts)
        if len(opts) % 2 != 0:
            raise ValueError(f"--opts must be KEY VALUE pairs, got {opts}")
        for key, value in zip(opts[::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = _coerce(value, node.get(parts[-1]))

    def clone(self) -> "CfgNode":
        c = copy.deepcopy(self)
        c.defrost()
        return c

    def to_dict(self) -> dict:
        return {
            k: v.to_dict() if isinstance(v, CfgNode) else v for k, v in self.items()
        }


def _coerce(value: Any, old: Any) -> Any:
    """Parse string CLI values into python literals where sensible."""
    if not isinstance(value, str):
        return value
    try:
        lit = ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value
    if old is not None and isinstance(old, str):
        return value
    return lit


# ---------------------------------------------------------------------------
# Defaults — same keys/values as reference config.py:6-167 so YAML configs and
# ``--opts`` command lines from the reference work unchanged.
# ---------------------------------------------------------------------------

def default_config() -> CfgNode:
    c = CfgNode()
    c.BASE = [""]

    c.DATA = CfgNode()
    c.DATA.BATCH_SIZE = 128
    c.DATA.DATA_PATH = ""
    c.DATA.DATASET = "imagenet"
    c.DATA.IMG_SIZE = 224
    c.DATA.INTERPOLATION = "bicubic"
    c.DATA.ZIP_MODE = False
    c.DATA.CACHE_MODE = "part"
    c.DATA.PIN_MEMORY = True
    c.DATA.NUM_WORKERS = 8

    c.MODEL = CfgNode()
    c.MODEL.TYPE = "cswin"
    c.MODEL.NAME = "cswin_tiny_224"
    c.MODEL.PRETRAIN_CKPT = "./pretrained_ckpt/cswin_tiny_224.pth"
    c.MODEL.RESUME = ""
    c.MODEL.NUM_CLASSES = 1000
    c.MODEL.DROP_RATE = 0.0
    c.MODEL.DROP_PATH_RATE = 0.1
    c.MODEL.LABEL_SMOOTHING = 0.1

    c.MODEL.CSWIN = CfgNode()
    c.MODEL.CSWIN.PATCH_SIZE = 4
    c.MODEL.CSWIN.IN_CHANS = 3
    c.MODEL.CSWIN.EMBED_DIM = 64
    c.MODEL.CSWIN.DEPTH = [1, 2, 9, 1]
    c.MODEL.CSWIN.NUM_HEADS = [2, 4, 8, 16]
    c.MODEL.CSWIN.SPLIT_SIZE = [1, 2, 7, 7]
    c.MODEL.CSWIN.MLP_RATIO = 4.0
    c.MODEL.CSWIN.QKV_BIAS = True
    c.MODEL.CSWIN.QK_SCALE = None
    c.MODEL.CSWIN.APE = False
    c.MODEL.CSWIN.PATCH_NORM = True

    c.TRAIN = CfgNode()
    c.TRAIN.START_EPOCH = 0
    c.TRAIN.EPOCHS = 300
    c.TRAIN.WARMUP_EPOCHS = 20
    c.TRAIN.WEIGHT_DECAY = 0.05
    c.TRAIN.BASE_LR = 5e-4
    c.TRAIN.WARMUP_LR = 5e-7
    c.TRAIN.MIN_LR = 5e-6
    c.TRAIN.CLIP_GRAD = 5.0
    c.TRAIN.AUTO_RESUME = True
    c.TRAIN.ACCUMULATION_STEPS = 0
    c.TRAIN.USE_CHECKPOINT = False  # remat (jax.checkpoint) per block

    c.TRAIN.LR_SCHEDULER = CfgNode()
    c.TRAIN.LR_SCHEDULER.NAME = "cosine"
    c.TRAIN.LR_SCHEDULER.DECAY_EPOCHS = 30
    c.TRAIN.LR_SCHEDULER.DECAY_RATE = 0.1

    c.TRAIN.OPTIMIZER = CfgNode()
    c.TRAIN.OPTIMIZER.NAME = "adamw"
    c.TRAIN.OPTIMIZER.EPS = 1e-8
    c.TRAIN.OPTIMIZER.BETAS = (0.9, 0.999)
    c.TRAIN.OPTIMIZER.MOMENTUM = 0.9

    c.AUG = CfgNode()
    c.AUG.COLOR_JITTER = 0.4
    c.AUG.AUTO_AUGMENT = "rand-m9-mstd0.5-inc1"
    c.AUG.REPROB = 0.25
    c.AUG.REMODE = "pixel"
    c.AUG.RECOUNT = 1
    c.AUG.MIXUP = 0.8
    c.AUG.CUTMIX = 1.0
    c.AUG.CUTMIX_MINMAX = None
    c.AUG.MIXUP_PROB = 1.0
    c.AUG.MIXUP_SWITCH_PROB = 0.5
    c.AUG.MIXUP_MODE = "batch"

    c.TEST = CfgNode()
    c.TEST.CROP = True

    c.AMP_OPT_LEVEL = ""
    c.OUTPUT = ""
    c.TAG = "default"
    c.SAVE_FREQ = 1
    c.PRINT_FREQ = 10
    c.SEED = 0
    c.EVAL_MODE = False
    c.THROUGHPUT_MODE = False
    c.LOCAL_RANK = 0

    # --- Extensions absent in the reference ---
    c.DEVICE = CfgNode()
    c.DEVICE.COMPUTE_DTYPE = "bfloat16"  # activation compute dtype
    return c


def update_config(config: CfgNode, args) -> None:
    """Merge file + opts + known CLI args (reference config.py:185-214)."""
    if getattr(args, "cfg", None):
        config.merge_from_file(args.cfg)
    if getattr(args, "opts", None):
        config.merge_from_list(args.opts)
    if getattr(args, "batch_size", None):
        config.DATA.BATCH_SIZE = args.batch_size
    if getattr(args, "zip", False):
        config.DATA.ZIP_MODE = True
    if getattr(args, "cache_mode", None):
        config.DATA.CACHE_MODE = args.cache_mode
    if getattr(args, "resume", None):
        config.MODEL.RESUME = args.resume
    if getattr(args, "accumulation_steps", None):
        config.TRAIN.ACCUMULATION_STEPS = args.accumulation_steps
    if getattr(args, "use_checkpoint", False):
        config.TRAIN.USE_CHECKPOINT = True
    if getattr(args, "amp_opt_level", None):
        config.AMP_OPT_LEVEL = args.amp_opt_level
    if getattr(args, "tag", None):
        config.TAG = args.tag
    if getattr(args, "eval", False):
        config.EVAL_MODE = True
    if getattr(args, "throughput", False):
        config.THROUGHPUT_MODE = True
    config.freeze()


def get_config(args) -> CfgNode:
    """Build the frozen config for a CLI invocation (reference config.py:217-224)."""
    config = default_config()
    update_config(config, args)
    return config
