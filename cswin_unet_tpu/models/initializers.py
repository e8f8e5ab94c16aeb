"""Weight initializers matching the reference's effective init scheme.

The reference initializes Linear weights with timm trunc_normal(std=0.02) and
zero bias, LayerNorm to (1, 0) (``networks/cswin_unet.py:444-451``), and —
because ``_init_weights`` does not touch ``nn.Conv2d`` — leaves convolutions
at the PyTorch default (kaiming_uniform(a=√5) kernel and U(±1/√fan_in) bias,
i.e. both U(-1/√fan_in, 1/√fan_in)).

A model describes its parameters as a tree of ``Param`` leaves;
``init_params`` draws the whole tree from two random vectors (one truncated
normal, one uniform) cut into leaves, on the host CPU: a program with one
output per leaf (1,323 for base-384) took XLA:GPU over 14 minutes to compile,
XLA:CPU seconds. Callers get ordinary arrays and move them where they are
used; do not wrap ``init`` in ``jax.jit``, which would compile it for the
accelerator again.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

# std of a standard normal truncated to [-2, 2]: dividing by it makes the
# truncated draw's std the requested one (as jax.nn.initializers does).
_TRUNC_STD = 0.87962566103423978


@dataclasses.dataclass(frozen=True)
class Param:
    """Leaf of a parameter spec tree. ``kind`` is "normal" (truncated at
    ±2σ, σ = ``scale``), "uniform" (U(±``scale``)), "ones" or "zeros"."""

    shape: tuple
    kind: str
    scale: float = 0.0


def trunc_normal(shape, std: float = 0.02) -> Param:
    return Param(tuple(shape), "normal", std)


def torch_conv_kernel(shape) -> Param:
    """PyTorch Conv2d default kernel init, HWIO: U(±1/√fan_in) with fan_in =
    kh·kw·(in_channels / groups)."""
    return Param(tuple(shape), "uniform", 1.0 / math.sqrt(math.prod(shape[:-1])))


def torch_conv_bias(shape, fan_in: int) -> Param:
    """PyTorch Conv2d default bias init for a conv with the given fan_in."""
    return Param(tuple(shape), "uniform", 1.0 / math.sqrt(fan_in))


def ones(shape) -> Param:
    return Param(tuple(shape), "ones")


def zeros(shape) -> Param:
    return Param(tuple(shape), "zeros")


def init_params(spec, rng):
    """Draw a tree of f32 arrays shaped like the ``Param`` tree ``spec``,
    computed on the host CPU when JAX has that backend."""
    leaves, treedef = jax.tree.flatten(spec, is_leaf=lambda x: isinstance(x, Param))
    try:
        host = jax.default_device(jax.devices("cpu")[0])
    except RuntimeError:  # JAX_PLATFORMS left out the CPU backend
        host = contextlib.nullcontext()
    with host:
        return jax.tree.unflatten(treedef, _draw(tuple(leaves), rng))


@functools.partial(jax.jit, static_argnums=0)
def _draw(leaves, rng):
    k_normal, k_uniform = jax.random.split(rng)

    def pieces(kind, sample):
        sizes = [math.prod(p.shape) for p in leaves if p.kind == kind]
        if not sizes:
            return iter(())
        flat = sample(sum(sizes))
        return iter(jnp.split(flat, np.cumsum(sizes)[:-1]))

    normal = pieces("normal", lambda n: jax.random.truncated_normal(
        k_normal, -2.0, 2.0, (n,), jnp.float32) / _TRUNC_STD)
    uniform = pieces("uniform", lambda n: jax.random.uniform(
        k_uniform, (n,), jnp.float32, -1.0, 1.0))
    out = []
    for p in leaves:
        if p.kind == "normal":
            v = next(normal) * p.scale
        elif p.kind == "uniform":
            v = next(uniform) * p.scale
        elif p.kind == "ones":
            v = jnp.ones(p.shape, jnp.float32)
        else:
            v = jnp.zeros(p.shape, jnp.float32)
        out.append(v.reshape(p.shape))
    return out
