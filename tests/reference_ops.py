"""Plain numpy oracles for the model's building blocks.

Written from the reference's definitions (networks/cswin_unet.py), one
window, head and tap at a time, with nothing shared with the code under
test: explicit softmax, LePE as a 3x3 depthwise conv with zero padding at
every WINDOW border, CARAFE as unfold + softmax over taps + pixel shuffle.
All arithmetic is float64.
"""

from __future__ import annotations

import math

import numpy as np


def softmax(a, axis=-1):
    a = a - a.max(axis=axis, keepdims=True)
    e = np.exp(a)
    return e / e.sum(axis=axis, keepdims=True)


def depthwise3x3(img, kernel, bias):
    """img (h, w, C); kernel (3, 3, C); zero padding outside ``img``."""
    h, w, _ = img.shape
    pad = np.pad(img, ((1, 1), (1, 1), (0, 0)))
    out = np.zeros_like(img)
    for di in range(3):
        for dj in range(3):
            out += pad[di:di + h, dj:dj + w] * kernel[di, dj]
    return out + bias


def stripe_attention(q, k, v, lepe_kernel, lepe_bias, h_sp, w_sp, heads, scale):
    """One CSWin branch. q, k, v (B, H, W, C); lepe_kernel (3, 3, C)."""
    q, k, v = (np.asarray(t, np.float64) for t in (q, k, v))
    B, H, W, C = q.shape
    d = C // heads
    out = np.zeros_like(q)
    for b in range(B):
        for i in range(H // h_sp):
            for j in range(W // w_sp):
                sl = (b, slice(i * h_sp, (i + 1) * h_sp), slice(j * w_sp, (j + 1) * w_sp))
                lepe = depthwise3x3(v[sl], lepe_kernel, lepe_bias).reshape(-1, C)
                qw, kw, vw = (t[sl].reshape(-1, C) for t in (q, k, v))
                ow = np.zeros_like(qw)
                for h in range(heads):
                    cs = slice(h * d, (h + 1) * d)
                    a = softmax((qw[:, cs] * scale) @ kw[:, cs].T)
                    ow[:, cs] = a @ vw[:, cs] + lepe[:, cs]
                out[sl] = ow.reshape(h_sp, w_sp, C)
    return out


def layer_norm(x, scale, bias, eps=1e-5):
    mu = x.mean(-1, keepdims=True)
    var = ((x - mu) ** 2).mean(-1, keepdims=True)
    return (x - mu) / np.sqrt(var + eps) * scale + bias


_erf = np.vectorize(math.erf)


def gelu(x):
    return 0.5 * x * (1.0 + _erf(x / math.sqrt(2.0)))


def cswin_block(x, p, *, heads, split, last):
    """One CSWin block (reference :112-181), deterministic. ``p`` uses the
    checkpoint's names: norm1, qkv, attns_0[, attns_1], proj, norm2, mlp."""
    x = np.asarray(x, np.float64)
    p = _as_f64(p)
    B, H, W, C = x.shape
    qkv = layer_norm(x, **p["norm1"]) @ p["qkv"]["kernel"] + p["qkv"]["bias"]
    q, k, v = qkv[..., :C], qkv[..., C:2 * C], qkv[..., 2 * C:]

    def branch(name, sl, nh, h_sp, w_sp):
        lp = p[name]
        c = sl.stop - sl.start
        return stripe_attention(q[..., sl], k[..., sl], v[..., sl],
                                lp["get_v_kernel"][:, :, 0], lp["get_v_bias"],
                                h_sp, w_sp, nh, (c // nh) ** -0.5)

    if last:
        att = branch("attns_0", slice(0, C), heads, H, W)
    else:
        half = C // 2
        att = np.concatenate([
            branch("attns_0", slice(0, half), heads // 2, H, split),
            branch("attns_1", slice(half, C), heads // 2, split, W)], -1)
    x = x + att @ p["proj"]["kernel"] + p["proj"]["bias"]
    y = layer_norm(x, **p["norm2"])
    y = gelu(y @ p["mlp"]["fc1"]["kernel"] + p["mlp"]["fc1"]["bias"])
    return x + y @ p["mlp"]["fc2"]["kernel"] + p["mlp"]["fc2"]["bias"]


def _as_f64(tree):
    if isinstance(tree, dict):
        return {k: _as_f64(v) for k, v in tree.items()}
    return np.asarray(tree, np.float64)


def conv1x1(x, kernel, bias=None):
    y = x @ kernel[0, 0]
    return y if bias is None else y + bias


def conv3x3(x, kernel, bias):
    """Full (not depthwise) 3x3 conv, zero padding; kernel (3, 3, Cin, Cout)."""
    B, H, W, _ = x.shape
    pad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((B, H, W, kernel.shape[-1]))
    for di in range(3):
        for dj in range(3):
            out += pad[:, di:di + H, dj:dj + W] @ kernel[di, dj]
    return out + bias


def carafe_classifier(x, p, cls_kernel, up):
    """CARAFE (reference :222-269) then a bias-free 1x1 classifier, k = 3:
    predicted per-pixel kernels, softmax over the 9 taps, pixel shuffle of
    the kernel map, unfold of the 3x3 neighbourhood, weighted sum, out conv
    on the upsampled map."""
    x = np.asarray(x, np.float64)
    p = _as_f64(p)
    B, H, W, C = x.shape
    enc = conv3x3(conv1x1(x, p["down_kernel"], p["down_bias"]),
                  p["encoder_kernel"], p["encoder_bias"])
    # encoder channel t*up² + i*up + j is tap t at sub-pixel (i, j)
    kern = softmax(enc.reshape(B, H, W, 9, up, up), axis=3)
    pad = np.pad(x, ((0, 0), (1, 1), (1, 1), (0, 0)))
    out = np.zeros((B, H * up, W * up, C))
    for r in range(H):
        for c in range(W):
            patch = pad[:, r:r + 3, c:c + 3].reshape(B, 9, C)   # taps (di, dj)
            for i in range(up):
                for j in range(up):
                    w = kern[:, r, c, :, i, j]                  # (B, 9)
                    out[:, r * up + i, c * up + j] = np.einsum("bt,btc->bc", w, patch)
    out = conv1x1(out, p["out_kernel"], p["out_bias"])
    return conv1x1(out, np.asarray(cls_kernel, np.float64))
