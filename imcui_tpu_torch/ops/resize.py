"""Image resize with the semantics the JAX package gets from
``jax.image.resize``: what DINOv2's position grid (bicubic) and RoMa's
warp, certainty and input images (bilinear) go through.

It is not ``torch.nn.functional.interpolate``: that one uses the cubic
kernel with a = −0.75 and does not antialias by default. Here, as in
``jax.image.resize``:

- sample centres are half-pixel: output i reads the input at
  ``(i + 0.5) · n_in / n_out − 0.5``;
- ``"bilinear"`` is the triangle kernel, ``"bicubic"`` the Keys cubic with
  a = −0.5;
- when an axis shrinks, the kernel is widened by ``n_in / n_out``
  (antialiasing); when it grows, it is not;
- each output's weights are renormalised to sum to 1, which is what
  happens at the edges, where part of the kernel falls outside the input.

Each axis is one (n_out, n_in) weight matrix, built in float32 and cast
to the input's dtype; an axis whose size does not change is left alone.

``torch_interpolate`` is the other function of the JAX module:
``F.interpolate`` semantics restated as the JAX function does it, one
axis at a time with taps gathered along it and float64 weights cast to
the input's dtype:

- ``"bicubic"``: the cubic kernel with a = −0.75 (torch's, not the
  Keys a = −0.5 of ``resize``), four taps an output, indices clamped to
  the edge (replicate);
- ``"nearest"``: torch's legacy nearest, the source index
  floor(i · n_in / n_out);
- ``"bilinear"`` with ``align_corners=True``: two taps an output;
- ``"bilinear"`` with ``align_corners=False``: the JAX function calls
  ``jax.image.resize``, which antialiases when an axis shrinks, so it is
  ``resize(x, size, "bilinear")`` here, not ``F.interpolate``.

``align_corners`` moves the bicubic taps as it does in torch; nearest
ignores it, as the JAX function does.
"""

import numpy as np
import torch


def _triangle(x):
    return (1.0 - x).clamp_min(0.0)


def _keys_cubic(x):
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


KERNELS = {"bilinear": _triangle, "bicubic": _keys_cubic}


def weight_matrix(n_in, n_out, method="bilinear", device="cpu"):
    """(n_out, n_in) float32 resampling weights of one axis."""
    kernel = KERNELS[method]
    inv_scale = n_in / n_out
    kernel_scale = max(inv_scale, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float32, device=device) + 0.5
              ) * inv_scale - 0.5
    x = (sample[:, None] - torch.arange(n_in, dtype=torch.float32,
                                        device=device)[None, :]).abs()
    w = kernel(x / kernel_scale)
    total = w.sum(1, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[:, None], w, torch.zeros_like(w))


def resize(x, size, method="bilinear", dims=(-2, -1)):
    """Resize the two axes ``dims`` of ``x`` to ``size`` = (h, w). The
    default takes (..., H, W) tensors; ``dims=(0, 1)`` takes (H, W, ...).
    float32 or bfloat16; the result has ``x``'s dtype (bf16: float32 sums,
    one rounding per axis)."""
    if method not in KERNELS:
        raise ValueError(f"unknown resize method {method!r}")
    for dim, n_out in zip(dims, size):
        dim = dim % x.dim()
        n_in = x.shape[dim]
        if n_in == n_out:
            continue
        w = weight_matrix(n_in, n_out, method, x.device).to(x.dtype)
        moved = x.movedim(dim, -1)
        # the weights are rounded to x's dtype, the sum is taken in float32
        out = torch.matmul(moved.float(), w.float().t()).to(x.dtype)
        x = out.movedim(-1, dim)
    return x


def _axis_indices(n_in, n_out, align_corners):
    """Source coordinate of each output sample along one axis (float64)."""
    i = np.arange(n_out, dtype=np.float64)
    if align_corners and n_out > 1:
        return i * (n_in - 1) / (n_out - 1)
    return (i + 0.5) * n_in / n_out - 0.5


def _cubic_weights(src, a=-0.75):
    """Per-output base index and (n_out, 4) cubic weights of the taps at
    offsets -1..2 (float64)."""
    base = np.floor(src).astype(np.int64)
    t = src - base
    ax = np.abs(np.stack([t + 1.0, t, 1.0 - t, 2.0 - t], -1))
    w = np.where(ax <= 1.0,
                 (a + 2.0) * ax ** 3 - (a + 3.0) * ax ** 2 + 1.0,
                 a * ax ** 3 - 5.0 * a * ax ** 2 + 8.0 * a * ax - 4.0 * a)
    return base, w


def _take(x, axis, idx):
    return x.index_select(axis, torch.from_numpy(idx).to(x.device))


def _along(x, axis, weights):
    """A float64 weight vector as x's dtype, shaped to scale ``axis``."""
    shape = [1] * x.dim()
    shape[axis] = len(weights)
    return torch.from_numpy(np.ascontiguousarray(weights)).to(
        device=x.device, dtype=x.dtype).reshape(shape)


def torch_interpolate(x, size, mode="bilinear", align_corners=False):
    """``F.interpolate(x, size, mode, align_corners)`` as the JAX function
    computes it, for ``x`` (..., H, W) (the JAX function takes
    channel-last (..., H, W, C)); ``size`` = (H_out, W_out); ``mode`` one
    of bicubic, nearest and bilinear (see the module docstring)."""
    axes = (x.dim() - 2, x.dim() - 1)
    if mode == "bicubic":
        out = x
        for axis, n_out in zip(axes, size):
            n_in = out.shape[axis]
            base, w = _cubic_weights(_axis_indices(n_in, n_out,
                                                   align_corners))
            acc = None
            for tap in range(4):
                idx = np.clip(base + tap - 1, 0, n_in - 1)
                term = _take(out, axis, idx) * _along(out, axis, w[:, tap])
                acc = term if acc is None else acc + term
            out = acc
        return out
    if mode == "nearest":
        out = x
        for axis, n_out in zip(axes, size):
            n_in = out.shape[axis]
            out = _take(out, axis, np.floor(
                np.arange(n_out) * n_in / n_out).astype(np.int64))
        return out
    if mode != "bilinear":
        raise ValueError(f"unknown mode {mode}")
    if not align_corners:
        return resize(x, size, "bilinear")
    out = x
    for axis, n_out in zip(axes, size):
        n_in = out.shape[axis]
        src = _axis_indices(n_in, n_out, True)
        base = np.clip(np.floor(src).astype(np.int64), 0, n_in - 1)
        nxt = np.clip(base + 1, 0, n_in - 1)
        t = _along(out, axis, src - np.floor(src))
        out = _take(out, axis, base) * (1 - t) + _take(out, axis, nxt) * t
    return out
