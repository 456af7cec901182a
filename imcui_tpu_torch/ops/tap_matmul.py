"""Tap-sum matrix product (kernel ``csrc/tap_matmul.cu``), the one function
that the JAX package's six stage-tail probes K8–K13 compute
(``tools/try_nscaling.py``, ``try_tail_mini.py``, ``try_tail_mini2.py``,
``try_int8_tail.py``, ``try_tail_variants.py``, ``try_widen.py``):

    out[m, n] = bf16( Σ_r Σ_k x[m, k] · w_r[k, n] ),   K = 128,

with x of shape (..., 128) in bfloat16 (summed in float32) or int8 (summed
in int32), R taps w_r of shape (128, N), N a multiple of 128, and one
round-to-nearest-even to bfloat16 at the end. The scripts' bodies differ
only in TPU layout (chained K = 128 dots, lane concatenations to K = 384
or 1152, one wide dot with lane-slice sums); the shifts of a true 3×3
conv are ignored there (``try_tail_variants.py:1-3``), so every tap reads
the same x.

Two layouts of w: ``"taps"``, (R, 128, N); ``"wide"``, K13's ``k_wide``
shape (128, R·128) with ``w_wide[k, r·128 + n] = w_r[k, n]`` (N = 128).
The kernel reads either as the K-major taps of ``_k_major``.
"""

import torch

from ..models.layers import full_fp32
from . import _build

K = 128
LAYOUTS = ("taps", "wide")
DTYPES = (torch.bfloat16, torch.int8)


def _shape(x, w, layout):
    """(R, N) of a valid call; raises ValueError on what the function does
    not take, on any device."""
    if layout not in LAYOUTS:
        raise ValueError(f"tap_matmul: layout is one of {LAYOUTS}, got "
                         f"{layout!r}")
    if x.dtype not in DTYPES or w.dtype != x.dtype:
        raise ValueError(f"tap_matmul takes bfloat16 or int8 x and w of the "
                         f"same type; got {x.dtype} and {w.dtype}")
    if x.dim() < 1 or x.shape[-1] != K or x.numel() == 0:
        raise ValueError(f"tap_matmul takes x of shape (..., {K}) with at "
                         f"least one row; got {tuple(x.shape)}")
    if layout == "taps":
        if w.dim() != 3 or w.shape[1] != K:
            raise ValueError(f"tap_matmul(layout='taps') takes w of shape "
                             f"(R, {K}, N); got {tuple(w.shape)}")
        r, n = w.shape[0], w.shape[2]
    else:
        if w.dim() != 2 or w.shape[0] != K or w.shape[1] % K:
            raise ValueError(f"tap_matmul(layout='wide') takes w of shape "
                             f"({K}, R*{K}); got {tuple(w.shape)}")
        r, n = w.shape[1] // K, K
    if r < 1 or n < 128 or n % 128:
        raise ValueError(f"tap_matmul takes N a multiple of 128 and at least "
                         f"one tap; got N = {n}, R = {r}")
    if x.device != w.device:
        raise ValueError(f"tap_matmul: x on {x.device}, w on {w.device}")
    return r, n


def _taps(w, layout):
    """w as R (128, N) taps: the tensor itself, or a view of the wide one."""
    if layout == "taps":
        return w
    return w.reshape(K, -1, K).permute(1, 0, 2)


def _k_major(w, layout):
    """w as K-major taps, a new contiguous (R, N, 128) tensor with
    ``[r, n, k] = w_r[k, n]``: the one layout the kernel reads (wgmma takes
    an int8 B only K-major). One copy of R·N·128 elements."""
    return _taps(w, layout).transpose(1, 2).contiguous()


def tap_matmul_plain(x, w, *, layout="taps"):
    """Plain version. bfloat16: Σ_r x.float() @ w_r.float() in full float32
    (no TF32), rounded once to bfloat16. int8: the exact integer sums (int64
    on the CPU; float64 on a card, whose matmul takes no integers, exact
    below 2⁵³), then ``.to(torch.bfloat16)``. Returns (..., N) bfloat16."""
    _, n = _shape(x, w, layout)
    taps = _taps(w, layout)
    x2 = x.reshape(-1, K)
    if x.dtype == torch.bfloat16:
        wide = torch.float32
    else:
        wide = torch.int64 if x.device.type == "cpu" else torch.float64
    xw = x2.to(wide)
    acc = torch.zeros((x2.shape[0], n), dtype=wide, device=x.device)
    with full_fp32():
        for t in taps:
            acc.addmm_(xw, t.to(wide))
    return acc.to(torch.bfloat16).reshape(*x.shape[:-1], n)


def tap_matmul(x, w, *, layout="taps"):
    """The kernel on CUDA tensors; the plain version on CPU tensors.
    x: (..., 128) bfloat16 or int8, contiguous; w: (R, 128, N) for
    ``layout="taps"`` or (128, R·128) for ``"wide"`` (N = 128), of x's
    type, contiguous; N a multiple of 128. Returns (..., N) bfloat16."""
    r, n = _shape(x, w, layout)
    if x.device.type == "cpu":
        return tap_matmul_plain(x, w, layout=layout)
    _build.require(x, "x", x.dtype)
    _build.require(w, "w", x.dtype)
    m = x.numel() // K
    if m >= 2 ** 31 or r * n * K >= 2 ** 31:
        raise ValueError(f"tap_matmul: {m} rows and {r} taps of (128, {n}) "
                         f"exceed the kernel's 32-bit sizes")
    out = torch.empty((*x.shape[:-1], n), dtype=torch.bfloat16,
                      device=x.device)
    wt = _k_major(w, layout)
    lib = _build.library()
    fn = lib.tap_matmul_bf16 if x.dtype == torch.bfloat16 else \
        lib.tap_matmul_s8
    code = fn(_build.ptr(x), _build.ptr(wt), _build.ptr(out), m, n, r,
              _build.stream_of(x))
    _build.check(code, "tap_matmul")
    tap_matmul.launches += 1
    return out


tap_matmul.launches = 0
