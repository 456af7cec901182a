"""W8A8 products: int8 weights quantised per output channel, activations
quantised to int8 on the fly, int32 sums and a float32 dequantising
epilogue (kernels ``csrc/w8a8.cu``). Counterpart of
``imcui_tpu/models/layers.py``'s ``_linear_int8`` and ``_conv2d_int8``,
which are XLA in the JAX package: no TPU kernel is replaced here. The
port writes both products by hand because no library call serves them on
the card: PyTorch has no int8 convolution on CUDA, and ``torch._int_mm``
took 9.871 ms where bf16 cuBLAS took 3.968 on the same shape (PERF.md,
K11), so it would serve W8A8 slower than the bf16 it replaces.

Arithmetic, in the JAX package's order (it fixes the last bits):

- an activation scale ``sx = max(max|x|, 1e-12) / 127`` in float32, per
  row of the linear's input and per tensor for the convolution (one call
  of ``_conv2d_int8``: the models run one image a call), and
  ``xq = clip(round_half_even(x / sx), -127, 127)``;
- linear: ``(f32(acc) * sx) * w_s``, then ``+ b``, then the cast to x's
  type;
- convolution: ``f32(acc) * (sx * w_s)``, then ``+ b``, then the cast.

The activation quantisation stays PyTorch tensor ops (XLA's in the JAX
package) on every device; the kernels take the int8 operands. The plain
versions take the int32 sums exactly in float64 (products and sums of
int8 values are integers far below 2⁵³), so a kernel equals its plain
version bit for bit.

Layouts: ``w_q`` is the port's weight layout, (dout, din) for the linear
and (cout, cin/groups, kh, kw) for the convolution; convolution padding is
explicit, ((top, bottom), (left, right)). The convolution kernel returns
its (B, Cout, Ho, Wo) result channels-last in memory.
"""

import ctypes

import torch
import torch.nn.functional as F

from . import _build


def quantize_rows(x2):
    """(M, K) float → (int8 (M, K), float32 scales (M, 1))."""
    xf = x2.float()
    sx = xf.abs().amax(-1, keepdim=True).clamp_min(1e-12) / 127.0
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


def quantize_tensor(x):
    """Any float tensor → (int8 of its shape, float32 0-d scale)."""
    xf = x.float()
    sx = xf.abs().amax().clamp_min(1e-12) / 127.0
    return torch.round(xf / sx).clamp(-127, 127).to(torch.int8), sx


def _check_linear(x, w_q, w_s, b):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"linear_int8 takes float32 or bfloat16 x, got "
                         f"{x.dtype}")
    if w_q.dtype != torch.int8 or w_q.dim() != 2 or x.shape[-1] != \
            w_q.shape[1]:
        raise ValueError(f"linear_int8 takes int8 w_q (dout, din) with din "
                         f"= x.shape[-1]; got {w_q.dtype} "
                         f"{tuple(w_q.shape)} for x {tuple(x.shape)}")


def linear_int8_plain(x, w_q, w_s, b=None):
    """Plain version: x (..., K) float32 or bfloat16, w_q (N, K) int8,
    w_s (N,) float32, b (N,) or None → (..., N) in x's type."""
    _check_linear(x, w_q, w_s, b)
    xq, sx = quantize_rows(x.reshape(-1, x.shape[-1]))
    acc = xq.double() @ w_q.double().t()
    out = acc.float() * sx * w_s
    if b is not None:
        out = out + b
    return out.to(x.dtype).reshape(*x.shape[:-1], w_q.shape[0])


def linear_int8(x, w_q, w_s, b=None):
    """The kernel on CUDA tensors; the plain version on CPU tensors.
    Arguments as ``linear_int8_plain``; w_q, w_s and b contiguous."""
    _check_linear(x, w_q, w_s, b)
    if x.device.type == "cpu":
        return linear_int8_plain(x, w_q, w_s, b)
    n, k = w_q.shape
    _build.require(w_q, "w_q", torch.int8, (n, k))
    _build.require(w_s, "w_s", torch.float32, (n,))
    if b is not None:
        _build.require(b, "b", torch.float32, (n,))
    # elementwise ops keep x's strides: a transposed view (a ViT's patch
    # tokens) gives a column-major xq, and the kernel reads rows
    xq, sx = quantize_rows(x.reshape(-1, k))
    xq = xq.contiguous()
    m = xq.shape[0]
    kp = -(-k // 16) * 16  # the kernel reads K in 16-byte chunks
    wq = w_q
    if kp != k:  # zeros add nothing to the sums
        xq, wq = F.pad(xq, (0, kp - k)), F.pad(w_q, (0, kp - k))
    if max(m, n) * kp >= 2 ** 31:
        raise ValueError(f"linear_int8: ({m}, {k}) x ({n}, {k}) exceeds the "
                         f"kernel's 32-bit sizes")
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    code = _build.library().w8a8_gemm(
        _build.ptr(xq), _build.ptr(wq), _build.ptr(sx), _build.ptr(w_s),
        None if b is None else _build.ptr(b), _build.ptr(out), m, n, kp,
        int(x.dtype == torch.bfloat16), _build.stream_of(x))
    _build.check(code, "linear_int8")
    linear_int8.launches += 1
    return out.reshape(*x.shape[:-1], n)


linear_int8.launches = 0


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def _check_conv(x, w_q, groups):
    if x.dtype not in (torch.float32, torch.bfloat16) or x.dim() != 4:
        raise ValueError(f"conv2d_int8 takes (B, C, H, W) float32 or "
                         f"bfloat16 x, got {tuple(x.shape)} {x.dtype}")
    if w_q.dtype != torch.int8 or w_q.dim() != 4 or \
            w_q.shape[1] * groups != x.shape[1] or w_q.shape[0] % groups:
        raise ValueError(f"conv2d_int8 takes int8 w_q (cout, cin/groups, kh, "
                         f"kw); got {w_q.dtype} {tuple(w_q.shape)} for "
                         f"{x.shape[1]} channels in {groups} groups")


def conv2d_int8_plain(x, w_q, w_s, b, stride, padding, dilation, groups):
    """Plain version: x (B, C, H, W) float32 or bfloat16, w_q (cout,
    cin/groups, kh, kw) int8, w_s (cout,) float32, b (cout,) or None;
    stride and dilation an int or a pair, padding ((top, bottom), (left,
    right)) → (B, cout, Ho, Wo) in x's type."""
    _check_conv(x, w_q, groups)
    xq, sx = quantize_tensor(x)
    (pt, pb), (pl, pr) = padding
    # float64 without cuDNN: im2col and a float64 product, exact on
    # integers; cuDNN's algorithms (FFT among them) need not be
    with torch.backends.cudnn.flags(enabled=False):
        acc = F.conv2d(F.pad(xq.double(), (pl, pr, pt, pb)), w_q.double(),
                       stride=_pair(stride), dilation=_pair(dilation),
                       groups=groups)
    out = acc.float() * (sx * w_s).view(1, -1, 1, 1)
    if b is not None:
        out = out + b.view(1, -1, 1, 1)
    return out.to(x.dtype)


def conv2d_int8(x, w_q, w_s, b, stride, padding, dilation, groups):
    """The kernel on CUDA tensors; the plain version on CPU tensors.
    Arguments as ``conv2d_int8_plain``; w_q, w_s and b contiguous. The
    kernel's result is channels-last in memory."""
    _check_conv(x, w_q, groups)
    if x.device.type == "cpu":
        return conv2d_int8_plain(x, w_q, w_s, b, stride, padding, dilation,
                                 groups)
    cout, cg, kh, kw = w_q.shape
    _build.require(w_q, "w_q", torch.int8)
    _build.require(w_s, "w_s", torch.float32, (cout,))
    if b is not None:
        _build.require(b, "b", torch.float32, (cout,))
    bsz, _, h, w = x.shape
    (sy, sx_), (dy, dx) = _pair(stride), _pair(dilation)
    (pt, pb), (pl, pr) = padding
    ho = (h + pt + pb - dy * (kh - 1) - 1) // sy + 1
    wo = (w + pl + pr - dx * (kw - 1) - 1) // sx_ + 1
    if min(sy, sx_, dy, dx) < 1 or min(pt, pb, pl, pr) < 0 or \
            min(ho, wo) < 1:
        raise ValueError(f"conv2d_int8: stride {stride}, dilation "
                         f"{dilation}, padding {padding} on {(h, w)} give "
                         f"no output")
    xq, sx = quantize_tensor(x)
    # NHWC, each group's channels padded to 16 (the kernel gathers 16-byte
    # chunks of channels); zero channels add nothing to the sums
    cgp = -(-cg // 16) * 16
    xq = xq.permute(0, 2, 3, 1)
    wk = w_q.permute(0, 2, 3, 1)
    if cgp != cg:
        xq = F.pad(xq.reshape(bsz, h, w, groups, cg), (0, cgp - cg))
        wk = F.pad(wk, (0, cgp - cg))
    xq = xq.reshape(bsz, h, w, groups * cgp).contiguous()
    wk = wk.contiguous()
    cs = sx * w_s  # the JAX order: f32(acc) * (sx * w_s)
    m = bsz * ho * wo
    if max(xq.numel(), m * cout, wk.numel()) >= 2 ** 31:
        raise ValueError(f"conv2d_int8: {tuple(x.shape)} into {cout} "
                         f"channels exceeds the kernel's 32-bit sizes")
    out = torch.empty((bsz, ho, wo, cout), dtype=x.dtype, device=x.device)
    dims = (ctypes.c_int * 18)(bsz, h, w, groups * cgp, ho, wo, cout, kh, kw,
                               sy, sx_, dy, dx, pt, pl, groups, cgp,
                               int(x.dtype == torch.bfloat16))
    code = _build.library().w8a8_conv(
        _build.ptr(xq), _build.ptr(wk), _build.ptr(cs),
        None if b is None else _build.ptr(b), _build.ptr(out),
        ctypes.cast(dims, ctypes.c_void_p), _build.stream_of(x))
    _build.check(code, "conv2d_int8")
    conv2d_int8.launches += 1
    return out.permute(0, 3, 1, 2)


conv2d_int8.launches = 0
