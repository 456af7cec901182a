"""Building blocks of the serving path, on torch-layout parameters.

Counterpart of ``imcui_tpu/models/layers.py`` (the subset SuperPoint and
LightGlue use). Parameters are plain dicts of tensors, conv kernels OIHW
and linear weights ``(dout, din)`` (utils/weights.py). Activations of the
conv layers are NCHW tensors, kept channels-last in memory where a kernel
reads them as NHWC.
"""

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def full_fp32():
    """Run float32 convolutions and matmuls in full float32.

    cuDNN runs float32 convolutions in TF32 by default, which keeps about
    three decimal digits; geometry and the fp32 parity paths need all of
    float32. Restores the previous flags on exit."""
    conv, mm = (torch.backends.cudnn.allow_tf32,
                torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = conv
        torch.backends.cuda.matmul.allow_tf32 = mm


def conv2d(p, x, stride=1, dilation=1):
    """2-D convolution with torch-symmetric ``k//2`` padding.
    p: {"w": (cout, cin, kh, kw), "b": (cout,)?}; x: (B, C, H, W).

    The weight dtype sets the compute dtype (a bf16 parameter tree makes
    the conv bf16); the bias is added after the convolution, in that
    dtype, as the JAX layer does."""
    w = p["w"]
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    kh, kw = w.shape[-2:]
    pad = (((kh - 1) * dilation + 1) // 2, ((kw - 1) * dilation + 1) // 2)
    out = F.conv2d(x, w, stride=stride, padding=pad, dilation=dilation)
    if p.get("b") is not None:
        out = out + p["b"].view(1, -1, 1, 1)
    return out


def linear(p, x):
    """p: {"w": (dout, din), "b": (dout,)?}; x: (..., din)."""
    return F.linear(x, p["w"], p.get("b"))


def layer_norm(p, x, eps=1e-5):
    """Normalise over the last dim with float32 statistics;
    p: {"scale", "bias"}. The output returns to x's dtype."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = ((xf - mean) ** 2).mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    return (out * p["scale"] + p["bias"]).to(x.dtype)


def gelu(x):
    """Exact (erf) GELU, torch's nn.GELU default."""
    return F.gelu(x)


def relu(x):
    return torch.relu(x)


def max_pool(x):
    """2×2 / stride-2 max-pool of (B, C, H, W)."""
    return F.max_pool2d(x, 2, 2)
