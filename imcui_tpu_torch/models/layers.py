"""Building blocks of the serving path, on torch-layout parameters.

Counterpart of ``imcui_tpu/models/layers.py`` (what SuperPoint, LightGlue,
the ViT backbones, RoMa and the sparse extractors use; the pools and
``selu`` of ALIKE and ALIKED are the extractors' own helpers in the JAX
package). Parameters are plain dicts of tensors, conv kernels OIHW
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


def conv2d(p, x, stride=1, dilation=1, padding="SAME", groups=1):
    """2-D convolution. p: {"w": (cout, cin/groups, kh, kw), "b": (cout,)?};
    x: (B, C, H, W). ``padding="SAME"`` is torch-symmetric ``k//2`` padding;
    ``"VALID"`` pads nothing (a ViT patch embed: k × k at stride k).

    The weight dtype sets the compute dtype (a bf16 parameter tree makes
    the conv bf16); the bias is added after the convolution, in that
    dtype, as the JAX layer does."""
    w = p["w"]
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    kh, kw = w.shape[-2:]
    if padding == "SAME":
        pad = (((kh - 1) * dilation + 1) // 2, ((kw - 1) * dilation + 1) // 2)
    elif padding == "VALID":
        pad = 0
    else:
        raise ValueError(f"padding is 'SAME' or 'VALID', not {padding!r}")
    out = F.conv2d(x, w, stride=stride, padding=pad, dilation=dilation,
                   groups=groups)
    if p.get("b") is not None:
        out = out + p["b"].view(1, -1, 1, 1)
    return out


def depthwise_conv(p, x):
    """Depthwise k × k stride-1 convolution with ``k//2`` padding.
    p: {"w": (C, 1, kh, kw), "b": (C,)?}; x: (B, C, H, W). One grouped
    convolution in the weight dtype, float32 sums; the bias is added after
    the cast back.

    In bfloat16 the JAX layer rounds each of the k² products to bf16
    before it adds them up in float32; a product of two bf16 values is
    exact in float32, so here the sum is taken over the exact products and
    rounded once. The two differ by less than one bf16 step of the result
    (tests/test_torch_port_vit.py holds it to 2⁻⁷·max(1, |JAX|))."""
    w = p["w"]
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    c, _, kh, kw = w.shape
    out = F.conv2d(x, w, padding=(kh // 2, kw // 2), groups=c)
    if p.get("b") is not None:
        out = out + p["b"].view(1, -1, 1, 1)
    return out


def linear(p, x):
    """p: {"w": (dout, din), "b": (dout,)?}; x: (..., din). Where the two
    dtypes differ (float32 tokens through a bf16 tree) both are promoted to
    the wider one, as ``x @ w`` is in the JAX layer."""
    w, b = p["w"], p.get("b")
    if x.dtype != w.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dtype), w.to(dtype)
        b = b.to(dtype) if b is not None else None
    return F.linear(x, w, b)


def xla_mean3(x, dim):
    """``jnp.mean`` over a dimension of size 3 as XLA computes it on the
    CPU: the sum in index order times float32(1/3), which can differ in
    the last bit from torch's ``mean`` (a division)."""
    a, b, c = x.unbind(dim)
    third = torch.tensor(1.0 / 3.0, dtype=x.dtype, device=x.device)
    return ((a + b) + c) * third


def batch_norm_inference(p, x, eps=1e-5):
    """Inference-mode batch norm over the channels of (B, C, H, W).
    p: {"mean", "var"} and, unless the layer is not affine, {"scale",
    "bias"}, each (C,). Computed in the leaves' dtype, as the JAX layer."""
    def ch(t):
        return t.view(1, -1, 1, 1)

    y = (x - ch(p["mean"])) * ch(torch.rsqrt(p["var"] + eps))
    if "scale" in p:
        y = y * ch(p["scale"]) + ch(p["bias"])
    return y


def instance_norm(x, eps=1e-5):
    """Parameter-free instance norm over the spatial dims of (B, C, H, W)
    (DISK's and XFeat's)."""
    mean = x.mean((2, 3), keepdim=True)
    var = ((x - mean) ** 2).mean((2, 3), keepdim=True)
    return (x - mean) * torch.rsqrt(var + eps)


def l2_normalize(x, dim=-1, eps=1e-8):
    return x / torch.linalg.vector_norm(x, dim=dim, keepdim=True).clamp_min(
        eps)


def apply_precision(tree, precision):
    """Serving-time precision of a whole parameter tree: ``None``/"f32"
    leaves it alone, "bf16" casts every floating leaf to bfloat16 (the ops
    that need float32 widen inside: LayerNorm statistics, the depthwise
    accumulation, attention logits). "int8", the JAX package's W8A8 path
    for wide linears, is not ported (ROADMAP.md, queue A)."""
    if precision in (None, "f32", "float32"):
        return tree
    if precision == "int8":
        raise NotImplementedError(
            "precision 'int8' (W8A8 linears and convs) is not ported yet: "
            "see ROADMAP.md; use None or 'bf16'")
    if precision not in ("bf16", "bfloat16"):
        raise ValueError(f"unknown precision {precision!r}")

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(walk(v) for v in node)
        if torch.is_tensor(node) and node.is_floating_point():
            return node.to(torch.bfloat16)
        return node

    return walk(tree)


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


def leaky_relu(x, slope=0.01):
    """x where x >= 0, else slope · x (one rounding in x's dtype)."""
    return F.leaky_relu(x, slope)


def selu(x):
    """Scaled ELU (torch's and ``jax.nn.selu``'s constants)."""
    return F.selu(x)


def max_pool(x, window=2, stride=2):
    """window × window max-pool of (B, C, H, W) at ``stride``, VALID."""
    return F.max_pool2d(x, window, stride)


def max_pool3_s2(x):
    """torchvision's stem pool: 3 × 3 window, stride 2, padding 1 with
    −inf, of (B, C, H, W) (not the 2 × 2 pool: same output shape on even
    inputs, other values)."""
    return F.max_pool2d(x, 3, 2, padding=1)


def avg_pool(x, k):
    """k × k / stride-k average pool of (B, C, H, W), VALID: the window sum
    over k², as ``lax.reduce_window`` with ``add`` and a division."""
    return F.avg_pool2d(x, k, k)


# ---------------------------------------------------------------------------
# initialisers, for models whose trained weights are not in the repository
# ---------------------------------------------------------------------------

def init_conv(gen, kh, kw, cin, cout, bias=True):
    """He-normal OIHW kernel drawn from ``gen`` (a CPU torch.Generator)."""
    w = torch.randn((cout, cin, kh, kw), generator=gen) * (
        2.0 / (kh * kw * cin)) ** 0.5
    p = {"w": w}
    if bias:
        p["b"] = torch.zeros(cout)
    return p


def init_linear(gen, din, dout, bias=True):
    p = {"w": torch.randn((dout, din), generator=gen) * (1.0 / din) ** 0.5}
    if bias:
        p["b"] = torch.zeros(dout)
    return p


def init_layer_norm(d):
    return {"scale": torch.ones(d), "bias": torch.zeros(d)}


def init_bn(dim):
    return {"scale": torch.ones(dim), "bias": torch.zeros(dim),
            "mean": torch.zeros(dim), "var": torch.ones(dim)}
