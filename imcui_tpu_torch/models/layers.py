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

from ..ops import w8a8


# the serving precisions that run the models' images in bfloat16 (the JAX
# wrappers' ("bf16", "int8"))
LOW_PRECISIONS = ("bf16", "bfloat16", "int8")


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


def _explicit_padding(padding, kh, kw, dilation):
    """((top, bottom), (left, right)) of ``padding``: "SAME" is
    torch-symmetric ``k//2`` padding of the dilated kernel, "VALID" none,
    and a pair of pairs is taken as it is."""
    d = w8a8._pair(dilation)
    if padding == "SAME":
        eh, ew = (kh - 1) * d[0] + 1, (kw - 1) * d[1] + 1
        return (eh // 2, eh // 2), (ew // 2, ew // 2)
    if padding == "VALID":
        return (0, 0), (0, 0)
    if not isinstance(padding, str):
        (pt, pb), (pl, pr) = padding
        return (int(pt), int(pb)), (int(pl), int(pr))
    raise ValueError(f"padding is 'SAME', 'VALID' or ((top, bottom), (left, "
                     f"right)), not {padding!r}")


def conv2d(p, x, stride=1, dilation=1, padding="SAME", groups=1):
    """2-D convolution. p: {"w": (cout, cin/groups, kh, kw), "b": (cout,)?};
    x: (B, C, H, W). ``padding="SAME"`` is torch-symmetric ``k//2`` padding;
    ``"VALID"`` pads nothing (a ViT patch embed: k × k at stride k); a pair
    of pairs ((top, bottom), (left, right)) pads as it says.

    The weight dtype sets the compute dtype (a bf16 parameter tree makes
    the conv bf16); the bias is added after the convolution, in that
    dtype, as the JAX layer does. A dict quantised by
    ``quantize_conv_int8`` (key "w_q") takes the W8A8 route
    (``ops.w8a8.conv2d_int8``) with x as it comes, and returns x's type."""
    wt = p["w_q"] if "w_q" in p else p["w"]
    (pt, pb), (pl, pr) = _explicit_padding(padding, *wt.shape[-2:], dilation)
    if "w_q" in p:
        return w8a8.conv2d_int8(x, p["w_q"], p["w_s"], p.get("b"), stride,
                                ((pt, pb), (pl, pr)), dilation, groups)
    w = p["w"]
    if x.dtype != w.dtype:
        x = x.to(w.dtype)
    if (pt, pl) != (pb, pr):
        x, pt, pl = F.pad(x, (pl, pr, pt, pb)), 0, 0
    out = F.conv2d(x, w, stride=stride, padding=(pt, pl), dilation=dilation,
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
    the wider one, as ``x @ w`` is in the JAX layer. A dict quantised by
    ``quantize_linear_int8`` (key "w_q") takes the W8A8 route
    (``ops.w8a8.linear_int8``) and returns x's type."""
    if "w_q" in p:
        return w8a8.linear_int8(x, p["w_q"], p["w_s"], p.get("b"))
    w, b = p["w"], p.get("b")
    if x.dtype != w.dtype:
        dtype = torch.promote_types(x.dtype, w.dtype)
        x, w = x.to(dtype), w.to(dtype)
        b = b.to(dtype) if b is not None else None
    return F.linear(x, w, b)


def _quantized(p, scale, q):
    out = {"w_q": q, "w_s": scale}
    if p.get("b") is not None:
        out["b"] = p["b"]
    return out


def quantize_linear_int8(p):
    """Symmetric per-output-channel int8 quantisation of a linear dict
    {"w": (dout, din), "b"?} → {"w_q": int8 (dout, din), "w_s": float32
    (dout,), "b"?}: s = max(max|w| over din, 1e-12) / 127, w_q =
    clip(round_half_even(w / s), -127, 127), from the float32 weights. The
    bias is kept as it is."""
    w = p["w"].float()
    s = w.abs().amax(1).clamp_min(1e-12) / 127.0
    return _quantized(p, s, torch.round(w / s[:, None]).clamp(-127, 127)
                      .to(torch.int8))


def quantize_conv_int8(p):
    """The same for a convolution dict {"w": (cout, cin/groups, kh, kw),
    "b"?}: one scale per output channel, over (cin/groups, kh, kw), the
    axes the JAX layout orders (kh, kw, cin)."""
    w = p["w"].float()
    s = w.abs().amax((1, 2, 3)).clamp_min(1e-12) / 127.0
    return _quantized(p, s, torch.round(w / s.view(-1, 1, 1, 1))
                      .clamp(-127, 127).to(torch.int8))


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


def apply_precision(tree, precision, min_dim=256, conv_min_ch=None):
    """Serving-time precision of a whole parameter tree, the JAX package's
    rules:

    - ``None``/"f32": the tree as it is;
    - "bf16": every floating leaf cast to bfloat16 (the ops that need
      float32 widen inside: LayerNorm statistics, the depthwise
      accumulation, attention logits);
    - "int8" (W8A8): every dict {"w", "b"?} whose ``w`` is 2-D with
      min(dout, din) >= ``min_dim`` quantised by ``quantize_linear_int8``
      and, where ``conv_min_ch`` is given, every such dict whose ``w`` is
      4-D with min(cout, cin/groups) >= ``conv_min_ch`` by
      ``quantize_conv_int8`` (depthwise kernels, cin/groups = 1, stay out
      above 1), both from the float32 weights; ``w_s`` and the bias of a
      quantised dict stay float32 and every other floating leaf is cast
      to bfloat16.

    A quantised dict has no "w": a function that reads one (the DPT's
    transposed convolutions, RoMa's and DKM's ``pos_conv``, the depthwise
    convolution) raises ``KeyError`` where the threshold takes its dict,
    as in the JAX package (ROADMAP.md, §C)."""
    if precision in (None, "f32", "float32"):
        return tree
    if precision not in ("bf16", "bfloat16", "int8"):
        raise ValueError(f"unknown precision {precision!r}")
    int8 = precision == "int8"

    def walk(node):
        if isinstance(node, dict):
            w = node.get("w")
            if int8 and set(node) <= {"w", "b"} and torch.is_tensor(w):
                if w.dim() == 2 and min(w.shape) >= min_dim:
                    return quantize_linear_int8(node)
                if (w.dim() == 4 and conv_min_ch is not None
                        and min(w.shape[:2]) >= conv_min_ch):
                    return quantize_conv_int8(node)
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
