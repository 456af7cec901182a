"""DPT dense-prediction head, the pointmap head of DUSt3R and MASt3R.
Counterpart of ``imcui_tpu/models/backbones/dpt.py`` on (C, H, W) maps of
one view.

Four hooks (the encoder's output and three decoder depths) are projected
to [96, 192, 384, 768] channels and brought to strides 4, 8, 16 and 32 of
the patch grid (×4 and ×2 transposed convolutions whose kernel equals
their stride, nothing, a 3 × 3 stride-2 convolution), then to a
256-channel pyramid fused by four residual blocks from the coarsest up,
each ending in a 2× (or to-size) align-corners bilinear upsample and a
1 × 1 convolution; a three-convolution head with one more 2× upsample
gives ``out_ch`` channels at 16 × the patch grid. The parameter keys are
the upstream state dict's (``act_postprocess``, ``scratch``, ``head``).

Precision: as in the JAX module, the transposed convolutions and the
upsamples compute in float32 (the JAX einsums ask for a float32 result)
and the upsample returns to its input's dtype; a bfloat16 tree casts
each convolution's input to bfloat16.
"""

import torch
import torch.nn.functional as F

from ..layers import conv2d, init_conv, relu

LAYER_DIMS = (96, 192, 384, 768)
FEATURE_DIM = 256


def init_conv_transpose(gen, k, cin, cout):
    """torch's ConvTranspose2d layout (cin, cout, k, k), uniform in
    ±1/√(cin·k²) (the JAX tree stores it (k, k, cout, cin), which
    ``params_from_jax`` turns into this)."""
    scale = 1.0 / (cin * k * k) ** 0.5
    return {"w": (torch.rand((cin, cout, k, k), generator=gen) * 2 - 1)
            * scale,
            "b": (torch.rand((cout,), generator=gen) * 2 - 1) * scale}


def conv_transpose_s(p, x):
    """Non-overlapping transposed convolution (kernel = stride) of a
    (Cin, H, W) map → (Cout, H·k, W·k), in float32."""
    w = p["w"].float()
    return F.conv_transpose2d(x.float()[None], w, p["b"].float(),
                              stride=w.shape[-1])[0]


def interp_matrix(n_in, n_out, device="cpu"):
    """(n_out, n_in) float32 matrix of torch's align_corners=True bilinear
    interpolation: output i samples the input at
    i·(n_in − 1)/(n_out − 1)."""
    pos = torch.linspace(0.0, n_in - 1.0, n_out, device=device)
    i0 = pos.floor().long().clamp(0, n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    f = pos - i0.float()
    rows = torch.arange(n_out, device=device)
    m = torch.zeros((n_out, n_in), device=device)
    m.index_put_((rows, i0), 1.0 - f, accumulate=True)
    m.index_put_((rows, i1), f, accumulate=True)
    return m


def resize_align_corners(x, out_hw):
    """Bilinear resize of a (C, H, W) map with align_corners=True, as two
    float32 products with the interpolation matrices (rows, then columns);
    the result is rounded to x's dtype after each."""
    _, h, w = x.shape
    oh, ow = out_hw
    if (h, w) == (oh, ow):
        return x
    ry = interp_matrix(h, oh, x.device)
    rx = interp_matrix(w, ow, x.device)
    y = torch.einsum("Oh,chw->cOw", ry, x.float()).to(x.dtype)
    return torch.einsum("Pw,cOw->cOP", rx, y.float()).to(x.dtype)


def _conv(p, x, stride=1):
    return conv2d(p, x[None], stride=stride)[0]


def _init_rcu(gen, c):
    return {"conv1": init_conv(gen, 3, 3, c, c),
            "conv2": init_conv(gen, 3, 3, c, c)}


def _rcu_apply(p, x):
    """Residual conv unit without BN: x + conv2(relu(conv1(relu(x))))."""
    y = _conv(p["conv1"], relu(x))
    return x + _conv(p["conv2"], relu(y))


def _init_fusion(gen, c):
    return {"out_conv": init_conv(gen, 1, 1, c, c),
            "resConfUnit1": _init_rcu(gen, c),
            "resConfUnit2": _init_rcu(gen, c)}


def _fusion_apply(p, x, res=None, out_hw=None):
    """Fusion block: the lateral ``res`` through a residual unit added to
    x, a second residual unit, an upsample to ``out_hw`` (2× by default)
    and a 1 × 1 convolution."""
    if res is not None:
        x = x + _rcu_apply(p["resConfUnit1"], res)
    x = _rcu_apply(p["resConfUnit2"], x)
    if out_hw is None:
        out_hw = (x.shape[1] * 2, x.shape[2] * 2)
    return _conv(p["out_conv"], resize_align_corners(x, out_hw))


def init_dpt(gen, dim_tokens=(1024, 768, 768, 768), out_ch=4,
             layer_dims=LAYER_DIMS, feature_dim=FEATURE_DIM, last_dim=128):
    act = [
        {"0": init_conv(gen, 1, 1, dim_tokens[0], layer_dims[0]),
         "1": init_conv_transpose(gen, 4, layer_dims[0], layer_dims[0])},
        {"0": init_conv(gen, 1, 1, dim_tokens[1], layer_dims[1]),
         "1": init_conv_transpose(gen, 2, layer_dims[1], layer_dims[1])},
        {"0": init_conv(gen, 1, 1, dim_tokens[2], layer_dims[2])},
        {"0": init_conv(gen, 1, 1, dim_tokens[3], layer_dims[3]),
         "1": init_conv(gen, 3, 3, layer_dims[3], layer_dims[3])},
    ]
    scratch = {f"refinenet{i}": _init_fusion(gen, feature_dim)
               for i in range(1, 5)}
    for i, c in enumerate(layer_dims):
        scratch[f"layer{i + 1}_rn"] = init_conv(gen, 3, 3, c, feature_dim,
                                                bias=False)
    head = {"0": init_conv(gen, 3, 3, feature_dim, last_dim),
            "2": init_conv(gen, 3, 3, last_dim, 32),
            "4": init_conv(gen, 1, 1, 32, out_ch)}
    return {"act_postprocess": act, "scratch": scratch, "head": head}


def dpt_apply(p, hooks, grid):
    """hooks: four (N, D_k) token matrices; grid: (hp, wp) → (out_ch,
    16·hp, 16·wp) map."""
    hp, wp = grid
    fmaps = [h.t().reshape(h.shape[-1], hp, wp) for h in hooks]
    act = p["act_postprocess"]
    l1 = conv_transpose_s(act[0]["1"], _conv(act[0]["0"], fmaps[0]))
    l2 = conv_transpose_s(act[1]["1"], _conv(act[1]["0"], fmaps[1]))
    l3 = _conv(act[2]["0"], fmaps[2])
    l4 = _conv(act[3]["1"], _conv(act[3]["0"], fmaps[3]), stride=2)

    s = p["scratch"]
    l1, l2, l3, l4 = (_conv(s[f"layer{i}_rn"], t)
                      for i, t in enumerate((l1, l2, l3, l4), start=1))
    path4 = _fusion_apply(s["refinenet4"], l4, out_hw=l3.shape[1:])
    path3 = _fusion_apply(s["refinenet3"], path4, l3, out_hw=l2.shape[1:])
    path2 = _fusion_apply(s["refinenet2"], path3, l2, out_hw=l1.shape[1:])
    path1 = _fusion_apply(s["refinenet1"], path2, l1)

    h = p["head"]
    x = _conv(h["0"], path1)
    x = resize_align_corners(x, (x.shape[1] * 2, x.shape[2] * 2))
    return _conv(h["4"], relu(_conv(h["2"], x)))
