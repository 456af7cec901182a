"""Deformable 2-D convolution with torchvision's ``deform_conv2d``
semantics, for ALIKED's deformable ResBlocks. Counterpart of
``imcui_tpu/ops/deform.py``. torchvision is not a dependency of this
package, so the operator is restated in plain torch.

Conventions (torchvision's):
- ``offset`` has 2·kh·kw channels, (Δy, Δx) per kernel tap, taps in
  row-major order;
- sampling is bilinear with zeros outside the feature map (a tap that
  straddles the border keeps its inside corners);
- stride 1, dilation 1, symmetric padding kh//2: the only configuration
  ALIKED uses.

As in the JAX function, each of the k² taps is one bilinear gather over
the whole map followed by one channel product, summed tap by tap.
"""

import torch


def _bilinear_zeros(x, py, px):
    """Sample x (B, C, H, W) at float coordinates py, px (B, H', W') with
    zero padding outside the map → (B, C, H', W')."""
    b, c, h, w = x.shape
    y0 = torch.floor(py)
    x0 = torch.floor(px)
    wy = (py - y0)[:, None]
    wx = (px - x0)[:, None]
    y0i, x0i = y0.long(), x0.long()
    flat = x.reshape(b, c, h * w)

    def tap(yi, xi):
        inb = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        q = (yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)).reshape(b, 1, -1)
        v = torch.gather(flat, 2, q.expand(-1, c, -1)).reshape(
            b, c, *yi.shape[1:])
        return torch.where(inb[:, None], v, 0.0)

    return (tap(y0i, x0i) * (1 - wy) * (1 - wx)
            + tap(y0i, x0i + 1) * (1 - wy) * wx
            + tap(y0i + 1, x0i) * wy * (1 - wx)
            + tap(y0i + 1, x0i + 1) * wy * wx)


def deform_conv2d(x, offset, weight, bias=None):
    """x: (B, Cin, H, W); offset: (B, 2·kh·kw, H, W) in torchvision's
    layout; weight: (Cout, Cin, kh, kw) → (B, Cout, H, W). Sums in
    float32 (the caller turns TF32 off on the card)."""
    b, _, h, w = x.shape
    cout, _, kh, kw = weight.shape
    iy = torch.arange(h, dtype=torch.float32, device=x.device)[:, None]
    ix = torch.arange(w, dtype=torch.float32, device=x.device)[None, :]
    out = x.new_zeros((b, cout, h, w), dtype=torch.float32)
    for i in range(kh):
        for j in range(kw):
            k = i * kw + j
            py = iy + (i - kh // 2) + offset[:, 2 * k]
            px = ix + (j - kw // 2) + offset[:, 2 * k + 1]
            samp = _bilinear_zeros(x, py, px)
            out = out + torch.einsum("bchw,oc->bohw", samp.float(),
                                     weight[:, :, i, j].float())
    if bias is not None:
        out = out + bias.view(1, -1, 1, 1)
    return out.to(x.dtype)
