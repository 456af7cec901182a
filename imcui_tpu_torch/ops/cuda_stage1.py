"""Fused SuperPoint stage tail (kernel ``csrc/stage_tail.cu``).

Replaces ``imcui_tpu/ops/pallas_stage1.py:stage_tail``. Computes

    maxpool2×2(relu(conv3×3(relu(y_raw + b_a); W_b) + b_b))

for the previous conv's output ``y_raw`` taken WITHOUT its bias, in NHWC
bf16 with float32 accumulation. The SAME zero padding of the 3×3 conv
applies after the prologue's relu (``relu(0 + b_a) ≠ 0``).
"""

import torch
import torch.nn.functional as F

from . import _build


def stage_tail_plain(y_raw, b_a, w_b, b_b):
    """Plain PyTorch version. y_raw: (B, H, W, 64) bf16 NHWC; b_a, b_b:
    (64,) float32; w_b: (64, 64, 3, 3) OIHW. Returns (B, H/2, W/2, 64)
    bf16. The prologue rounds to bf16 as the bf16 graph does; the conv,
    bias, relu and pool run in float32 on bf16 weights and round once at
    the end, as the kernel does."""
    h1 = torch.relu(y_raw + b_a.to(torch.bfloat16))
    x = h1.permute(0, 3, 1, 2).float()
    w = w_b.to(torch.bfloat16).float()
    z = torch.relu(F.conv2d(x, w, b_b.float(), padding=1))
    out = F.max_pool2d(z, 2, 2)
    return out.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def stage_tail(y_raw, b_a, w_b, b_b):
    """Kernel K1 on CUDA tensors; the plain version on CPU tensors.
    Arguments as for ``stage_tail_plain``; H and W must be even."""
    if y_raw.device.type == "cpu":
        return stage_tail_plain(y_raw, b_a, w_b, b_b)
    b, h, w, c = y_raw.shape
    if c != 64 or h % 2 or w % 2:
        raise ValueError(f"stage_tail takes (B, H, W, 64) with even H, W; "
                         f"got {tuple(y_raw.shape)}")
    _build.require(y_raw, "y_raw", torch.bfloat16)
    if y_raw.data_ptr() % 16:
        raise ValueError("y_raw must be 16-byte aligned")
    ba = b_a.float().contiguous()
    bb = b_b.float().contiguous()
    # OIHW → (ky, kx, cin, cout): 576 rows of 64 output channels
    wk = w_b.permute(2, 3, 1, 0).to(torch.bfloat16).contiguous()
    _build.require(ba, "b_a", torch.float32, (64,))
    _build.require(bb, "b_b", torch.float32, (64,))
    _build.require(wk, "w_b", torch.bfloat16, (3, 3, 64, 64))
    out = torch.empty((b, h // 2, w // 2, c), dtype=torch.bfloat16,
                      device=y_raw.device)
    code = _build.library().stage_tail_bf16(
        _build.ptr(y_raw), _build.ptr(ba), _build.ptr(wk), _build.ptr(bb),
        _build.ptr(out), b, h, w, _build.stream_of(y_raw))
    _build.check(code, "stage_tail")
    stage_tail.launches += 1
    return out


stage_tail.launches = 0
