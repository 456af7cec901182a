"""SuperPoint's fused stage tail (kernel ``csrc/stage_tail.cu``) and fused
stem (kernel ``csrc/stem_tail.cu``), NHWC bf16 with float32 accumulation.

``stage_tail`` replaces ``imcui_tpu/ops/pallas_stage1.py:stage_tail``. It
computes

    maxpool2×2(relu(conv3×3(relu(y_raw + b_a); W_b) + b_b))

for the previous conv's output ``y_raw`` taken WITHOUT its bias. The SAME
zero padding of the 3×3 conv applies after the prologue's relu
(``relu(0 + b_a) ≠ 0``).

``stem_tail`` replaces ``imcui_tpu/ops/pallas_stage1.py:stem_tail`` and
``imcui_tpu/ops/pallas_conv.py:superpoint_stem_fused``, which compute one
function from the raw one-channel image:

    maxpool2×2(relu(conv3×3(relu(conv3×3(img; W_a) + b_a); W_b) + b_b))

with zero padding of the image for conv_a and of conv_a's activated output
for conv_b.
"""

import ctypes

import torch
import torch.nn.functional as F

from ..models.layers import full_fp32
from . import _build


def _taps_k_major(w_b):
    """W_b OIHW → (ky, kx, cout, cin) bf16: per tap, 64 K-major rows of
    input channels, the B operand of the kernels' products."""
    return w_b.permute(2, 3, 0, 1).to(torch.bfloat16).contiguous()


def conv_plan(b, h, w):
    """The launch either kernel takes on the current card for a (B, H, W)
    input: conv rows and columns of a tile, strips (64-column strips of the
    images), segments a strip is cut into, tiles a segment, CTAs (one an
    SM, at most one a segment), SMs, and the rounds of segments that makes."""
    out = (ctypes.c_int * 7)()
    code = _build.library().stage_conv_plan(b, h, w,
                                            ctypes.cast(out, ctypes.c_void_p))
    _build.check(code, "stage_conv_plan")
    rows, cols, strips, segs, tiles, ctas, sms = out
    return {"tile_rows": rows, "tile_cols": cols, "strips": strips,
            "segments_per_strip": segs, "segment_tiles": tiles,
            "ctas": ctas, "sms": sms, "rounds": strips * segs / ctas}


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
    wk = _taps_k_major(w_b)
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


def stem_conv_a_plain(image, w_a, b_a):
    """conv_a of the stem as ``_stem_xla`` runs it: bf16 operands, float32
    accumulation, bias and relu in float32, rounded to bf16. image:
    (B, H, W); w_a: (64, 1, 3, 3) OIHW → (B, 64, H, W) bf16."""
    x = image.to(torch.bfloat16).float()[:, None]
    with full_fp32():
        y = F.conv2d(x, w_a.to(torch.bfloat16).float(), b_a.float(), padding=1)
    return torch.relu(y).to(torch.bfloat16)


def stem_tail_plain(image, w_a, b_a, w_b, b_b):
    """Plain PyTorch version (``pallas_conv.py:_stem_xla``). image:
    (B, H, W) float32 or bf16; w_a: (64, 1, 3, 3), w_b: (64, 64, 3, 3)
    OIHW; b_a, b_b: (64,). Returns (B, H/2, W/2, 64) bf16 NHWC. conv_b,
    bias, relu and pool run in float32 on bf16 operands and round once."""
    y = stem_conv_a_plain(image, w_a, b_a).float()
    with full_fp32():
        z = torch.relu(F.conv2d(y, w_b.to(torch.bfloat16).float(),
                                b_b.float(), padding=1))
    out = F.max_pool2d(z, 2, 2)
    return out.to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()


def stem_tail(image, w_a, b_a, w_b, b_b):
    """The stem kernel (K6/K7) on CUDA tensors; the plain version on CPU
    tensors. Arguments as for ``stem_tail_plain``; H and W must be even."""
    if image.device.type == "cpu":
        return stem_tail_plain(image, w_a, b_a, w_b, b_b)
    if image.dim() != 3 or image.shape[1] % 2 or image.shape[2] % 2 \
            or image.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"stem_tail takes a (B, H, W) float32 or bfloat16 "
                         f"image with even H, W; got {tuple(image.shape)} "
                         f"{image.dtype}")
    b, h, w = image.shape
    _build.require(image, "image", image.dtype)
    if image.data_ptr() % 4:
        raise ValueError("image must be 4-byte aligned")
    # OIHW → (tap, cout), bf16-rounded values held in float32
    wa = w_a.to(torch.bfloat16).float().permute(2, 3, 1, 0).reshape(9, 64) \
        .contiguous()
    ba = b_a.float().contiguous()
    bb = b_b.float().contiguous()
    wk = _taps_k_major(w_b)
    _build.require(wa, "w_a", torch.float32, (9, 64))
    _build.require(ba, "b_a", torch.float32, (64,))
    _build.require(bb, "b_b", torch.float32, (64,))
    _build.require(wk, "w_b", torch.bfloat16, (3, 3, 64, 64))
    out = torch.empty((b, h // 2, w // 2, 64), dtype=torch.bfloat16,
                      device=image.device)
    code = _build.library().stem_tail_fwd(
        _build.ptr(image), _build.ptr(wa), _build.ptr(ba), _build.ptr(wk),
        _build.ptr(bb), _build.ptr(out), b, h, w,
        int(image.dtype == torch.bfloat16), _build.stream_of(image))
    _build.check(code, "stem_tail")
    stem_tail.launches += 1
    return out


stem_tail.launches = 0
