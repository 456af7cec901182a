"""Times of SuperPoint's kernels on the card, at the shapes the serving
paths give them:

    python -m imcui_tpu_torch.tools.conv_times [--plain] [--only K1]
                                               [--skip N]

- the stem (K6/K7, ``stem_tail``, ``csrc/stem_tail.cu``) at 8 x 1024 x 1024
  in bf16 (K6's input) and float32 (K7's): stage 1 of the turbo step's 4
  pairs; and at 1 x 1280 x 2048 bf16: the general path's canvas;
- K1 (``stage_tail``, ``csrc/stage_tail.cu``) at 8 x 512 x 512 x 64 (the
  turbo step's stage 2) and 1 x 640 x 1024 x 64 (the general path's).
  K2, the other SuperPoint kernel, has its own loop, ``nms_times``.

K1 and the stem share the tensor-core tile of ``csrc/stage_conv.cuh``.
Each shape is timed as ``attention_times`` times: ``ms`` is the median of
20 launches each between its own pair of CUDA events (the wrapper's host
time included), ``queued_ms`` 20 launches queued behind a spin kernel
(the kernel alone). ``bound_ms`` is the larger of the operations over the
bf16 tensor-core peak and the compulsory bytes over the memory rate of an
H100 SXM (989 TFLOP/s, 3.35 TB/s). ``--plain`` adds the plain version and
the library call: cuDNN in bf16, channels last, on the same inputs (the
stem: conv, relu, conv, relu, pool; K1: relu(y + b_a), conv, relu, pool).
``--only PREFIX`` keeps the shapes whose name starts with PREFIX.
``--skip N`` builds the kernels with ``-DSTAGE_CONV_SKIP=N``, a sum of
parts to leave out (1 the prologue's arithmetic, 2 conv_b's wgmma, 4 the
prologue's loads, 8 the epilogue; each kept on a CTA's first tile) to say
what bounds them. Prints one JSON object: the card and its power limit,
the skip build, a record per shape with the launch plan. To time the
parent's kernels in turns, copy this file into the parent's package and
run it from there (without ``conv_plan`` there, the records carry no
plan).
"""

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..models.layers import full_fp32
from ..ops import _build, cuda_stage1
from .attention_times import queued_ms
from .tail_probes import event_ms

ITERS = 20
PEAK_BF16, PEAK_BW = 989e12, 3.35e12


def bound(flops, nbytes):
    """Least time in ms and what sets it."""
    t_ops, t_mem = flops / PEAK_BF16 * 1e3, nbytes / PEAK_BW * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


def _weights(gen, dev):
    def rnd(shape, scale):
        return torch.randn(shape, generator=gen, device=dev) * scale

    return (rnd((64, 1, 3, 3), 0.3), rnd(64, 0.1), rnd((64, 64, 3, 3), 0.05),
            rnd(64, 0.1))


def _cudnn(w_a, b_a, w_b, b_b, dev):
    """Channels-last bf16 cuDNN convolutions with these weights."""
    conv_a = torch.nn.Conv2d(1, 64, 3, padding=1)
    conv_b = torch.nn.Conv2d(64, 64, 3, padding=1)
    with torch.no_grad():
        conv_a.weight.copy_(w_a.cpu())
        conv_a.bias.copy_(b_a.cpu())
        conv_b.weight.copy_(w_b.cpu())
        conv_b.bias.copy_(b_b.cpu())
    return tuple(c.to(dev, torch.bfloat16).to(
        memory_format=torch.channels_last) for c in (conv_a, conv_b))


def cases(dev, gen):
    """(name, kernel call, plain call, library call, bound, plan thunk)."""
    w_a, b_a, w_b, b_b = _weights(gen, dev)
    conv_a, conv_b = _cudnn(w_a, b_a, w_b, b_b, dev)
    plan = getattr(cuda_stage1, "conv_plan", None)
    for b, h, w, dtype in ((8, 1024, 1024, torch.bfloat16),
                           (8, 1024, 1024, torch.float32),
                           (1, 1280, 2048, torch.bfloat16)):
        img = torch.rand((b, h, w), generator=gen, device=dev).to(dtype)
        x = img.to(torch.bfloat16)[:, None].contiguous(
            memory_format=torch.channels_last)
        flops = 2.0 * b * h * w * (9 * 64 + 9 * 64 * 64)
        nbytes = img.numel() * img.element_size() \
            + b * (h // 2) * (w // 2) * 64 * 2 + 9 * 64 * 64 * 2 \
            + 9 * 64 * 4 + 2 * 64 * 4
        yield (f"{'K6' if dtype == torch.bfloat16 else 'K7'} stem "
               f"{b}x{h}x{w} {str(dtype)[6:]}",
               lambda: cuda_stage1.stem_tail(img, w_a, b_a, w_b, b_b),
               lambda: cuda_stage1.stem_tail_plain(img, w_a, b_a, w_b, b_b),
               lambda: F.max_pool2d(torch.relu(conv_b(torch.relu(conv_a(
                   x)))), 2, 2),
               bound(flops, nbytes),
               (lambda: plan(b, h, w)) if plan else None)
    b_a16 = b_a.to(torch.bfloat16).view(1, -1, 1, 1)
    for b, h, w in ((8, 512, 512), (1, 640, 1024)):
        y = (torch.randn((b, h, w, 64), generator=gen, device=dev) * 0.5
             ).to(torch.bfloat16)
        y_nchw = y.permute(0, 3, 1, 2)    # channels-last view of y
        flops = 2.0 * b * h * w * 9 * 64 * 64
        nbytes = y.numel() * 2 + b * (h // 2) * (w // 2) * 64 * 2 \
            + 9 * 64 * 64 * 2 + 2 * 64 * 4
        yield (f"K1 {b}x{h}x{w}",
               lambda: cuda_stage1.stage_tail(y, b_a, w_b, b_b),
               lambda: cuda_stage1.stage_tail_plain(y, b_a, w_b, b_b),
               lambda: F.max_pool2d(torch.relu(conv_b(torch.relu(
                   y_nchw + b_a16))), 2, 2),
               bound(flops, nbytes),
               (lambda: plan(b, h, w)) if plan else None)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("conv_times needs a CUDA device")
    skip = int(argv[argv.index("--skip") + 1]) if "--skip" in argv else 0
    if skip:
        _build.FLAGS.append(f"-DSTAGE_CONV_SKIP={skip}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    only = argv[argv.index("--only") + 1] if "--only" in argv else ""
    out = {"card": smi, "skip": skip, "cases": {}}
    with full_fp32(), torch.no_grad():
        for name, kernel, plain, library, (t, by), plan in cases(dev, gen):
            if not name.startswith(only):
                continue
            rec = {"ms": event_ms(kernel, ITERS, 3),
                   "queued_ms": queued_ms(kernel), "bound_ms": t,
                   "bound_by": by}
            if "--plain" in argv:
                rec["plain_ms"] = event_ms(plain, 5, 1)
                if library is not None:
                    rec.update(library_ms=event_ms(library, ITERS, 3),
                               library_queued_ms=queued_ms(library))
            if plan is not None:
                rec["plan"] = plan()
            out["cases"][name] = rec
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
