"""Times of K2 (``nms_cellmax``, ``csrc/nms_cellmax.cu``) on the card, at
the shapes the serving paths give it:

    python -m imcui_tpu_torch.tools.nms_times [--plain] [--skip N]

- 8 x 1024 x 1024 at radius 4: the turbo step's heatmaps (4 pairs);
- 1 x 1280 x 2048 at radius 4: one launch of the general path (one image
  on its 1600 x 1200 canvas);
- 2 x 1536 x 2048 at radius 3 (``superpoint_aachen``'s and
  ``superpoint_max``'s radius on 2048-px images).

Each is timed as ``attention_times`` times: ``ms`` is the median of 20
launches each between its own pair of CUDA events (the wrapper's host time
included), ``queued_ms`` 20 launches queued behind a spin kernel (the
kernel alone). ``bound_ms`` is the larger of the compulsory bytes (the bf16
heat read once, both f32 cell maps written once) over the memory rate and
the operations (``work``) over the packed-bf16 rate of an H100 SXM. There
is no library call of this function. ``--plain`` adds the plain version.
``--skip N`` builds the kernel with ``-DNMS_SKIP=N``, a sum of parts to
leave out on every block but the grid's first (1 the global loads, 2 the
value windows, 4 the mask dilations, 8 the cell reduction) to say what
bounds it. Prints one JSON object: the card and its power limit, the skip
build, a record per shape with the launch plan. To time the parent's
kernel in turns, copy this file into a ``git archive`` of the parent's
package and run it from there (without ``nms_plan`` there, the records
carry no plan).
"""

import json
import subprocess
import sys

import torch

from ..ops import _build, cuda_nms
from .attention_times import queued_ms
from .tail_probes import event_ms

ITERS = 20
PEAK_BW = 3.35e12
# Packed bf16 max and compare: two results a lane a clock at the float32
# FMA unit's issue rate, 67e12 a second on an H100 SXM.
PEAK_BF16X2 = 67e12
SHAPES = ((8, 1024, 1024, 4), (1, 1280, 2048, 4), (2, 1536, 2048, 3))


def work(b, h, w, radius):
    """(bytes, operations) K2 must move and do at (B, H, W, radius): the
    bf16 heat read once and both float32 cell maps written once; the
    maxes, compares and mask operations of the chain a pixel with the
    kernel's window method, without its halos: three value windows, each
    r + 1/2 maxes vertically (two rows share 2r) and r + (r + 3)/4
    horizontally (r pair maxes shared by four words, plus one) and a
    compare; two dilations of 8-pixel masks, (r + 1/2) ORs and 2(2r + 1)
    shifts and ORs an 8-pixel byte, and a select a pixel; one compare a
    pixel in the cell reduction."""
    r = radius
    per_px = 3 * ((r + 0.5) + (r + (r + 3) / 4) + 1) \
        + 2 * ((r + 0.5 + 2 * (2 * r + 1)) / 8 + 1) + 1
    nbytes = b * h * w * 2 + 2 * b * (h // 4) * (w // 4) * 4 + b * 8
    return nbytes, per_px * b * h * w


def bound(b, h, w, radius):
    """Least time in ms, what sets it, and the two times."""
    nbytes, ops = work(b, h, w, radius)
    t_mem, t_ops = nbytes / PEAK_BW * 1e3, ops / PEAK_BF16X2 * 1e3
    return {"bound_ms": max(t_mem, t_ops),
            "bound_by": "operations" if t_ops >= t_mem else "bytes",
            "bytes_ms": t_mem, "operations_ms": t_ops}


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("nms_times needs a CUDA device")
    skip = int(argv[argv.index("--skip") + 1]) if "--skip" in argv else 0
    if skip:
        _build.FLAGS.append(f"-DNMS_SKIP={skip}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    plan = getattr(cuda_nms, "nms_plan", None)
    out = {"card": smi, "skip": skip, "cases": {}}
    for b, h, w, radius in SHAPES:
        heat = torch.rand((b, h, w), generator=gen, device=dev
                          ).to(torch.bfloat16)
        vwh = torch.tensor([[[w, h], [w - 48, h - 32]][i % 2]
                            for i in range(b)], dtype=torch.int32, device=dev)

        def kernel():
            return cuda_nms.nms_cellmax(heat, vwh, radius=radius)

        rec = {"ms": event_ms(kernel, ITERS, 3),
               "queued_ms": queued_ms(kernel), **bound(b, h, w, radius)}
        if "--plain" in argv:
            rec["plain_ms"] = event_ms(
                lambda: cuda_nms.nms_cellmax_plain(heat, vwh, radius=radius),
                5, 1)
        if plan is not None:
            rec["plan"] = plan(b, h, w, radius)
        out["cases"][f"K2 {b}x{h}x{w} r{radius}"] = rec
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
