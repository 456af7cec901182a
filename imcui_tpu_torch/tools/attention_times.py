"""Times of the f32 attention kernels K3 (``fused_attention``) and K4
(``bidirectional_attention``, both ``csrc/attention.cu``) on the card, at
the shapes the serving paths give them:

    python -m imcui_tpu_torch.tools.attention_times [--plain]

- K3 at 16 x 1601 x 64 through ``mha_auto`` (a DINOv2 block at 560², the
  f32 dense path), unmasked;
- K3 at 32 x 1024 x 64 with key masks (LightGlue self-attention on the
  turbo path: 8 images x 4 heads);
- K4 at 16 x 1024 x 1024 (turbo cross-attention: 4 pairs x 4 heads) and at
  4 x 4096 x 4096 (the general path: one pair), with key masks.

Each shape is timed two ways, in ms: ``ms`` is the median of 20 launches
each between its own pair of CUDA events, as ``chip_smoke.py`` times every
kernel (it counts the wrapper's host time, since each launch finds the
card idle); ``queued_ms`` is 20 launches queued between one pair of
events, over 20 (the kernel alone). ``--plain`` adds the plain versions
and one SDPA call. Prints one JSON object: the card and its power limit,
then a record per shape with the launch plan where the package has one.
Use it to time one build against another in one call, in turns.
"""

import json
import subprocess
import sys

import torch
import torch.nn.functional as F

from ..models.layers import full_fp32
from ..ops import _build, attention
from .tail_probes import event_ms

ITERS = 20


def queued_ms(fn, iters=ITERS, warmup=3):
    """Device ms of one call of ``fn`` from ``iters`` calls queued between
    two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _masks(b, n, dev):
    m = torch.ones((b, n), dtype=torch.bool, device=dev)
    m[1 % b, n * 2 // 3:] = False
    if b > 2:
        m[2] = False               # an image without keypoints
    return m


def cases(dev, gen):
    """(name, kernel call, plain call, SDPA call, plan arguments)."""
    def rnd(s, n, scale=2.0):
        return torch.randn((s, n, 64), generator=gen, device=dev) * scale

    q, k, v = (rnd(16, 1601, 1.0) for _ in range(3))
    yield ("K3 16x1601 mha_auto", lambda: attention.mha_auto(q, k, v),
           lambda: attention.mha(q, k, v),
           lambda: F.scaled_dot_product_attention(q, k, v), (16, 1601))
    m8 = _masks(8, 1024, dev)
    add = torch.where(m8.repeat_interleave(4, 0), 0.0, -1e9)[:, None, :]
    q3, k3, v3 = (rnd(32, 1024) for _ in range(3))
    yield ("K3 32x1024 turbo",
           lambda: attention.fused_attention(q3, k3, v3, m8, 4),
           lambda: attention.fused_attention_plain(q3, k3, v3, m8, 4),
           lambda: F.scaled_dot_product_attention(
               q3, k3, v3, attn_mask=add.expand(32, 1024, 1024)),
           (32, 1024))
    for s, n in ((16, 1024), (4, 4096)):
        b = s // 4
        m0, m1 = _masks(b, n, dev), _masks(b, n, dev).flip(1)
        a0, a1, v0, v1 = (rnd(s, n) for _ in range(4))
        add01 = torch.where(m1.repeat_interleave(4, 0), 0.0, -1e9)[:, None, :]
        add10 = torch.where(m0.repeat_interleave(4, 0), 0.0, -1e9)[:, None, :]
        yield (f"K4 {s}x{n}x{n}",
               lambda: attention.bidirectional_attention(a0, a1, v0, v1, m0,
                                                         m1, 4),
               lambda: attention.bidirectional_attention_plain(
                   a0, a1, v0, v1, m0, m1, 4),
               lambda: (F.scaled_dot_product_attention(
                   a0, a1, v1, attn_mask=add01.expand(s, n, n)),
                   F.scaled_dot_product_attention(
                       a1, a0, v0, attn_mask=add10.expand(s, n, n))),
               (s, n, n))


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("attention_times needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _build.library()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    out = {"card": smi, "cases": {}}
    with full_fp32():
        for name, kernel, plain, sdpa, plan in cases(dev, gen):
            rec = {"ms": event_ms(kernel, ITERS, 3),
                   "queued_ms": queued_ms(kernel)}
            if "--plain" in argv:
                rec["plain_ms"] = event_ms(plain, ITERS, 3)
                rec["library_ms"] = event_ms(sdpa, ITERS, 3)
            if hasattr(attention, "attention_plan"):
                rec["plan"] = attention.attention_plan(*plan)
            out["cases"][name] = rec
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
