"""Times of the attention kernels on the card, at the shapes the serving
paths give them:

    python -m imcui_tpu_torch.tools.attention_times [--plain] [--only K5]

- K3 (``fused_attention``, ``csrc/attention.cu``) at 16 x 1601 x 64
  through ``mha_auto`` (a DINOv2 block at 560², the f32 dense path),
  unmasked;
- K3 at 32 x 1024 x 64 with key masks (LightGlue self-attention on the
  turbo path: 8 images x 4 heads);
- K4 (``bidirectional_attention``, the same source) at 16 x 1024 x 1024
  (turbo cross-attention: 4 pairs x 4 heads) and at 4 x 4096 x 4096 (the
  general path: one pair), with key masks;
- K5 (``flash_attention``, entry ``csrc/flash_attention.cu``) at 8 x 4096
  x 4096 x 64 with key masks (LightGlue self-attention on the general path:
  one pair x 4 heads), in float32 (the path's launch) and bf16, and at 8 x
  2048 x 2048 x 128 in both types;
- K14 (``qtiled_attention``, ``csrc/qtiled_attention.cu``) at 16 x 1601 x
  64 (a DINOv2 block at 560², the bf16 dense path) and 16 x 1024 x 64,
  bf16.

Each shape is timed two ways, in ms: ``ms`` is the median of 20 launches
each between its own pair of CUDA events, as ``chip_smoke.py`` times every
kernel (it counts the wrapper's host time, since each launch finds the
card idle); ``queued_ms`` is 20 launches queued behind a spin kernel
between one pair of events, over 20 (the kernel alone). ``--plain`` adds the
plain versions and the library call: SDPA on a 4-D view of the same inputs
on the fused backend that takes it (``time_sdpa``). Prints one JSON object:
the card and its power limit, then a record per shape with the launch plan.
``--only PREFIX`` keeps the shapes whose name starts with PREFIX. Use it to
time one build against another in one call, in turns.
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
    two CUDA events behind a spin kernel (``torch.cuda._sleep``) that lasts
    until the host has queued them all, so that a kernel shorter than its
    wrapper's host time is timed alone too; the spin doubles until it does
    (the start event still pending once the last call is queued)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    cycles = 1 << 21
    while True:
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        behind = not start.query()
        end.synchronize()
        if behind or cycles >= 1 << 28:
            return start.elapsed_time(end) / iters
        cycles *= 2


def sdpa_views(q, k, v, key_mask=None, heads=1):
    """The arguments of one SDPA call that computes the port's attention of
    (S, N, Dh) head-sequences: a 4-D view, (1, S, N, Dh) without a mask,
    else (B, heads, N, Dh) with ``key_mask`` (B, Nk) bool as an additive
    mask (B, 1, 1, Nk) of 0 and -1e9 in q's dtype. PyTorch's fused SDPA
    backends take only 4-D inputs."""
    if key_mask is None:
        return q[None], k[None], v[None], None
    b = key_mask.shape[0]
    views = (t.view(b, heads, *t.shape[1:]) for t in (q, k, v))
    add = torch.zeros(key_mask.shape, dtype=q.dtype, device=q.device)
    add.masked_fill_(~key_mask, attention.NEG_INF)
    return (*views, add[:, None, None, :])


def time_sdpa(timer, *calls):
    """The library time of a kernel launch: ``calls`` are the (q, k, v,
    key_mask, heads) of the SDPA calls that compute it, each on its 4-D
    view, timed together by ``timer`` under the fused backend that takes
    them: flash for unmasked bf16/fp16, memory-efficient for float32 and
    masked calls. Where that backend refuses one, the math path is timed
    and named. Returns {"ms", "backend"}."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    views = [sdpa_views(*c) for c in calls]
    fused = {SDPBackend.FLASH_ATTENTION
             if add is None and q.dtype in (torch.float16, torch.bfloat16)
             else SDPBackend.EFFICIENT_ATTENTION
             for q, _, _, add in views}
    fused = sorted(fused, key=lambda b: b.name)

    def run():
        return [F.scaled_dot_product_attention(q, k, v, attn_mask=add)
                for q, k, v, add in views]

    try:
        with sdpa_kernel(fused):
            run()
            torch.cuda.synchronize()
            ms = timer(run)
        backend = "+".join(b.name.lower() for b in fused)
    except RuntimeError as exc:
        with sdpa_kernel([SDPBackend.MATH]):
            ms = timer(run)
        backend = (f"math ({'+'.join(b.name.lower() for b in fused)} "
                   f"refused: {str(exc).splitlines()[0][:80]})")
    return {"ms": ms, "backend": backend}


def _masks(b, n, dev):
    m = torch.ones((b, n), dtype=torch.bool, device=dev)
    m[1 % b, n * 2 // 3:] = False
    if b > 2:
        m[2] = False               # an image without keypoints
    return m


def cases(dev, gen):
    """(name, kernel call, plain call, SDPA calls, launch plan thunk)."""
    def rnd(s, n, scale=2.0, dtype=torch.float32, dh=64):
        return (torch.randn((s, n, dh), generator=gen, device=dev) * scale
                ).to(dtype)

    q, k, v = (rnd(16, 1601, 1.0) for _ in range(3))
    yield ("K3 16x1601 mha_auto", lambda: attention.mha_auto(q, k, v),
           lambda: attention.mha(q, k, v), [(q, k, v)],
           lambda: attention.attention_plan(16, 1601))
    m8 = _masks(8, 1024, dev)
    q3, k3, v3 = (rnd(32, 1024) for _ in range(3))
    yield ("K3 32x1024 turbo",
           lambda: attention.fused_attention(q3, k3, v3, m8, 4),
           lambda: attention.fused_attention_plain(q3, k3, v3, m8, 4),
           [(q3, k3, v3, m8, 4)], lambda: attention.attention_plan(32, 1024))
    for s, n in ((16, 1024), (4, 4096)):
        b = s // 4
        m0, m1 = _masks(b, n, dev), _masks(b, n, dev).flip(1)
        a0, a1, v0, v1 = (rnd(s, n) for _ in range(4))
        yield (f"K4 {s}x{n}x{n}",
               lambda: attention.bidirectional_attention(a0, a1, v0, v1, m0,
                                                         m1, 4),
               lambda: attention.bidirectional_attention_plain(
                   a0, a1, v0, v1, m0, m1, 4),
               [(a0, a1, v1, m1, 4), (a1, a0, v0, m0, 4)],
               lambda: attention.attention_plan(s, n, n))
    for n, dh in ((4096, 64), (2048, 128)):
        m2 = _masks(2, n, dev)
        for dtype in (torch.float32, torch.bfloat16):
            q5, k5, v5 = (rnd(8, n, 2.0, dtype, dh) for _ in range(3))
            yield (f"K5 8x{n}x{dh} {str(dtype)[6:]}",
                   lambda: attention.flash_attention(q5, k5, v5, m2, 4),
                   lambda: attention.flash_attention_plain(q5, k5, v5, m2, 4),
                   [(q5, k5, v5, m2, 4)],
                   lambda: attention.flash_plan(8, n, dh, dtype))
    for n in (1601, 1024):
        qb, kb, vb = (rnd(16, n, 1.5, torch.bfloat16) for _ in range(3))
        yield (f"K14 16x{n} bf16",
               lambda: attention.qtiled_attention(qb, kb, vb),
               lambda: attention.qtiled_attention_plain(qb, kb, vb),
               [(qb, kb, vb)], lambda: attention.qtiled_plan(16, n, n))


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
        only = argv[argv.index("--only") + 1] if "--only" in argv else ""
        for name, kernel, plain, sdpa_calls, plan in cases(dev, gen):
            if not name.startswith(only):
                continue
            rec = {"ms": event_ms(kernel, ITERS, 3),
                   "queued_ms": queued_ms(kernel)}
            if "--plain" in argv:
                rec["plain_ms"] = event_ms(plain, ITERS, 3)
                lib = time_sdpa(lambda f: event_ms(f, ITERS, 3), *sdpa_calls)
                rec.update(library_ms=lib["ms"],
                           library_backend=lib["backend"],
                           library_queued_ms=time_sdpa(
                               queued_ms, *sdpa_calls)["ms"])
            rec["plan"] = plan()
            out["cases"][name] = rec
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
