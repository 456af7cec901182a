#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (imcui_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which passes or ends the run with a non-zero exit:
  0. the card's name and power limit, the versions, the kernels' build;
  1. every CUDA kernel of the serving path at the serving path's shapes,
     held against its plain PyTorch version, timed beside it, beside a
     PyTorch library call of the same function where one exists, and
     beside the least time the card could take (its bound);
  2. serving: TurboMatcher(device="cuda") at the flagship configuration
     answers concurrent requests (synthetic textured images and their
     warps under known homographies); the kernels' launch counters must
     have advanced as the path runs them, and the verified matches must
     agree with the planted homographies;
  3. timing of match_step at bench.py's operating point: pairs/s, the
     per-stage split, and a short profiler window (device time by kernel,
     device idle share).
Near the end it prints one JSON line {"timing": ...}, one {"kernels":
[...]} and the card's name and power limit; the last line is {"ok": true,
"device": {...}}. Without a CUDA device, or without the rest of the
repository beside it, the script fails before printing any result.
"""

import json
import os
import subprocess
import sys
import threading
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Published dense peaks (NVIDIA data sheets): bf16 tensor-core FLOP/s,
# float32 non-tensor FLOP/s, HBM bytes/s.
PEAKS = {
    "sxm": {"bf16": 989e12, "fp32": 67e12, "bw": 3.35e12},
    "pcie": {"bf16": 756e12, "fp32": 51e12, "bw": 2.0e12},
    "nvl": {"bf16": 835e12, "fp32": 60e12, "bw": 3.9e12},
}

# Serving configuration (the flagship) and bench.py's operating point.
CANVAS, MAX_KPTS, N_LAYERS, BATCH, HYPOTHESES = 1024, 1024, 9, 4, 512
HEADS = 4
# Gate on the planted homographies, per request: set from the JAX
# package's result on such a pair on the CPU (PERF.md, "serving gate").
GATE_MEDIAN_PX = 2.0
GATE_MIN_INLIERS = 50
# Original sizes of the requests: none a multiple of 8, so the area
# resize runs; the first is larger than the canvas.
REQUEST_SIZES = [(1203, 901), (1003, 757), (997, 1013), (851, 643)]
N_REQUESTS, N_THREADS = 8, 4


def fail(msg):
    print(f"FAIL: {msg}", flush=True)
    sys.exit(1)


def log(msg):
    print(msg, flush=True)


# --------------------------------------------------------------------------
# synthetic requests
# --------------------------------------------------------------------------

def textured_image(rng, h, w):
    """Grayscale uint8 (h, w): smoothed multi-scale noise under many
    overlapping rectangles, whose corners are what SuperPoint detects."""
    from scipy import ndimage

    img = np.zeros((h, w), np.float64)
    for sigma, amp in ((2.0, 0.3), (8.0, 0.6), (24.0, 1.0)):
        n = ndimage.gaussian_filter(rng.standard_normal((h, w)), sigma)
        img += amp * n / (n.std() + 1e-9)
    for _ in range(int(h * w / 1500)):
        y0, x0 = rng.integers(0, h), rng.integers(0, w)
        s = rng.integers(8, 48)
        img[y0:y0 + s, x0:x0 + int(s * rng.uniform(0.5, 2))] += \
            rng.uniform(-3, 3)
    img = ndimage.gaussian_filter(img, 0.7)
    img = (img - img.min()) / (img.max() - img.min() + 1e-9)
    return (img * 255).astype(np.uint8)


def random_homography(rng, h, w):
    """A moderate viewpoint change about the image centre: rotation up to
    10°, scale 0.85–1.15, a little perspective and translation."""
    a = np.deg2rad(rng.uniform(-10, 10))
    s = rng.uniform(0.85, 1.15)
    c = np.array([w / 2, h / 2])
    rot = np.array([[s * np.cos(a), -s * np.sin(a)],
                    [s * np.sin(a), s * np.cos(a)]])
    t = c - rot @ c + rng.uniform(-0.04, 0.04, 2) * np.array([w, h])
    hm = np.eye(3)
    hm[:2, :2] = rot
    hm[:2, 2] = t
    hm[2, :2] = rng.uniform(-1e-4, 1e-4, 2)
    return hm


def warp_image(img, hm, out_hw):
    """img warped by hm (img coords → output coords), bilinear, 0 outside."""
    from scipy import ndimage

    h, w = out_hw
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    pts = np.stack([xx.ravel(), yy.ravel(), np.ones(h * w)])
    src = np.linalg.inv(hm) @ pts
    src = src[:2] / src[2]
    out = ndimage.map_coordinates(img.astype(np.float64), [src[1], src[0]],
                                  order=1, cval=0.0)
    return out.reshape(h, w).astype(np.uint8)


def synthetic_pair(seed, w, h):
    """(image0 RGB uint8, image1 RGB uint8, H: image0 px → image1 px)."""
    rng = np.random.default_rng(seed)
    img0 = textured_image(rng, h, w)
    hm = random_homography(rng, h, w)
    img1 = warp_image(img0, hm, (h, w))
    return (np.repeat(img0[..., None], 3, -1),
            np.repeat(img1[..., None], 3, -1), hm)


def transfer_errors(hm, mk0, mk1):
    """|H·mk0 − mk1| in px for (n, 2) correspondences."""
    p = np.concatenate([mk0, np.ones((len(mk0), 1))], 1) @ hm.T
    return np.linalg.norm(p[:, :2] / p[:, 2:] - mk1, axis=1)


# --------------------------------------------------------------------------
# measurement helpers
# --------------------------------------------------------------------------

def cuda_ms(fn, iters=20, warmup=3):
    """Median device time of ``fn`` in ms (CUDA events, one per run)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def card_peaks(name):
    low = name.lower()
    if "pcie" in low:
        return "pcie", PEAKS["pcie"]
    if "nvl" in low:
        return "nvl", PEAKS["nvl"]
    return "sxm", PEAKS["sxm"]


def bound(flops, nbytes, peak_flops, peaks):
    """Least time in ms: the larger of compulsory bytes over HBM rate and
    the operations over the peak rate for their type."""
    t_ops = flops / peak_flops * 1e3
    t_mem = nbytes / peaks["bw"] * 1e3
    return max(t_ops, t_mem), ("operations" if t_ops >= t_mem else "bytes")


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase0():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    smi_line = smi.stdout.strip().splitlines()[0]
    log(smi_line)
    from imcui_tpu_torch.ops import _build

    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    log(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc: {nvcc}")
    t0 = time.perf_counter()
    _build.library()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.build_seconds if _build.build_seconds else 0:.1f} s; "
        f"0 = already built)")
    return smi_line


def phase1(params, peaks):
    """Each kernel against its plain version at the serving shapes."""
    import torch
    import torch.nn.functional as F

    from imcui_tpu_torch.models.layers import full_fp32
    from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    sp = params["superpoint"]
    rows = []

    # K1: stage_tail at both stages of 2·BATCH images
    b = 2 * BATCH
    k1 = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0,
          "max_abs_err": 0.0, "max_plain": 0.0, "flops": 0.0, "bytes": 0.0}
    for pa, pb, hw in (("conv1a", "conv1b", CANVAS),
                       ("conv2a", "conv2b", CANVAS // 2)):
        y = (torch.randn((b, hw, hw, 64), generator=gen, device=dev) * 0.5
             ).to(torch.bfloat16)
        ba, wb, bb = sp[pa]["b"], sp[pb]["w"], sp[pb]["b"]
        with full_fp32():
            got = cuda_stage1.stage_tail(y, ba, wb, bb)
            want = cuda_stage1.stage_tail_plain(y, ba, wb, bb)
            torch.cuda.synchronize()
            diff = (got.float() - want.float()).abs()
            # one bf16 rounding step of the result: 2^-7 relative
            tol = 1e-3 + 2.0 ** -7 * want.float().abs()
            if not bool((diff <= tol).all()):
                fail(f"stage_tail {hw}: max |err| {diff.max().item()} over "
                     f"tolerance (1e-3 + 2^-7·|plain|)")
            k1["max_abs_err"] = max(k1["max_abs_err"], diff.max().item())
            k1["max_plain"] = max(k1["max_plain"],
                                  want.float().abs().max().item())
            k1["ms"] += cuda_ms(lambda: cuda_stage1.stage_tail(y, ba, wb, bb))
            k1["plain_ms"] += cuda_ms(
                lambda: cuda_stage1.stage_tail_plain(y, ba, wb, bb))
        # library yardstick: bf16 channels-last cuDNN conv + relu + pool
        y_nchw = y.permute(0, 3, 1, 2)
        ba16, wb16, bb16 = (t.to(torch.bfloat16) for t in (ba, wb, bb))
        wb16 = wb16.contiguous(memory_format=torch.channels_last)
        k1["library_ms"] += cuda_ms(lambda: F.max_pool2d(torch.relu(F.conv2d(
            torch.relu(y_nchw + ba16.view(1, -1, 1, 1)), wb16, bb16,
            padding=1)), 2, 2))
        flops = 2.0 * b * hw * hw * 9 * 64 * 64
        nbytes = b * hw * hw * 64 * 2 + b * (hw // 2) ** 2 * 64 * 2 \
            + 9 * 64 * 64 * 2 + 2 * 64 * 4
        t, _ = bound(flops, nbytes, peaks["bf16"], peaks)
        k1["bound_ms"] += t
        k1["flops"] += flops
        k1["bytes"] += nbytes
        del y, got, want, diff, tol, y_nchw
        torch.cuda.empty_cache()
    rows.append({
        "name": "stage_tail", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/stage_tail.cu",
        "replaces": "imcui_tpu/ops/pallas_stage1.py:164",
        "launches_per_step": 2, "tolerance": "1e-3 + 2^-7*|plain| (bf16)",
        "max_abs_err": k1["max_abs_err"],
        "rel_err": k1["max_abs_err"] / k1["max_plain"], "ms": k1["ms"],
        "plain_ms": k1["plain_ms"], "library_ms": k1["library_ms"],
        "bound_ms": k1["bound_ms"], "bound_by": "operations"
        if k1["flops"] / peaks["bf16"] >= k1["bytes"] / peaks["bw"]
        else "bytes"})

    # K2: nms_cellmax on a heatmap of 2·BATCH canvases, some part-valid
    heat = torch.rand((b, CANVAS, CANVAS), generator=gen, device=dev
                      ).to(torch.bfloat16)
    vwh = torch.tensor([[CANVAS, CANVAS], [1000, 752], [1024, 760],
                        [848, 640]] * (b // 4), dtype=torch.int32, device=dev)
    cm, cs = cuda_nms.nms_cellmax(heat, vwh)
    pm, ps = cuda_nms.nms_cellmax_plain(heat, vwh)
    torch.cuda.synchronize()
    err = max((cm - pm).abs().max().item(), (cs - ps).abs().max().item())
    if err != 0.0:
        fail(f"nms_cellmax differs from its plain version: {err}")
    nbytes = b * CANVAS * CANVAS * 2 + 2 * b * (CANVAS // 4) ** 2 * 4 + b * 8
    t, by = bound(0.0, nbytes, peaks["fp32"], peaks)
    rows.append({
        "name": "nms_cellmax", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/nms_cellmax.cu",
        "replaces": "imcui_tpu/ops/pallas_nms.py:243",
        "launches_per_step": 1, "tolerance": "exact", "max_abs_err": err,
        "rel_err": err / pm.abs().max().item(),
        "ms": cuda_ms(lambda: cuda_nms.nms_cellmax(heat, vwh)),
        "plain_ms": cuda_ms(lambda: cuda_nms.nms_cellmax_plain(heat, vwh)),
        "library_ms": None, "bound_ms": t, "bound_by": by})
    del heat

    # K3 / K4: LightGlue attention at 1024 keypoints, f32
    n, dh = MAX_KPTS, 64
    mask_img = torch.ones((b, n), dtype=torch.bool, device=dev)
    mask_img[1, 700:] = False
    mask_img[2, :] = False          # an image without keypoints
    mask_img[5, 300:] = False

    def rnd(s, rows_):
        return torch.randn((s, rows_, dh), generator=gen, device=dev) * 2.0

    def check(name, got, want):
        """(max abs error, that over max|plain|); fails past the
        tolerance: f32 with the sums in another order."""
        top = max(w.abs().max().item() for w in want)
        e = max((g - w).abs().max().item() for g, w in zip(got, want))
        if e > 1e-5 * max(1.0, top):
            fail(f"{name}: max |err| {e} over 1e-5 · max(1, max|plain|)")
        return e, e / top

    s = b * HEADS
    q, k, v = rnd(s, n), rnd(s, n), rnd(s, n)
    with full_fp32():
        e3, rel3 = check("fused_attention",
                   [attention.fused_attention(q, k, v, mask_img, HEADS)],
                   [attention.fused_attention_plain(q, k, v, mask_img, HEADS)])
        ms3 = cuda_ms(lambda: attention.fused_attention(q, k, v, mask_img,
                                                        HEADS))
        plain3 = cuda_ms(lambda: attention.fused_attention_plain(
            q, k, v, mask_img, HEADS))
    add3 = torch.where(mask_img.repeat_interleave(HEADS, 0), 0.0, -1e9
                       )[:, None, :].expand(s, n, n)
    lib3 = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v,
                                                          attn_mask=add3))
    flops3 = 4.0 * s * n * n * dh
    bytes3 = 4 * s * n * dh * 4 + b * n
    t3, by3 = bound(flops3, bytes3, peaks["fp32"], peaks)
    rows.append({
        "name": "fused_attention", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/attention.cu",
        "replaces": "imcui_tpu/ops/attention.py:263",
        "launches_per_step": N_LAYERS, "tolerance": "1e-5*max(1,|plain|)",
        "max_abs_err": e3, "rel_err": rel3, "ms": N_LAYERS * ms3,
        "plain_ms": N_LAYERS * plain3, "library_ms": N_LAYERS * lib3,
        "bound_ms": N_LAYERS * t3, "bound_by": by3})
    del q, k, v, add3

    s = BATCH * HEADS
    m0, m1 = mask_img[:BATCH], mask_img[BATCH:]
    a0, a1, v0, v1 = rnd(s, n), rnd(s, n), rnd(s, n), rnd(s, n)
    with full_fp32():
        e4, rel4 = check("bidirectional_attention",
                   attention.bidirectional_attention(a0, a1, v0, v1, m0, m1,
                                                     HEADS),
                   attention.bidirectional_attention_plain(a0, a1, v0, v1,
                                                           m0, m1, HEADS))
        ms4 = cuda_ms(lambda: attention.bidirectional_attention(
            a0, a1, v0, v1, m0, m1, HEADS))
        plain4 = cuda_ms(lambda: attention.bidirectional_attention_plain(
            a0, a1, v0, v1, m0, m1, HEADS))
    add01 = torch.where(m1.repeat_interleave(HEADS, 0), 0.0, -1e9
                        )[:, None, :].expand(s, n, n)
    add10 = torch.where(m0.repeat_interleave(HEADS, 0), 0.0, -1e9
                        )[:, None, :].expand(s, n, n)
    lib4 = cuda_ms(lambda: (
        F.scaled_dot_product_attention(a0, a1, v1, attn_mask=add01),
        F.scaled_dot_product_attention(a1, a0, v0, attn_mask=add10)))
    flops4 = s * (2.0 * n * n * dh + 2 * 2.0 * n * n * dh)   # minimal work
    bytes4 = 6 * s * n * dh * 4 + 2 * BATCH * n
    t4, by4 = bound(flops4, bytes4, peaks["fp32"], peaks)
    rows.append({
        "name": "bidirectional_attention", "route": "cuda",
        "source": "imcui_tpu_torch/csrc/attention.cu",
        "replaces": "imcui_tpu/ops/attention.py:385",
        "launches_per_step": N_LAYERS, "tolerance": "1e-5*max(1,|plain|)",
        "max_abs_err": e4, "rel_err": rel4, "ms": N_LAYERS * ms4,
        "plain_ms": N_LAYERS * plain4, "library_ms": N_LAYERS * lib4,
        "bound_ms": N_LAYERS * t4, "bound_by": by4,
        "bound_ms_with_recompute": N_LAYERS * bound(
            flops4 * 4 / 3, bytes4, peaks["fp32"], peaks)[0]})
    for r in rows:
        r["kernel_ms"] = r["ms"]
        log(f"  {r['name']}: err {r['max_abs_err']:.3g} (relative "
            f"{r['rel_err']:.3g}; tolerance {r['tolerance']}), "
            f"{r['ms']:.3f} ms/step vs plain {r['plain_ms']:.3f}, library "
            f"{r['library_ms']}, bound {r['bound_ms']:.4f} ({r['bound_by']})")
    return rows


def phase2():
    """Serving through TurboMatcher: counters and the homography gate."""
    import torch

    from imcui_tpu_torch.api.turbo import TurboMatcher
    from imcui_tpu_torch.ops import attention, cuda_nms, cuda_stage1

    tm = TurboMatcher(device="cuda", canvas=CANVAS, max_keypoints=MAX_KPTS,
                      n_layers=N_LAYERS, batch_size=BATCH,
                      num_hypotheses=HYPOTHESES)
    log(f"  weights: {tm.meta}")
    if not (tm.meta["superpoint"]["pretrained"]
            and tm.meta["lightglue"]["pretrained"]):
        fail("serving did not load the weights/ npz trees")
    pairs = [synthetic_pair(100 + i, *REQUEST_SIZES[i % len(REQUEST_SIZES)])
             for i in range(N_REQUESTS)]
    batches = [0]
    run = tm._batcher.run_batch

    def counted(items):
        batches[0] += 1
        return run(items)

    tm._batcher.run_batch = counted
    kernels = (cuda_stage1.stage_tail, cuda_nms.nms_cellmax,
               attention.fused_attention, attention.bidirectional_attention)
    per_batch = (2, 1, N_LAYERS, N_LAYERS)
    for kfn in kernels:
        kfn.launches = 0
    results = [None] * N_REQUESTS
    errors = []

    def worker(t):
        for i in range(t, N_REQUESTS, N_THREADS):
            try:
                results[i] = tm.match(pairs[i][0], pairs[i][1])
            except Exception as e:  # reported below; the run then fails
                errors.append(repr(e))

    t0 = time.perf_counter()
    threads = [threading.Thread(target=worker, args=(t,))
               for t in range(N_THREADS)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=600)
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {k.__name__: k.launches for k in kernels}
    tm.close()
    if errors or any(th.is_alive() for th in threads) or None in results:
        fail(f"serving requests failed: {errors[:3]}")
    log(f"  {N_REQUESTS} requests from {N_THREADS} threads in {wall:.2f} s, "
        f"{batches[0]} batches; launches {launches}")
    for kfn, per in zip(kernels, per_batch):
        if kfn.launches == 0 or kfn.launches != per * batches[0]:
            fail(f"{kfn.__name__}: {kfn.launches} launches for "
                 f"{batches[0]} batches (expected {per} per batch)")
    for i, (res, (_, _, hm)) in enumerate(zip(results, pairs)):
        for key in ("mkeypoints0_orig", "mkeypoints1_orig", "mconf", "M"):
            if not np.isfinite(res[key]).all():
                fail(f"request {i}: non-finite {key}")
        err = transfer_errors(hm, res["mkeypoints0_orig"],
                              res["mkeypoints1_orig"])
        med = float(np.median(err)) if len(err) else float("inf")
        log(f"  request {i} {REQUEST_SIZES[i % len(REQUEST_SIZES)]}: "
            f"{res['num_inliers']} inliers, {len(res['keypoints0_orig'])}/"
            f"{len(res['keypoints1_orig'])} keypoints, median transfer "
            f"error {med:.3f} px")
        if len(err) < GATE_MIN_INLIERS or med > GATE_MEDIAN_PX:
            fail(f"request {i}: gate is >= {GATE_MIN_INLIERS} inliers with "
                 f"median error <= {GATE_MEDIAN_PX} px")
    return launches


def phase3(params):
    """match_step at bench.py's operating point: pairs/s and stage split."""
    import torch

    from imcui_tpu_torch.models.extractors import superpoint as sp
    from imcui_tpu_torch.models.matchers import lightglue as lg
    from imcui_tpu_torch.ops import ransac as ransac_ops
    from imcui_tpu_torch.pipeline import two_view

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    valid = torch.tensor([[CANVAS, CANVAS]] * BATCH, dtype=torch.int32,
                         device=dev)
    warmup, iters = 3, 20

    def images():
        return (torch.rand((BATCH, 1, CANVAS, CANVAS), generator=gen,
                           device=dev),
                torch.rand((BATCH, 1, CANVAS, CANVAS), generator=gen,
                           device=dev))

    def step():
        im0, im1 = images()
        return two_view.match_step(params, im0, im1, valid, valid, gen,
                                   max_keypoints=MAX_KPTS,
                                   num_hypotheses=HYPOTHESES,
                                   ransac="fundamental", device=dev)

    with torch.inference_mode():
        for _ in range(warmup):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = step()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        if not all(torch.isfinite(out[k].float()).all()
                   for k in ("matching_scores0", "M")):
            fail("match_step produced non-finite outputs")

        # per-stage split with CUDA events, the same calls match_step makes
        split = {"superpoint": [], "lightglue": [], "ransac": []}
        for it in range(warmup + iters):
            im0, im1 = images()
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
            ev[0].record()
            f = sp.apply(params["superpoint"], torch.cat([im0, im1]),
                         torch.cat([valid, valid]), max_keypoints=MAX_KPTS,
                         keypoint_threshold=0.0005, device=dev)
            ev[1].record()
            m = lg.forward_pair(
                params["lightglue"], f["keypoints"][:BATCH],
                f["keypoints"][BATCH:],
                f["descriptors"][:BATCH].transpose(1, 2),
                f["descriptors"][BATCH:].transpose(1, 2), f["mask"][:BATCH],
                f["mask"][BATCH:], valid.float(), valid.float(), device=dev)
            ev[2].record()
            m0 = m["matches0"].long()
            p1 = torch.gather(f["keypoints"][BATCH:], 1,
                              m0.clamp(0, MAX_KPTS - 1)[..., None]
                              .expand(-1, -1, 2))
            ransac_ops.ransac(f["keypoints"][:BATCH], p1, m0 > -1, gen,
                              threshold=4.0, num_hypotheses=HYPOTHESES,
                              device=dev)
            ev[3].record()
            ev[3].synchronize()
            if it >= warmup:
                for j, key in enumerate(split):
                    split[key].append(ev[j].elapsed_time(ev[j + 1]))
        # where the device time goes: a short profiler window
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t1 = time.perf_counter()
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            window_ms = (time.perf_counter() - t1) * 1e3
    # device-side events only (kernels, copies, memsets); the CPU-side ops
    # that launched them carry the same time again
    events = [e for e in prof.key_averages() if e.device_type.name == "CUDA"]
    device_ms = sum(e.self_device_time_total for e in events) / 3e3
    top = sorted(events, key=lambda e: e.self_device_time_total,
                 reverse=True)[:15]
    split = {k: float(np.median(v)) for k, v in split.items()}
    pairs_per_s = BATCH * iters / dt
    ms_step = dt / iters * 1e3
    log(f"  match_step: {pairs_per_s:.2f} pairs/s, {ms_step:.2f} ms/step "
        f"({BATCH} pairs, {CANVAS}^2, {MAX_KPTS} keypoints, {N_LAYERS} "
        f"layers, {HYPOTHESES} hypotheses)")
    log("  stage split (ms, CUDA events, median): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    idle = 1 - device_ms / ms_step
    log(f"  profiler (3 steps, {window_ms / 3:.2f} ms/step under the "
        f"profiler): device busy {device_ms:.2f} ms/step, idle share "
        f"{idle:.3f} of the unprofiled step; top device time per step:")
    for e in top:
        log(f"    {e.self_device_time_total / 3e3:9.3f} ms  "
            f"x{e.count / 3:g}  {e.key[:100]}")
    return {"pairs_per_s": pairs_per_s, "ms_per_step": ms_step,
            "split_ms": split, "device_busy_ms": device_ms,
            "device_idle_share": idle}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from imcui_tpu_torch.pipeline import two_view

    smi_line = phase0()
    name = torch.cuda.get_device_name(0)
    part, peaks = card_peaks(name)
    log(f"phase 1: kernels vs plain versions (peaks of an H100 {part})")
    params, _ = two_view.load_pretrained(n_layers=N_LAYERS, device="cuda")
    rows = phase1(params, peaks)
    log("phase 2: serving")
    launches = phase2()
    for r in rows:
        r["launches"] = launches[r["name"]]
    log("phase 3: timing at the bench operating point")
    timing = phase3(params)
    log(json.dumps({"timing": timing, "card": smi_line}))
    log(json.dumps({"kernels": rows}))
    log(smi_line)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
