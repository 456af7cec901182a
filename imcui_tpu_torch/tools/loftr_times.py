"""Times of LoFTR's dense request on the card, part by part, at the
registry's width (640 x 480):

    python -m imcui_tpu_torch.tools.loftr_times

- every convolution of the ResNet-FPN backbone, in float32 (TF32 off, as
  the f32 path runs) and bf16: cuDNN with the two views in one batch and
  one view at a time, and PyTorch's own convolution without cuDNN (for
  float32 convs to 196 channels cuDNN may pick an FFT algorithm that is
  hundreds of times slower);
- the whole backbone those three ways and through ``backbone_apply``
  (which runs a float32 batch without cuDNN), at 640 x 480 and at
  RoMaV2's 640 x 640, and in float32 each way's largest coarse-feature
  difference from the CPU on the seed-0 tree, over the largest feature;
- the coarse transformer (four layers, two views, 4800 tokens) and the
  fine stage (2000 windows), bf16: the host time to issue each and its
  device time queued (median of 5 runs between two events), which tell a
  host-bound stage from a device-bound one;
- the host preprocessing of one 1600 x 1200 image to 640 x 480
  (``utils/image.py::preprocess``, the registry's conf), host clock.

Times are medians of 5 runs (the backbones' one view at a time: 20), each
between its own pair of CUDA events (``tail_probes.event_ms``). Prints a
line a convolution and one JSON object with the card, its power limit and
cuDNN's version.
"""

import json
import subprocess
import time

import numpy as np
import torch

from ..models import layers
from ..models.matchers import loftr
from ..utils import image as image_utils
from ..utils.weights import to_device
from .tail_probes import event_ms

H, W = 480, 640
CANVASES = ((480, 640), (640, 640))


def without_cudnn(fn):
    """``fn`` run with cuDNN off (the other cuDNN flags kept)."""
    cudnn = torch.backends.cudnn

    def run():
        with cudnn.flags(enabled=False, benchmark=cudnn.benchmark,
                         deterministic=cudnn.deterministic,
                         allow_tf32=cudnn.allow_tf32):
            return fn()
    return run


def backbone_convs(params, x):
    """(input shape, weight shape, stride) of each convolution the
    backbone runs on ``x``, in order."""
    seen = []
    conv = loftr.conv2d

    def record(p, t, stride=1, **kw):
        seen.append((tuple(t.shape), tuple(p["w"].shape), stride))
        return conv(p, t, stride=stride, **kw)

    loftr.conv2d = record
    try:
        with torch.inference_mode():
            loftr._backbone(params, x)
    finally:
        loftr.conv2d = conv
    return seen


def queued(fn, n=5):
    """Host ms to issue one call of ``fn``, and its device ms from ``n``
    calls queued between two events."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    host = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(n):
        fn()
    end.record()
    end.synchronize()
    return host, start.elapsed_time(end) / n


def main():
    if not torch.cuda.is_available():
        raise SystemExit("loftr_times: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device="cuda").manual_seed(0)
    tree = loftr.load_params({}, "cuda")[0]
    out = {"card": card, "cudnn": torch.backends.cudnn.version(),
           "convs": [], "backbone": {}}
    views = torch.rand((2, 1, H, W), generator=gen, device="cuda")
    for name, precision in (("f32", None), ("bf16", "bf16")):
        p = layers.apply_precision(tree, precision)["backbone"]
        x = views.to(p["conv1"]["w"].dtype)
        with torch.inference_mode(), layers.full_fp32():
            for xs, ws, stride in backbone_convs(p, x[:1]):
                t = torch.randn((2,) + xs[1:], generator=gen,
                                device="cuda").to(x.dtype)
                cp = {"w": torch.randn(ws, generator=gen, device="cuda").to(
                    x.dtype) * 0.05}

                def pair(cp=cp, t=t, stride=stride):
                    return layers.conv2d(cp, t, stride=stride)
                out["convs"].append({
                    "type": name, "input": [2, *xs[1:]], "weight": list(ws),
                    "stride": stride,
                    "pair_ms": event_ms(pair, iters=5, warmup=1),
                    "one_view_at_a_time_ms": event_ms(lambda: [
                        layers.conv2d(cp, t[i:i + 1], stride=stride)
                        for i in range(2)], iters=5, warmup=1),
                    "pair_no_cudnn_ms": event_ms(without_cudnn(pair),
                                                 iters=5, warmup=1)})
            for h, w in CANVASES:
                x = torch.rand((2, 1, h, w), generator=gen,
                               device="cuda").to(p["conv1"]["w"].dtype)
                ways = {
                    "pair": lambda: loftr._backbone(p, x),
                    "one_view_at_a_time": lambda: [
                        loftr._backbone(p, x[i:i + 1]) for i in range(2)],
                    "pair_no_cudnn": without_cudnn(
                        lambda: loftr._backbone(p, x)),
                    "backbone_apply": lambda: loftr.backbone_apply(p, x)}
                row = {f"{k}_ms": event_ms(fn, iters=5, warmup=1)
                       for k, fn in ways.items()}
                if name == "f32":
                    host = loftr._backbone(to_device(p, "cpu"), x.cpu())[0]
                    top = float(host.abs().max())
                    for k, fn in ways.items():
                        got = fn()
                        got = torch.cat([v[0] for v in got]) \
                            if k == "one_view_at_a_time" else got[0]
                        row[f"{k}_err_vs_cpu"] = float(
                            (got.cpu() - host).abs().max()) / top
                out["backbone"][f"{name} {h}x{w}"] = row
    pb = layers.apply_precision(tree, "bf16")
    tokens = torch.randn((4800, 256), generator=gen, device="cuda").to(
        torch.bfloat16)
    windows = torch.randn((2000, 25, 128), generator=gen, device="cuda").to(
        torch.bfloat16)
    mask = torch.ones(4800, dtype=torch.bool, device="cuda")
    valid = torch.ones(2000, dtype=torch.bool, device="cuda")
    with torch.inference_mode(), layers.full_fp32():
        for name, fn in (
                ("coarse transformer", lambda: loftr.coarse_transform(
                    pb["loftr_coarse"]["layers"], tokens, tokens, mask,
                    mask)),
                ("fine_match", lambda: loftr.fine_match(pb, windows, windows,
                                                        valid))):
            host, device = queued(fn)
            out[name] = {"host_issue_ms": host, "device_queued_ms": device}
    img = (np.random.default_rng(0).random((1200, 1600, 3)) * 255).astype(
        np.uint8)
    times = []
    for _ in range(5):
        t0 = time.perf_counter()
        image_utils.preprocess(img, grayscale=True, resize_max=1024,
                               force_resize=True, width=W, height=H,
                               dfactor=8)
        times.append((time.perf_counter() - t0) * 1e3)
    out["preprocess_one_image_host_ms"] = float(np.median(times))
    for c in out["convs"]:
        print(f"{c['type']:4s} {str(c['input']):22s} -> "
              f"{str(c['weight']):20s} s{c['stride']}: pair "
              f"{c['pair_ms']:9.3f} ms, one view at a time "
              f"{c['one_view_at_a_time_ms']:7.3f} ms, no cuDNN "
              f"{c['pair_no_cudnn_ms']:7.3f} ms")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
