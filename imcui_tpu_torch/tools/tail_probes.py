"""The stage-tail probes K8–K13 on the card: the port's counterpart of the
JAX package's ``tools/try_nscaling.py``, ``try_tail_mini.py``,
``try_tail_mini2.py``, ``try_int8_tail.py``, ``try_tail_variants.py`` and
``try_widen.py``.

    python -m imcui_tpu_torch.tools.tail_probes

Each of those scripts times a Pallas kernel that computes
``bf16(Σ_r x @ w[r])`` at one shape in one TPU layout; ``PROBES`` has one
entry per kernel and variant that a script runs, with the script's shape,
types, value distributions and the layout of w. Every entry goes through
``ops.tap_matmul.tap_matmul`` (kernel ``csrc/tap_matmul.cu``). Entries of
the same function and shape (the same rows, N, taps, type and layout of
w) share one timed launch. The scripts' ``FL`` is flops (two per
multiply-add): ``try_tail_variants.py:13`` calls the 1237e9 of the tail
shape "618 GFLOP", its multiply-adds.
"""

import dataclasses
import math

import numpy as np
import torch

from ..ops.tap_matmul import K, tap_matmul

TAIL_X = (8, 1024, 512, 128)   # B, H, W2, 128 of the stage-tail scripts
NSCALING_X = (64, 8192, 128)   # GRID, M, K of try_nscaling.py


@dataclasses.dataclass(frozen=True)
class Probe:
    kernel: str        # row of the kernel table, "K8" … "K13"
    label: str         # what the script prints for it
    site: str          # the TPU kernel: function that reaches pallas_call
    body: str          # the kernel body of this variant
    x_shape: tuple     # the script's x, last axis K = 128
    w_shape: tuple     # the script's w: (R, 128, N) taps or (128, R·N) wide
    n: int             # output columns
    dtype: str = "bf16"            # "bf16" (f32 sums) or "int8" (int32)
    layout: str = "taps"
    x_scale: float = 1.0           # x = uniform[0, 1) · x_scale, cast
    w_scale: float = 1.0           # w = normal · w_scale, cast

    @property
    def rows(self):
        return math.prod(self.x_shape[:-1])

    @property
    def taps(self):
        return self.w_shape[0] if self.layout == "taps" else \
            self.w_shape[1] // self.n

    @property
    def torch_dtype(self):
        return torch.bfloat16 if self.dtype == "bf16" else torch.int8

    @property
    def group(self):
        """Entries with equal keys compute one function at one shape."""
        return (self.rows, self.n, self.taps, self.dtype, self.layout)

    def work(self, rows=None):
        """(flops, compulsory bytes) for ``rows`` rows (default the
        script's): two flops per multiply-add; x and w read once, the
        bf16 output written once."""
        m = self.rows if rows is None else rows
        size = 2 if self.dtype == "bf16" else 1
        flops = 2.0 * m * K * self.n * self.taps
        nbytes = (m * K + self.taps * K * self.n) * size + m * self.n * 2
        return flops, nbytes


def _tail(kernel, label, site, body, **kw):
    w_shape = kw.pop("w_shape", (9, K, 128))
    return Probe(kernel, label, site, body, TAIL_X, w_shape, 128, **kw)


PROBES = (
    *(Probe("K8", f"N={n:5d} reps={reps}", "tools/try_nscaling.py:11",
            "tools/try_nscaling.py:13", NSCALING_X, (reps, K, n), n)
      for n, reps in ((128, 9), (512, 2), (1152, 1), (2048, 1))),
    _tail("K9", "per-iter", "tools/try_tail_mini.py:10",
          "tools/try_tail_mini.py:10"),
    _tail("K10", "2d chain", "tools/try_tail_mini2.py:11",
          "tools/try_tail_mini2.py:23"),
    _tail("K10", "2d concatK", "tools/try_tail_mini2.py:11",
          "tools/try_tail_mini2.py:32"),
    _tail("K11", "bf16", "tools/try_int8_tail.py:12",
          "tools/try_int8_tail.py:13", x_scale=50.0, w_scale=20.0),
    _tail("K11", "int8", "tools/try_int8_tail.py:12",
          "tools/try_int8_tail.py:13", dtype="int8", x_scale=50.0,
          w_scale=20.0),
    *(_tail("K12", label, "tools/try_tail_variants.py:57",
            f"tools/try_tail_variants.py:{body}", w_scale=0.05)
      for label, body in (("9x K=128 chain wc512", 29),
                          ("9x K=128 chain wc128", 29),
                          ("3x K=384 concat wc256", 42),
                          ("1x K=1152 concat wc128", 42),
                          ("1x K=1152 concat wc64", 42))),
    _tail("K13", "chain 9xN128", "tools/try_widen.py:12",
          "tools/try_widen.py:24"),
    _tail("K13", "wide N1152", "tools/try_widen.py:12",
          "tools/try_widen.py:34", w_shape=(K, 9 * 128), layout="wide"),
)


def _require_device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("tail_probes: no CUDA device")
    return device


def make_inputs(probe, seed=0, device="cuda", scale=1.0):
    """(x, w) of ``probe`` from ``seed``: x (rows, 128) uniform[0, 1) ·
    x_scale, w normal · w_scale, both cast to the probe's type (an int8
    cast truncates toward zero, as the scripts' ``astype`` does; w is
    clamped to int8's range first). ``scale < 1`` cuts the rows, and only
    the rows (for tests)."""
    device = _require_device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    rows = probe.rows if scale == 1.0 else max(1, math.ceil(probe.rows *
                                                            scale))
    dt = probe.torch_dtype
    x = (torch.rand((rows, K), generator=gen, device=device)
         * probe.x_scale).to(dt)
    w = torch.randn(probe.w_shape, generator=gen, device=device) \
        * probe.w_scale
    if dt == torch.int8:
        w = w.clamp(-128, 127)
    return x, w.to(dt)


def event_ms(fn, iters=20, warmup=3):
    """Median of ``iters`` CUDA-event timings of ``fn`` after ``warmup``
    calls, in ms."""
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


def run(probe, device="cuda", seed=0, scale=1.0, iters=20):
    """One probe: its output (rows, N) bf16 from ``tap_matmul``, and on a
    card the median device time of ``iters`` launches after 3 warm-ups
    (``ms``) and the rate (``tflops``, 10¹² flops or int8 operations a
    second). On the CPU, and with ``iters=0``, no time is taken and both
    are None."""
    device = _require_device(device)
    x, w = make_inputs(probe, seed, device, scale)

    def call():
        return tap_matmul(x, w, layout=probe.layout)

    out = call()
    ms = tflops = None
    if device.type == "cuda" and iters:
        ms = event_ms(call, iters)
        tflops = probe.work(x.shape[0])[0] / ms / 1e9
    return {"out": out, "ms": ms, "tflops": tflops}


def run_all(device="cuda", seed=0, scale=1.0, iters=20, keep=True):
    """Every probe in order. The first entry of each group is timed and
    the others reuse its time (``timed_with`` names it); each result also
    holds the launches it made (``launches``) and, where ``keep``, its
    output."""
    results, timed = [], {}
    for p in PROBES:
        first = timed.get(p.group)
        before = tap_matmul.launches
        res = run(p, device, seed, scale, iters if first is None else 0)
        res["launches"] = tap_matmul.launches - before
        if first is None:
            timed[p.group] = (p, res)
        else:
            res["ms"], res["tflops"] = first[1]["ms"], first[1]["tflops"]
            res["timed_with"] = f"{first[0].kernel} {first[0].label}"
        if not keep:
            del res["out"]
        results.append(res)
    return results


def main():
    _require_device("cuda")
    print(torch.cuda.get_device_name(0), flush=True)
    for p, res in zip(PROBES, run_all("cuda", keep=False)):
        unit = "TF/s" if p.dtype == "bf16" else "T/s"
        shared = f" (timed with {res['timed_with']})" \
            if "timed_with" in res else ""
        print(f"{p.kernel:3s} {p.site:30s} {p.label:24s}: {res['ms']:7.3f} "
              f"ms -> {res['tflops']:6.1f} {unit}{shared}", flush=True)


if __name__ == "__main__":
    main()
