"""Repeated launches of ``tap_matmul`` (``csrc/tap_matmul.cu``) on the card,
each into an output filled with NaN first and held against the plain
version, to catch a result that is wrong only now and then:

    python -m imcui_tpu_torch.tools.tap_repeat [--reps N]

The shapes are those of ``tests/test_torch_port_cuda.py`` where M mod 256
lies in 1-128 (the last row tile's second half of rows all past M), and
the probes' own. A launch is bad where an element is off the plain version
by more than 2^-7 * max(1, |plain|) (exact for int8). Prints one JSON
object: the card and its power limit, and per shape the launches, the bad
ones, and for the first few the count, rows, columns and a sample of the
bad elements.
"""

import argparse
import json
import subprocess

import torch

from ..ops import _build, tap_matmul

# (M, N, R, dtype, share of --reps)
CASES = ((132 * 256 * 3 + 77, 2048, 1, "bf16", 1.0),
         (257, 2048, 1, "bf16", 1.0),
         (132 * 256 * 3 + 77, 1152, 1, "bf16", 0.25),
         (132 * 256 * 3 + 77, 2048, 2, "bf16", 0.25),
         (132 * 256 * 3 + 77, 2048, 1, "int8", 0.25),
         (4097, 2048, 1, "bf16", 0.25),
         (4 * 1024 * 1024, 128, 9, "bf16", 0.02))


def inputs(m, n, r, dtype, seed=0):
    """The card tests' inputs: x (M, 128), w (R, 128, N)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    if dtype == "int8":
        x = torch.randint(-128, 128, (m, 128), generator=gen, device="cuda",
                          dtype=torch.int8)
        w = torch.randint(-128, 128, (r, 128, n), generator=gen,
                          device="cuda", dtype=torch.int8)
    else:
        x = torch.randn((m, 128), generator=gen, device="cuda"
                        ).to(torch.bfloat16)
        w = (torch.randn((r, 128, n), generator=gen, device="cuda") * 0.1
             ).to(torch.bfloat16)
    return x, w


def repeat(m, n, r, dtype, reps):
    x, w = inputs(m, n, r, dtype)
    want = tap_matmul.tap_matmul_plain(x, w).float()
    tol = 0.0 if dtype == "int8" else 2.0 ** -7 * want.abs().clamp_min(1.0)
    wt = tap_matmul._k_major(w, "taps")
    lib = _build.library()
    fn = lib.tap_matmul_bf16 if dtype == "bf16" else lib.tap_matmul_s8
    out = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
    rec = {"m": m, "n": n, "r": r, "dtype": dtype, "launches": reps,
           "bad_launches": 0, "first_bad": []}
    for i in range(reps):
        out.fill_(float("nan"))
        _build.check(fn(_build.ptr(x), _build.ptr(wt), _build.ptr(out), m, n,
                        r, _build.stream_of(x)), "tap_matmul")
        bad = ~((out.float() - want).abs() <= tol)
        if not bool(bad.any()):
            continue
        rec["bad_launches"] += 1
        if len(rec["first_bad"]) < 4:
            idx = bad.nonzero()
            rec["first_bad"].append({
                "launch": i, "elements": len(idx),
                "rows": [int(idx[:, 0].min()), int(idx[:, 0].max())],
                "cols": [int(idx[:, 1].min()), int(idx[:, 1].max())],
                "sample": [[a, b, float(out[a, b]), float(want[a, b])]
                           for a, b in idx[:4].tolist()]})
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=400)
    args = ap.parse_args(argv)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    cases = [repeat(m, n, r, dt, max(1, int(args.reps * share)))
             for m, n, r, dt, share in CASES]
    print(json.dumps({"card": card, "cases": cases}))


if __name__ == "__main__":
    main()
