"""The stage-tail probes K8–K13 on the CPU: ``tap_matmul_plain`` against
each of the six Pallas kernels of the JAX package's ``tools/`` scripts,
run in interpret mode at small sizes, and the port's probe module
(``imcui_tpu_torch.tools.tail_probes``) at a cut row count.

The scripts run a full-size benchmark when imported, so each kernel body
is copied here as its script builds it (the line is cited at each copy)
and only the sizes are cut: B = 2, H = 32, T = 16 and W2 = 16 to 64 for
the stage-tail shape, GRID = 2 and M = 256 for ``try_nscaling.py``.
Inputs come from numpy seeds. Tolerances: bf16 outputs within
2⁻⁷·max(1, |ref|), one bf16 step (the f32 sums are taken in another
order); int8 exact (integer sums below 2²⁴ round to bf16 once, alike).
"""

import functools
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from imcui_tpu_torch.ops import tap_matmul as tm
from imcui_tpu_torch.tools import tail_probes as tp

ROOT = Path(__file__).resolve().parents[1]
B, H, T = 2, 32, 16


def _close_bf16(got, want):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else \
        np.asarray(got.astype(jnp.float32))
    want = want.float().numpy() if isinstance(want, torch.Tensor) else \
        np.asarray(want.astype(jnp.float32))
    assert got.shape == want.shape
    tol = 2.0 ** -7 * np.maximum(1.0, np.abs(want))
    assert (np.abs(got - want) <= tol).all(), np.abs(got - want).max()


def _inputs(seed, x_shape, w_shape, dtype="bf16", x_scale=1.0, w_scale=1.0):
    """(jax x, jax w, torch x, torch w) of the same values: x uniform ·
    x_scale, w normal · w_scale, cast to bf16 or (truncating) to int8."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(size=x_shape).astype(np.float32) * x_scale
    w = rng.normal(size=w_shape).astype(np.float32) * w_scale
    if dtype == "int8":
        x, w = x.astype(np.int8), np.clip(w, -128, 127).astype(np.int8)
        return jnp.asarray(x), jnp.asarray(w), torch.from_numpy(x), \
            torch.from_numpy(w)
    jx, jw = jnp.asarray(x).astype(jnp.bfloat16), \
        jnp.asarray(w).astype(jnp.bfloat16)
    return jx, jw, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16), torch.from_numpy(np.array(
            jw.astype(jnp.float32))).to(torch.bfloat16)


def _dot(a, b, axis, acc=jnp.float32):
    return jax.lax.dot_general(a, b, (((axis,), (0,)), ((), ())),
                               preferred_element_type=acc)


# --------------------------------------------------------------------------
# K8: tools/try_nscaling.py:11 bench, body k :13, pallas_call :21
# --------------------------------------------------------------------------

@pytest.mark.parametrize("n,reps", [(128, 9), (512, 2), (1152, 1),
                                    (2048, 1)])
def test_k8_nscaling_pallas_matches_plain(n, reps):
    grid, m, k_ = 2, 256, 128

    def k(x_ref, w_ref, o_ref):                 # try_nscaling.py:13-20
        x = x_ref[0]
        s = None
        for r in range(reps):
            p = jax.lax.dot_general(x, w_ref[r], (((1,), (0,)), ((), ())),
                                    preferred_element_type=jnp.float32)
            s = p if s is None else s + p
        o_ref[0] = s.astype(jnp.bfloat16)

    pc = pl.pallas_call(                        # try_nscaling.py:21-30
        k,
        out_shape=jax.ShapeDtypeStruct((grid, m, n), jnp.bfloat16),
        grid=(grid,),
        in_specs=[pl.BlockSpec((1, m, k_), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, m, n), lambda i: (i, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True)
    jx, jw, x, w = _inputs(n + reps, (grid, m, k_), (reps, k_, n))
    got = tm.tap_matmul(x, w)
    assert got.shape == (grid, m, n) and got.dtype == torch.bfloat16
    _close_bf16(got, pc(jx, jw))


# --------------------------------------------------------------------------
# K9–K13: the stage-tail scripts, grid (B, H // T) over (B, H, W2, 128)
# --------------------------------------------------------------------------

def _mk(kernel, w2):
    """The pallas_call of try_tail_mini.py:22, try_tail_mini2.py:11,
    try_int8_tail.py:21, try_tail_variants.py:59 and try_widen.py:12
    (one form in all five), at (B, H, w2, 128)."""
    return pl.pallas_call(
        kernel,
        out_shape=jax.ShapeDtypeStruct((B, H, w2, 128), jnp.bfloat16),
        grid=(B, H // T),
        in_specs=[pl.BlockSpec((1, T, w2, 128), lambda i, j: (i, j, 0, 0),
                               memory_space=pltpu.VMEM),
                  pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec((1, T, w2, 128), lambda i, j: (i, j, 0, 0),
                               memory_space=pltpu.VMEM),
        interpret=True)


def k9_mini(x_ref, w_ref, o_ref):               # try_tail_mini.py:10-17
    x = x_ref[0]
    s = None
    for t in range(9):
        p = jax.lax.dot_general(x, w_ref[t], (((2,), (0,)), ((), ())),
                                preferred_element_type=jnp.float32)
        s = p if s is None else s + p
    o_ref[0] = s.astype(jnp.bfloat16)


def k10_2d(x_ref, w_ref, o_ref, *, w2):         # try_tail_mini2.py:23-30
    x = x_ref[0].reshape(T * w2, 128)
    s = None
    for t in range(9):
        p = _dot(x, w_ref[t], 1)
        s = p if s is None else s + p
    o_ref[0] = s.reshape(T, w2, 128).astype(jnp.bfloat16)


def k10_2d_concat(x_ref, w_ref, o_ref, *, w2):  # try_tail_mini2.py:32-38
    x = x_ref[0].reshape(T * w2, 128)
    patch = jnp.concatenate([x] * 9, -1)
    wmat = w_ref[:].reshape(9 * 128, 128)
    p = _dot(patch, wmat, 1)
    o_ref[0] = p.reshape(T, w2, 128).astype(jnp.bfloat16)


def k11_int8_tail(x_ref, w_ref, o_ref, *, w2, acc):  # try_int8_tail.py:13-20
    x = x_ref[0].reshape(T * w2, 128)
    s = None
    for t in range(9):
        p = _dot(x, w_ref[t], 1, acc)
        s = p if s is None else s + p
    o_ref[0] = s.reshape(T, w2, 128).astype(jnp.bfloat16)


def k12_chain(x_ref, w_ref, o_ref, *, w2, wc):  # try_tail_variants.py:29-40
    x = x_ref[0]
    for c0 in range(0, w2, wc):
        s = None
        for t in range(9):
            rows = x[:T, c0:c0 + wc]  # ignore true shift
            p = _dot(rows, w_ref[t], 2)
            s = p if s is None else s + p
        o_ref[0, :, c0:c0 + wc] = s.astype(jnp.bfloat16)


def k12_concat(x_ref, w_ref, o_ref, *, w2, ntap, wc):  # :42-55
    x = x_ref[0]
    wmat = w_ref[:].reshape(9 * 128, 128)
    for c0 in range(0, w2, wc):
        s = None
        for g in range(0, 9, ntap):
            tiles = [x[:T, c0:c0 + wc] for _ in range(ntap)]
            patch = jnp.concatenate(tiles, -1)  # (T, wc, 128*ntap)
            wg = wmat[g * 128:(g + ntap) * 128]
            p = _dot(patch, wg, 2)
            s = p if s is None else s + p
        o_ref[0, :, c0:c0 + wc] = s.astype(jnp.bfloat16)


def k13_chain(x_ref, w_ref, o_ref, *, w2):      # try_widen.py:24-32
    x = x_ref[0].reshape(T * w2, 128)
    w = w_ref[:].reshape(9, 128, 128)
    s = None
    for t in range(9):
        p = _dot(x, w[t], 1)
        s = p if s is None else s + p
    o_ref[0] = s.reshape(T, w2, 128).astype(jnp.bfloat16)


def k13_wide(x_ref, w_ref, o_ref, *, w2, mc, as_written=False):
    """try_widen.py:34-45 with MC = ``mc``. Its store at :45 assigns into a
    loaded array (``o_ref[0].reshape(...)[c0:c0 + MC] = ...``), which JAX
    refuses; unless ``as_written``, that one store is restated as a store
    to the ref of the same rows."""
    w = w_ref[:].reshape(128, 1152)
    for c0 in range(0, T * w2, mc):
        x = x_ref[0].reshape(T * w2, 128)[c0:c0 + mc]
        p = _dot(x, w, 1)
        s = None
        for t in range(9):
            q = p[:, t * 128:(t + 1) * 128]
            s = q if s is None else s + q
        if as_written:
            o_ref[0].reshape(T * w2, 128)[c0:c0 + mc] = s.astype(jnp.bfloat16)
        else:
            o_ref[0, c0 // w2:(c0 + mc) // w2] = s.reshape(
                mc // w2, w2, 128).astype(jnp.bfloat16)


TAIL_CASES = [  # id, body, W2, keyword arguments, dtype, scales of x and w
    ("K9 mini", k9_mini, 16, {}, "bf16", 1.0, 1.0),
    ("K10 2d chain", k10_2d, 32, {}, "bf16", 1.0, 1.0),
    ("K10 2d concatK", k10_2d_concat, 16, {}, "bf16", 1.0, 1.0),
    ("K11 bf16", k11_int8_tail, 32, {"acc": jnp.float32}, "bf16", 50.0, 20.0),
    ("K11 int8", k11_int8_tail, 32, {"acc": jnp.int32}, "int8", 50.0, 20.0),
    ("K12 chain", k12_chain, 64, {"wc": 32}, "bf16", 1.0, 0.05),
    ("K12 c3", k12_concat, 64, {"ntap": 3, "wc": 32}, "bf16", 1.0, 0.05),
    ("K12 c9", k12_concat, 32, {"ntap": 9, "wc": 16}, "bf16", 1.0, 0.05),
    ("K13 chain", k13_chain, 16, {}, "bf16", 1.0, 1.0),
]


@pytest.mark.parametrize("case", TAIL_CASES, ids=[c[0] for c in TAIL_CASES])
def test_stage_tail_pallas_matches_plain(case):
    _, body, w2, kw, dtype, xs, ws = case
    kernel = body if body is k9_mini else functools.partial(body, w2=w2,
                                                            **kw)
    jx, jw, x, w = _inputs(w2, (B, H, w2, 128), (9, 128, 128), dtype, xs, ws)
    want = _mk(kernel, w2)(jx, jw)
    got = tm.tap_matmul(x, w)
    assert got.shape == (B, H, w2, 128) and got.dtype == torch.bfloat16
    if dtype == "int8":
        sums = np.einsum("bhwk,tkn->bhwn", np.asarray(jx, np.int64),
                         np.asarray(jw, np.int64))
        assert np.abs(sums).max() < 2 ** 24
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    else:
        _close_bf16(got, want)


@pytest.mark.parametrize("w2", [16, 32])
def test_k13_wide_pallas_matches_plain_on_the_wide_layout(w2):
    """k_wide reads w as (128, 1152) with w_wide[k, t·128 + n] = w[t, k, n];
    the port reads the same array in place (``layout="wide"``)."""
    jx, jw, x, w = _inputs(7 + w2, (B, H, w2, 128), (128, 9 * 128))
    want = _mk(functools.partial(k13_wide, w2=w2, mc=T * w2 // 2), w2)(jx, jw)
    got = tm.tap_matmul(x, w, layout="wide")
    _close_bf16(got, want)
    taps = w.reshape(128, 9, 128).permute(1, 0, 2).contiguous()
    assert torch.equal(tm.tap_matmul(x, taps), got)


def test_k13_wide_store_as_written_does_not_trace():
    """try_widen.py:45 stores into a loaded array; JAX refuses it."""
    jx, jw, _, _ = _inputs(3, (B, H, 16, 128), (128, 9 * 128))
    kernel = functools.partial(k13_wide, w2=16, mc=128, as_written=True)
    with pytest.raises(TypeError, match="immutable"):
        _mk(kernel, 16)(jx, jw)


# --------------------------------------------------------------------------
# the port's probe module
# --------------------------------------------------------------------------

@pytest.mark.parametrize("probe", tp.PROBES,
                         ids=[f"{p.kernel} {p.label.strip()}"
                              for p in tp.PROBES])
def test_tail_probe_runs_on_cpu_at_cut_rows(probe):
    """Every probe at about 400 rows on the CPU against a float64 numpy
    sum; no time is taken off the card."""
    scale = 5e-4 if probe.kernel == "K8" else 1e-4
    res = tp.run(probe, device="cpu", scale=scale)
    out = res["out"]
    assert res["ms"] is None and res["tflops"] is None
    x, w = tp.make_inputs(probe, 0, "cpu", scale)
    assert x.shape == (out.shape[0], 128) and w.shape == probe.w_shape
    assert x.dtype == w.dtype == probe.torch_dtype
    taps = w.double().numpy()
    if probe.layout == "wide":
        taps = taps.reshape(128, probe.taps, probe.n).transpose(1, 0, 2)
    ref = np.einsum("mk,tkn->mn", x.double().numpy(), taps)
    assert out.shape == (x.shape[0], probe.n) and out.dtype == torch.bfloat16
    if probe.dtype == "int8":
        assert np.abs(ref).max() < 2 ** 24
        want = torch.from_numpy(ref).to(torch.bfloat16)
        assert torch.equal(out, want)
        assert 0 <= int(x.min()) and int(x.max()) <= 49
    else:
        _close_bf16(out, torch.from_numpy(ref))


def test_tail_probes_table():
    """Sites, shapes and the work the bounds rest on."""
    assert [p.kernel for p in tp.PROBES] == (
        ["K8"] * 4 + ["K9"] + ["K10"] * 2 + ["K11"] * 2 + ["K12"] * 5
        + ["K13"] * 2)
    for p in tp.PROBES:
        for ref in (p.site, p.body):
            path, line = ref.split(":")
            text = (ROOT / path).read_text().splitlines()[int(line) - 1]
            assert text.lstrip().startswith("def "), (ref, text)
    tail = tp.PROBES[4]
    assert tail.rows == 8 * 1024 * 512 and tail.taps == 9
    assert tail.work() == (1236950581248.0, 2147778560)
    int8 = tp.PROBES[8]
    assert int8.dtype == "int8" and int8.work()[1] == 1610760192
    assert [p.work()[0] for p in tp.PROBES[:4]] == [
        2 * 8192 * 128 * n * 64 * r for n, r in
        ((128, 9), (512, 2), (1152, 1), (2048, 1))]
    wide = tp.PROBES[-1]
    assert wide.layout == "wide" and wide.w_shape == (128, 1152)
    assert wide.group != tail.group
    assert len({p.group for p in tp.PROBES}) == 7


def test_tail_probes_share_timed_launches_by_group():
    res = tp.run_all("cpu", scale=2e-5, keep=False)
    assert len(res) == len(tp.PROBES)
    shared = [r.get("timed_with") for r in res]
    assert shared[5:8] == ["K9 per-iter"] * 3 and shared[8] is None
    assert shared[-1] is None and all("out" not in r for r in res)


# --------------------------------------------------------------------------
# what the wrapper refuses
# --------------------------------------------------------------------------

def test_tap_matmul_refusals(monkeypatch):
    x = torch.zeros((4, 128), dtype=torch.bfloat16)
    w = torch.zeros((9, 128, 128), dtype=torch.bfloat16)
    before = tm.tap_matmul.launches
    for bad in (lambda: tm.tap_matmul(x.float(), w.float()),       # f32
                lambda: tm.tap_matmul(x, w.to(torch.int8)),        # mixed
                lambda: tm.tap_matmul(x, w[..., :96]),             # N = 96
                lambda: tm.tap_matmul(x, torch.zeros(
                    (2, 128, 192), dtype=torch.bfloat16)),         # N = 192
                lambda: tm.tap_matmul(x[:, :64], w),               # K = 64
                lambda: tm.tap_matmul(x[:0], w),                   # no rows
                lambda: tm.tap_matmul(x, w, layout="concat"),
                lambda: tm.tap_matmul(x, w.reshape(128, -1)[:, :1000],
                                      layout="wide")):
        with pytest.raises(ValueError):
            bad()
    assert tm.tap_matmul.launches == before
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.run(tp.PROBES[4], device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.main()


def test_tap_matmul_plain_wide_equals_taps_and_keeps_leading_axes():
    g = torch.Generator().manual_seed(0)
    x = torch.randn((2, 3, 5, 128), generator=g).to(torch.bfloat16)
    w = (torch.randn((2, 128, 128), generator=g) * 0.1).to(torch.bfloat16)
    wide = w.permute(1, 0, 2).reshape(128, 256)
    got = tm.tap_matmul(x, wide, layout="wide")
    assert got.shape == (2, 3, 5, 128)
    assert torch.equal(got, tm.tap_matmul(x, w))
    ref = sum(x.double() @ w[i].double() for i in range(2))
    _close_bf16(got, ref)


@pytest.mark.parametrize("layout", tm.LAYOUTS)
@pytest.mark.parametrize("r", [1, 9])
def test_k_major_taps_of_both_layouts(layout, r):
    """The kernel's one layout of w: (R, N, 128) with [t, n, k] =
    w_t[k, n], contiguous, a copy that leaves w as it was."""
    g = torch.Generator().manual_seed(r)
    n = 256 if layout == "taps" else 128
    taps = torch.randn((r, 128, n), generator=g).to(torch.bfloat16)
    w = taps if layout == "taps" else \
        taps.permute(1, 0, 2).reshape(128, r * n).contiguous()
    keep = w.clone()
    got = tm._k_major(w, layout)
    assert got.shape == (r, n, 128) and got.is_contiguous()
    assert torch.equal(got, tm._taps(w, layout).transpose(1, 2))
    assert torch.equal(got, taps.transpose(1, 2))
    assert got.data_ptr() != w.data_ptr() and torch.equal(w, keep)
