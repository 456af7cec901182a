"""Build and bind the hand-written CUDA kernels and the host library.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain
C interface, loaded with ``ctypes``. Nothing includes PyTorch's headers,
so a cold build takes seconds. The build runs on first use, never at
import, into ``_build/`` beside the package (git-ignored), under a name
that hashes the sources and flags, so an edit rebuilds and concurrent
processes never load a half-written file.

Each C entry point takes device pointers and the CUDA stream as
``void*``, sizes as ``int``, launches on that stream without
synchronising, and returns ``cudaGetLastError()``; ``check`` turns a
non-zero code into an exception.

The host library (``host_library``) is every ``csrc/host/*.cpp``,
compiled by the host C++ compiler (``c++``, or ``$CXX``) into
``_build/libimcui_host_<hash>.so`` the same way: on first use, under a
hash of its sources and flags, moved into place atomically. It needs no
CUDA toolkit, so it builds on a machine without a card too.
``-fwrapv`` gives the IDCT's 32-bit arithmetic the wrap-around the SIMD
kernels it restates have, and no ``-march`` flag ties the library to
one CPU.
"""

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC"]

P = ctypes.c_void_p
I = ctypes.c_int
# C signature of every entry point: argument types in order.
SIGNATURES = {
    "stage_tail_bf16": [P, P, P, P, P, I, I, I, P],
    "nms_cellmax_f32": [P, P, P, P, I, I, I, I, I, P],
    "nms_cellmax_plan": [I, I, I, I, P],
    "fused_attention_f32": [P, P, P, P, P, I, I, I, P],
    "bidir_attention_f32": [P, P, P, P, P, P, P, P, I, I, I, I, P],
    "attention_f32_plan": [I, I, I, I, P],
    "flash_attention_fwd": [P, P, P, P, P, I, I, I, I, I, I, P],
    "flash_attention_plan": [I, I, I, I, P],
    "stem_tail_fwd": [P, P, P, P, P, P, I, I, I, I, P],
    "stage_conv_plan": [I, I, I, P],
    "qtiled_attention_bf16": [P, P, P, P, I, I, I, P],
    "qtiled_attention_plan": [I, I, I, P],
    "tap_matmul_bf16": [P, P, P, I, I, I, P],
    "tap_matmul_s8": [P, P, P, I, I, I, P],
    "fused_attention_bf16": [P, P, P, P, P, I, I, I, P],
    "bidir_attention_bf16": [P, P, P, P, P, P, P, P, I, I, I, I, P],
    "w8a8_gemm": [P, P, P, P, P, P, I, I, I, I, P],
    "w8a8_conv": [P, P, P, P, P, P, P],
}

HOST_CSRC = CSRC / "host"
HOST_FLAGS = ["-std=c++17", "-O2", "-fwrapv", "-shared", "-fPIC"]
L = ctypes.c_int64
HOST_SIGNATURES = {
    "jpeg_decode_scan": [P, L, L, P, P, P, P],
    "jpeg_output": [P, P, P, P],
}

_lock = threading.Lock()
_lib = None
_host_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def _sources():
    srcs = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for f in srcs + sorted(CSRC.glob("*.cuh")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return srcs, h.hexdigest()[:16]


def _compile(out):
    """One nvcc per source, all at once, then one link into ``out``."""
    global build_seconds
    nvcc = _nvcc()
    srcs, _ = _sources()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in srcs:
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, "-Xptxas", "-v", "-c", str(src),
                   "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        logs = []
        for src, obj, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {src.name}\n{text}")
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{text}")
        tmp_so = Path(tmp) / out.name
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp_so)]
            + [str(o) for _, o, _ in procs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        (BUILD_DIR / (out.stem + ".log")).write_text("\n".join(logs))
        os.replace(tmp_so, out)
    build_seconds = time.perf_counter() - t0


def library_path():
    """Where the shared library of the present sources is (or will be)."""
    return BUILD_DIR / f"libimcui_kernels_{_sources()[1]}.so"


def library():
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            BUILD_DIR.mkdir(exist_ok=True)
            so = library_path()
            if not so.exists():
                _compile(so)
            lib = ctypes.CDLL(str(so))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.imcui_error_string.argtypes = [ctypes.c_int]
            lib.imcui_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def _cxx():
    cxx = os.environ.get("CXX") or shutil.which("c++")
    if not cxx:
        raise RuntimeError("no C++ compiler: the host library needs c++ "
                           "on PATH (or CXX set)")
    return cxx


def _host_sources():
    """The host sources and a hash of them, the flags, the compiler and
    the machine type: a library built elsewhere (a copied tree) is never
    loaded."""
    srcs = sorted(HOST_CSRC.glob("*.cpp"))
    h = hashlib.sha256(" ".join(HOST_FLAGS + [_cxx(), platform.machine()])
                       .encode())
    for f in srcs:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return srcs, h.hexdigest()[:16]


def host_library_path():
    return BUILD_DIR / f"libimcui_host_{_host_sources()[1]}.so"


def compile_host(out, srcs):
    """Compile ``srcs`` with the host C++ compiler into the shared library
    ``out``, written under a temporary name and moved into place. A
    missing compiler or a failed build raises ``RuntimeError`` with what
    the compiler said."""
    out.parent.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=out.parent) as tmp:
        tmp_so = Path(tmp) / out.name
        try:
            proc = subprocess.run(
                [_cxx(), *HOST_FLAGS, *map(str, srcs), "-o", str(tmp_so)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        except OSError as e:
            raise RuntimeError(f"cannot run the C++ compiler: {e}") from None
        if proc.returncode != 0:
            raise RuntimeError(f"the host library failed to build:\n"
                               f"{proc.stdout}")
        os.replace(tmp_so, out)


def host_library():
    """The host library (``csrc/host/*.cpp``), built on first use."""
    global _host_lib
    with _lock:
        if _host_lib is None:
            so = host_library_path()
            if not so.exists():
                compile_host(so, _host_sources()[0])
            lib = ctypes.CDLL(str(so))
            for name, argtypes in HOST_SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _host_lib = lib
        return _host_lib


def stream_of(t):
    """Current CUDA stream of ``t``'s device, as a ctypes pointer."""
    return P(torch.cuda.current_stream(t.device).cuda_stream)


def ptr(t):
    return P(t.data_ptr())


def check(code, name):
    if code != 0:
        msg = library().imcui_error_string(code).decode()
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} "
                           f"(cudaError {code})")


def require(t, name, dtype, shape=None):
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and
    ``shape`` where given, ``None`` entries matching any size)."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and (len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape))):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
