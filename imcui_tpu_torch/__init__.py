"""PyTorch/CUDA port of the imcui_tpu turbo two-view serving path.

SuperPoint → LightGlue → RANSAC on an NVIDIA Hopper card, with the four
Pallas kernels of that path rewritten by hand in CUDA C++ (``csrc/``,
built on first use by ``ops/_build.py``). The JAX package ``imcui_tpu``
stays the reference; this package imports nothing of it.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Only a
caller that asks for ``"cpu"`` gets the CPU (the tests do); on a machine
without a card ``"cuda"`` raises instead of dropping to the CPU.
"""

import torch


def resolve_device(device="cuda"):
    """``device`` as a torch.device; raises when CUDA is asked for and
    absent (nothing falls back to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
