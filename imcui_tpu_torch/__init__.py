"""PyTorch/CUDA port of imcui_tpu for an NVIDIA Hopper card.

Three paths are ported so far:

- the turbo two-view serving path (``api/turbo.py::TurboMatcher`` →
  ``pipeline/two_view.py::match_step``: SuperPoint → static-depth
  LightGlue → RANSAC on a batch of pairs);
- the general matching path every other user surface sits on
  (``api/core.py::ImageMatchingAPI`` → ``pipeline/extract_features.py`` →
  the ``SuperPoint`` ``BaseModel`` → ``pipeline/match_features.py`` → the
  ``LightGlue`` ``BaseModel`` with adaptive depth → ``ui/utils.py``'s
  RANSAC filter), configured from the registry in ``configs/``;
- the dense (standalone) branch of that API
  (``pipeline/match_dense.py::match_images`` → the ``Roma`` ``BaseModel``:
  DINOv2 ViT-L/14 and a VGG19 pyramid, a Gaussian-process coarse matcher,
  an anchor-classification decoder and five convolutional refiners, in
  float32 or bfloat16, or its lightweight ``fpn-corr`` backbone →
  ``sample`` → the same RANSAC filter); on the same branch the ``LoFTR``
  ``BaseModel`` (ResNet-FPN, linear-attention transformer, dual-softmax
  coarse matches, fine windows) on the tree trained in the repository,
  and the LoFTR family built on its parts (``eloftr``, ``se2loftr``,
  ``xoftr``, ``aspanformer``, ``topicfm``, ``matchformer``).

The user surfaces sit on the general path: the HTTP server
(``api/server.py``, standard library transport), its client
(``api/client.py``), the command line (``cli/main.py``) and
``ui/utils.py::run_matching`` over the matcher zoo, with this package's
own PNG codec (``utils/png.py``). The batch pipelines
(``pipeline/{extract_features,match_features,match_dense}.py``'s
``main()``, ``pipeline/pairs_from_{exhaustive,retrieval}.py``) write and
read hloc's HDF5 files through this package's own ``utils/h5lite.py``.

The seven Pallas kernels on those paths are rewritten by hand in CUDA C++
(``csrc/``, built on first use by ``ops/_build.py``): ``stage_tail``,
``stem_tail`` (one kernel for both TPU stem kernels), ``nms_cellmax``,
``fused_attention``, ``bidirectional_attention``, ``flash_attention`` and
``qtiled_attention`` (the ViT blocks' bf16 attention).
The JAX package ``imcui_tpu`` stays the reference; this package imports
nothing of it.

Every entry point takes ``device=`` and defaults to ``"cuda"``. Only a
caller that asks for ``"cpu"`` gets the CPU (the tests do); on a machine
without a card ``"cuda"`` raises instead of dropping to the CPU.
"""

import logging
import sys

import torch

__version__ = "0.1.0"

logger = logging.getLogger("imcui_tpu_torch")
logger.setLevel(logging.INFO)
if not logger.handlers:
    _handler = logging.StreamHandler(sys.stdout)
    _handler.setFormatter(logging.Formatter(
        fmt="[%(asctime)s %(name)s %(levelname)s] %(message)s",
        datefmt="%Y/%m/%d %H:%M:%S"))
    _handler.setLevel(logging.INFO)
    logger.addHandler(_handler)
logger.propagate = False


def resolve_device(device="cuda"):
    """``device`` as a torch.device; raises when CUDA is asked for and
    absent (nothing falls back to the CPU quietly)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch sees no CUDA device; "
            "pass device='cpu' to run the plain PyTorch path")
    return dev
