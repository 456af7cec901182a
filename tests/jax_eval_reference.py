"""The JAX package's numbers on chip_smoke.py phase 9's inputs, on the CPU.

    JAX_PLATFORMS=cpu HF_HUB_OFFLINE=1 python tests/jax_eval_reference.py [OUT]

Writes phase 9's corpus (chip_smoke.E_CORPUS: textured 480 x 640 photos as
RGB PNG) under OUT (a temporary directory by default), makes the same
synthetic-pose pairs with imcui_tpu.eval.synthpose.generate_pairs, runs
imcui_tpu.eval.megadepth.evaluate_matcher on them as the JAX ``eval pose``
command does (the flagship with subpixel peaks, and loftr; RANSAC at
chip_smoke.E_RANSAC_PX), then imcui_tpu.eval.warp.evaluate_warp on
chip_smoke.E_WARP_SEED's photo with the trained flagship of
tests/test_accuracy_warp.py, and prints one JSON line. chip_smoke.py
reports these numbers beside the card's (E_JAX_CPU) and sets its
evaluate_warp gate from them (E_WARP_GATE). Not a test: about 2 minutes.
"""

import json
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main(out):
    os.chdir(ROOT)  # the zoo of config/app.yaml, as the CLI from the root
    import chip_smoke
    from imcui_tpu.api.core import ImageMatchingAPI
    from imcui_tpu.eval import megadepth, synthpose, warp
    from imcui_tpu_torch.utils.png import encode_png
    from test_accuracy_warp import _trained_flagship_conf

    corpus = Path(out) / "corpus"
    corpus.mkdir(parents=True, exist_ok=True)
    for i, seed in enumerate(chip_smoke.E_CORPUS):
        img = chip_smoke.textured_image(np.random.default_rng(seed),
                                        *chip_smoke.E_SIZE)
        (corpus / f"photo{i}.png").write_bytes(
            encode_png(np.repeat(img[..., None], 3, -1)))
    pairs = synthpose.generate_pairs(
        sorted(corpus.iterdir()), Path(out) / "pairs",
        n_pose_per_image=chip_smoke.E_POSES, size=chip_smoke.E_SIZE, seed=0)
    result = {"pairs": len(pairs)}
    for name, opts in (("superpoint+lightglue", {"subpixel": True}),
                       ("loftr", None)):
        res = megadepth.evaluate_matcher(
            pairs, name, ransac_threshold_px=chip_smoke.E_RANSAC_PX,
            feature_opts=opts)
        result[name] = {k: v for k, v in res.items() if k != "errors"}
    img = chip_smoke.textured_image(
        np.random.default_rng(chip_smoke.E_WARP_SEED), *chip_smoke.E_SIZE)
    _, result["warp"] = warp.evaluate_warp(
        ImageMatchingAPI(conf=_trained_flagship_conf()),
        np.repeat(img[..., None], 3, -1))
    print(json.dumps(result))


if __name__ == "__main__":
    if len(sys.argv) > 1:
        main(sys.argv[1])
    else:
        with tempfile.TemporaryDirectory() as tmp:
            main(tmp)
