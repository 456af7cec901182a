"""The JAX package's superpoint+adalam on chip_smoke.py phase 10's planted
pairs, on the CPU.

    JAX_PLATFORMS=cpu HF_HUB_OFFLINE=1 python tests/jax_adalam_reference.py

Builds the JAX package's ImageMatchingAPI on the packaged zoo entry
``superpoint+adalam`` (superpoint_1024 with the trained tree in weights/,
AdaLAM) at the API's defaults, as phase 10 builds the port's, answers
the planted 1600 x 1200 pairs of chip_smoke.Z_SEEDS and prints one JSON
line: per pair the keypoints, raw matches, RANSAC inliers and their
median transfer error against the planted homography. chip_smoke.py
reports these numbers beside the card's (Z_JAX_CPU). Not a test: about a
minute.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import chip_smoke
    from imcui_tpu.api.core import ImageMatchingAPI
    from imcui_tpu.ui import utils as ui

    zoo = ui.get_matcher_zoo(ui.load_config(
        ROOT / "imcui_tpu" / "config" / "app.yaml")["matcher_zoo"])
    conf = zoo["superpoint+adalam"]
    conf["feature"]["model"]["checkpoint_npz"] = str(
        ROOT / chip_smoke.SP_TRAINED)
    api = ImageMatchingAPI(conf)
    out = {}
    for seed in chip_smoke.Z_SEEDS:
        img0, img1, hm = chip_smoke.synthetic_pair(seed, *chip_smoke.Z_SIZE)
        t0 = time.perf_counter()
        pred = api(img0, img1)
        err = chip_smoke.transfer_errors(hm, pred["mmkeypoints0_orig"],
                                         pred["mmkeypoints1_orig"])
        out[seed] = {"keypoints": [len(pred["keypoints0_orig"]),
                                   len(pred["keypoints1_orig"])],
                     "raw_matches": len(pred["mkeypoints0_orig"]),
                     "inliers": len(err),
                     "median_px": round(float(np.median(err)), 4)
                     if len(err) else None,
                     "seconds": round(time.perf_counter() - t0, 2)}
    print(json.dumps({"superpoint+adalam": out}))


if __name__ == "__main__":
    main()
