"""The JAX package's gluestick on chip_smoke.py phase 13's planted pairs,
on the CPU.

    JAX_PLATFORMS=cpu HF_HUB_OFFLINE=1 python tests/jax_gluestick_reference.py

Builds the JAX package's ImageMatchingAPI on the packaged zoo entry
``gluestick`` (the trained SuperPoint in weights/, OpenCV's LSD, mutual
nearest neighbours and the line vote), as phase 13 builds the port's,
answers the planted 1600 x 1200 pairs of chip_smoke.N_SEEDS and prints one
JSON line: per pair the raw point matches, RANSAC inliers and their median
transfer error against the planted homography, the raw and matched lines,
and the share of matched lines whose H-mapped endpoints lie within
chip_smoke.N_LINE_PX of the matched segment's line. chip_smoke.py reports
these numbers beside the card's (N_JAX_CPU). Not a test: about a minute.
"""

import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main():
    import chip_smoke
    from imcui_tpu.api.core import ImageMatchingAPI
    from imcui_tpu.ui import utils as ui

    zoo = ui.get_matcher_zoo(ui.load_config(
        ROOT / "imcui_tpu" / "config" / "app.yaml")["matcher_zoo"])
    api = ImageMatchingAPI(zoo["gluestick"])
    out = {}
    for seed in chip_smoke.N_SEEDS:
        img0, img1, hm = chip_smoke.synthetic_pair(seed, *chip_smoke.Z_SIZE)
        t0 = time.perf_counter()
        pred = api(img0, img1)
        out[seed] = chip_smoke.gluestick_gate(pred, hm)
        out[seed]["seconds"] = round(time.perf_counter() - t0, 2)
    print(json.dumps({"gluestick": out}))


if __name__ == "__main__":
    main()
