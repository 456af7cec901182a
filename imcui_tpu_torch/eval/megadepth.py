"""Relative-pose evaluation harness (MegaDepth-1500 style). Counterpart
of ``imcui_tpu/eval/megadepth.py``: pose AUC@5°/10°/20° over a pair list,
each pair through match → fundamental RANSAC on the device → essential →
pose recovery → angular error (``ops/pose.py``); only image loading and
the AUC stay on the host.

Pair-list format: a JSON file with entries
  {"img0": path, "img1": path, "K0": 3x3, "K1": 3x3,
   "R": 3x3, "t": [3]}          # T_0to1 ground truth
``convert_scene_info`` converts an upstream ``megadepth_test_1500`` scene
npz into it; the dataset itself is not in the repository, so the pair
lists at hand are ``eval/synthpose.py``'s.

Randomness: one ``torch.Generator`` on the device per pair, seeded
``seed + i`` (the JAX package's ``PRNGKey(i)``; the streams differ).
"""

import copy
import json
from pathlib import Path

import numpy as np
import torch

from .. import logger, resolve_device
from ..ops import pose as pose_ops


def convert_scene_info(scene_info_npz, image_root, output_json):
    """Convert an upstream MegaDepth scene_info npz (pair_infos, poses,
    intrinsics arrays) into the flat JSON pair list."""
    info = np.load(scene_info_npz, allow_pickle=True)
    pairs = []
    poses = info["poses"]
    intrinsics = info["intrinsics"]
    image_paths = info["image_paths"]
    for pair_info in info["pair_infos"]:
        (idx0, idx1) = pair_info[0]
        T0 = poses[idx0]
        T1 = poses[idx1]
        T_0to1 = T1 @ np.linalg.inv(T0)
        pairs.append(
            {
                "img0": str(Path(image_root) / str(image_paths[idx0])),
                "img1": str(Path(image_root) / str(image_paths[idx1])),
                "K0": np.asarray(intrinsics[idx0]).tolist(),
                "K1": np.asarray(intrinsics[idx1]).tolist(),
                "R": T_0to1[:3, :3].tolist(),
                "t": T_0to1[:3, 3].tolist(),
            }
        )
    with open(output_json, "w") as f:
        json.dump(pairs, f)
    return pairs


def evaluate_pairs(matcher_fn, pairs, ransac_threshold_px=0.5,
                   num_hypotheses=2048, max_pairs=None, seed=0,
                   device="cuda"):
    """Run the eval. ``matcher_fn(img0_path, img1_path)`` returns (mkpts0,
    mkpts1) in original-resolution pixels. A pair with fewer than 8
    matches scores 180°; the others are padded to max(64, 2^⌈log2 n⌉)
    slots, as in the JAX package.

    Returns dict with aucs @5/10/20, median error, mean matches and the
    per-pair errors."""
    dev = resolve_device(device)
    errors = []
    n_matches = []
    for i, pair in enumerate(pairs if max_pairs is None
                             else pairs[:max_pairs]):
        mkpts0, mkpts1 = matcher_fn(pair["img0"], pair["img1"])
        n = len(mkpts0)
        n_matches.append(n)
        if n < 8:
            errors.append(180.0)
            continue
        n_pad = max(64, int(2 ** np.ceil(np.log2(n))))
        p0 = np.zeros((n_pad, 2), np.float32)
        p1 = np.zeros((n_pad, 2), np.float32)
        mask = np.zeros((n_pad,), bool)
        p0[:n], p1[:n], mask[:n] = mkpts0, mkpts1, True
        gen = torch.Generator(device=dev).manual_seed(seed + i)
        out = pose_ops.estimate_pose(
            p0, p1, mask, pair["K0"], pair["K1"], gen,
            threshold_px=ransac_threshold_px, num_hypotheses=num_hypotheses,
            device=dev)
        R_gt, t_gt = (torch.as_tensor(pair[k], dtype=torch.float32,
                                      device=dev) for k in ("R", "t"))
        errors.append(float(pose_ops.pose_error(out["R"], out["t"], R_gt,
                                                t_gt)))
        if (i + 1) % 100 == 0:
            logger.info(f"evaluated {i + 1} pairs")

    aucs = pose_ops.pose_auc(errors, thresholds=(5.0, 10.0, 20.0))
    return {
        "auc@5": aucs[0],
        "auc@10": aucs[1],
        "auc@20": aucs[2],
        "median_err_deg": float(np.median(errors)),
        "mean_matches": float(np.mean(n_matches)) if n_matches else 0.0,
        "errors": errors,
    }


def api_matcher_fn(api):
    """Adapt an ImageMatchingAPI instance into the matcher_fn protocol."""
    from ..utils.image import read_image

    def fn(path0, path1):
        pred = api(read_image(path0), read_image(path1))
        return (np.asarray(pred["mkeypoints0_orig"]),
                np.asarray(pred["mkeypoints1_orig"]))

    return fn


def matcher_conf(matcher, feature_opts=None, matcher_opts=None):
    """The zoo entry ``matcher`` of the default app.yaml with RANSAC off
    and the shallow model-conf overrides applied."""
    from ..cli.main import get_default_config_path
    from ..ui.utils import get_matcher_zoo, load_config

    cfg = load_config(get_default_config_path())
    zoo = get_matcher_zoo(cfg["matcher_zoo"])
    conf = copy.deepcopy(zoo[matcher])
    conf["ransac"] = {"enable": False}
    if feature_opts and "feature" in conf:
        conf["feature"]["model"].update(feature_opts)
    if matcher_opts and "matcher" in conf:
        conf["matcher"]["model"].update(matcher_opts)
    return conf


def evaluate_matcher(pairs, matcher="superpoint+lightglue",
                     max_pairs=None, ransac_threshold_px=0.75,
                     feature_opts=None, matcher_opts=None, seed=0,
                     device="cuda"):
    """Evaluate a named zoo matcher on a pair list (MegaDepth or
    eval/synthpose pairs, one schema) on ``device``.

    ``feature_opts`` / ``matcher_opts``: shallow model-conf overrides. As
    in the JAX package, ``ImageMatchingAPI``'s constructor then applies its
    own defaults over them: on the sparse branch ``max_keypoints`` 1024 and
    ``keypoint_threshold`` 0.015 (so of ``feature_opts`` only keys such as
    ``subpixel`` take effect), on the dense branch ``match_threshold``
    0.2."""
    from ..api.core import ImageMatchingAPI

    conf = matcher_conf(matcher, feature_opts, matcher_opts)
    api = ImageMatchingAPI(conf=conf, device=device)
    return evaluate_pairs(api_matcher_fn(api), pairs,
                          ransac_threshold_px=ransac_threshold_px,
                          max_pairs=max_pairs, seed=seed, device=device)


def main(pairs_json, matcher="superpoint+lightglue", max_pairs=None,
         output=None, device="cuda"):
    """Evaluate a zoo matcher on a converted pair list."""
    with open(pairs_json) as f:
        pairs = json.load(f)
    result = evaluate_matcher(pairs, matcher, max_pairs=max_pairs,
                              device=device)
    summary = {k: v for k, v in result.items() if k != "errors"}
    logger.info(f"MegaDepth eval [{matcher}]: {summary}")
    if output:
        with open(output, "w") as f:
            json.dump(result, f)
    return result


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("pairs_json")
    p.add_argument("--matcher", default="superpoint+lightglue")
    p.add_argument("--max-pairs", type=int, default=None)
    p.add_argument("--output", default=None)
    p.add_argument("--device", default="cuda")
    args = p.parse_args()
    main(args.pairs_json, args.matcher, args.max_pairs, args.output,
         args.device)
