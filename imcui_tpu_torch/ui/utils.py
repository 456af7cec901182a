"""Application-layer orchestration: config and model zoo resolution,
geometric verification and the per-request pipeline. Counterpart of the
part of ``imcui_tpu/ui/utils.py`` that needs neither OpenCV nor
matplotlib: same function names, same pred keys in and out.
``wrap_images`` and ``generate_warp_images`` feed only the gradio WebUI
and wait with ``ui/viz.py``.

The estimator is the batched RANSAC of ``ops/ransac.py`` on the model's
device, under the registry key the JAX package gave its on-device
estimator (``TPU_LORANSAC``), so configs resolve unchanged. The
``CV2_*`` estimators and the uncalibrated stereo rectification (H1, H2)
need the cv2 package, which this package does not import: asking for one
raises ``NotImplementedError``.
"""

import pickle
from copy import deepcopy
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch

from .. import logger, resolve_device
from ..configs import confs_dict
from ..models import extractors as extractors_mod
from ..models import matchers as matchers_mod
from ..ops import ransac as ransac_ops
from ..utils.base_model import dynamic_load
from ..utils.io import read_yaml

DEFAULT_SETTING_THRESHOLD = 0.1
DEFAULT_SETTING_MAX_FEATURES = 2000
DEFAULT_DEFAULT_KEYPOINT_THRESHOLD = 0.01
DEFAULT_ENABLE_RANSAC = True
DEFAULT_RANSAC_METHOD = "TPU_LORANSAC"
DEFAULT_RANSAC_REPROJ_THRESHOLD = 8
DEFAULT_RANSAC_CONFIDENCE = 0.9999
DEFAULT_RANSAC_MAX_ITER = 10000
DEFAULT_MIN_NUM_MATCHES = 4
DEFAULT_MATCHING_THRESHOLD = 0.2
DEFAULT_SETTING_GEOMETRY = "Homography"

# name → estimator; None marks the estimators that need cv2
ransac_zoo = {
    "TPU_LORANSAC": "device",
    "CV2_RANSAC": None,
    "CV2_USAC_MAGSAC": None,
    "CV2_USAC_DEFAULT": None,
    "CV2_USAC_FM_8PTS": None,
    "CV2_USAC_PROSAC": None,
    "CV2_USAC_FAST": None,
    "CV2_USAC_ACCURATE": None,
    "CV2_USAC_PARALLEL": None,
}


def load_config(config_path):
    """An app.yaml (``utils/io.py::read_yaml``)."""
    return read_yaml(config_path)


def get_matcher_zoo(matcher_zoo):
    """The enabled zoo entries, each resolved by ``parse_match_config``."""
    out = {}
    for key, conf in matcher_zoo.items():
        if not conf.get("enable", True):
            continue
        out[key] = parse_match_config(conf)
    return out


def parse_match_config(conf):
    """String refs → conf dicts from the registry."""
    if conf.get("dense", False) or conf.get("standalone", False):
        return {
            **conf,
            "matcher": deepcopy(confs_dict["matchers"][conf["matcher"]]),
            "dense": True,
            "standalone": True,
        }
    return {
        **conf,
        "feature": deepcopy(confs_dict["extractors"][conf["feature"]]),
        "matcher": deepcopy(confs_dict["matchers"][conf["matcher"]]),
        "dense": False,
        "standalone": False,
    }


def get_model(match_conf, device="cuda"):
    """Instantiate a matcher on ``device``."""
    Model = dynamic_load(matchers_mod, match_conf["model"]["name"])
    return Model(match_conf["model"], device=device)


def get_feature_model(conf, device="cuda"):
    """Instantiate an extractor on ``device``."""
    Model = dynamic_load(extractors_mod, conf["model"]["name"])
    return Model(conf["model"], device=device)


def set_null_pred(feature_type: Optional[str], pred: dict):
    if feature_type == "KEYPOINT":
        pred["mmkeypoints0_orig"] = np.array([])
        pred["mmkeypoints1_orig"] = np.array([])
        pred["mmconf"] = np.array([])
    elif feature_type == "LINE":
        pred["mline_keypoints0_orig"] = np.array([])
        pred["mline_keypoints1_orig"] = np.array([])
    pred["H"] = None
    pred["geom_info"] = {}
    return pred


def _device_ransac(kp0, kp1, reproj_threshold, max_iter, geometry_type,
                   device="cuda", sample=ransac_ops.sample_indices):
    """Batched RANSAC (ops/ransac.py) behind the cv2-shaped (M, mask)
    return convention. The correspondences are padded to a power of two
    ≥ 64 and the hypotheses drawn by ``sample(mask, S, k, generator)`` from
    a generator seeded 0 (a test passes the JAX package's index set)."""
    dev = resolve_device(device)
    model = "homography" if geometry_type == "Homography" else "fundamental"
    n = len(kp0)
    n_pad = max(64, int(2 ** np.ceil(np.log2(n))))
    p0 = np.zeros((1, n_pad, 2), np.float32)
    p1 = np.zeros((1, n_pad, 2), np.float32)
    mask = np.zeros((1, n_pad), bool)
    p0[0, :n], p1[0, :n], mask[0, :n] = kp0, kp1, True
    hyps = int(min(2048, max(256, max_iter // 4)))
    mask_t = torch.as_tensor(mask, device=dev)
    idx = sample(mask_t, hyps, ransac_ops.minimal_size(model),
                 torch.Generator(device=dev).manual_seed(0))
    out = ransac_ops.ransac_from_indices(
        idx, torch.as_tensor(p0, device=dev), torch.as_tensor(p1, device=dev),
        mask_t, model=model, threshold=float(reproj_threshold))
    M = out["M"][0].cpu().numpy().astype(np.float64)
    inliers = out["inliers"][0, :n].cpu().numpy()
    return M, inliers


def proc_ransac_matches(mkpts0, mkpts1, ransac_method=DEFAULT_RANSAC_METHOD,
                        ransac_reproj_threshold=3.0, ransac_confidence=0.99,
                        ransac_max_iter=2000, geometry_type="Homography",
                        device="cuda", sample=ransac_ops.sample_indices):
    if ransac_method.startswith("TPU"):
        return _device_ransac(mkpts0, mkpts1, ransac_reproj_threshold,
                              ransac_max_iter, geometry_type, device, sample)
    if ransac_method.startswith("CV2"):
        raise NotImplementedError(
            f"RANSAC method {ransac_method} needs the cv2 package, which the "
            f"port does not use; {DEFAULT_RANSAC_METHOD} runs on the device")
    raise NotImplementedError(ransac_method)


def compute_geometry(pred, ransac_method=DEFAULT_RANSAC_METHOD,
                     ransac_reproj_threshold=DEFAULT_RANSAC_REPROJ_THRESHOLD,
                     ransac_confidence=DEFAULT_RANSAC_CONFIDENCE,
                     ransac_max_iter=DEFAULT_RANSAC_MAX_ITER, device="cuda",
                     sample=ransac_ops.sample_indices):
    """Fundamental matrix, then homography, over the raw matches. The
    rectifying homographies H1 and H2 of the JAX package come from
    cv2.stereoRectifyUncalibrated and are left out."""
    mkpts0 = mkpts1 = None
    if "mkeypoints0_orig" in pred and "mkeypoints1_orig" in pred:
        mkpts0, mkpts1 = pred["mkeypoints0_orig"], pred["mkeypoints1_orig"]
    elif "line_keypoints0_orig" in pred and "line_keypoints1_orig" in pred:
        mkpts0 = pred["line_keypoints0_orig"]
        mkpts1 = pred["line_keypoints1_orig"]
    if mkpts0 is None or mkpts1 is None:
        return {}
    if len(mkpts0) < 2 * DEFAULT_MIN_NUM_MATCHES:
        return {}

    geo_info: Dict[str, Any] = {}
    F, mask_f = proc_ransac_matches(
        mkpts0, mkpts1, ransac_method, ransac_reproj_threshold,
        ransac_confidence, ransac_max_iter, geometry_type="Fundamental",
        device=device, sample=sample,
    )
    if F is not None:
        geo_info["Fundamental"] = F.tolist()
        geo_info["mask_f"] = mask_f
    H, mask_h = proc_ransac_matches(
        mkpts0, mkpts1, ransac_method, ransac_reproj_threshold,
        ransac_confidence, ransac_max_iter, geometry_type="Homography",
        device=device, sample=sample,
    )
    if H is not None:
        geo_info["Homography"] = H.tolist()
        geo_info["mask_h"] = mask_h
    return geo_info


def filter_matches(pred, ransac_method=DEFAULT_RANSAC_METHOD,
                   ransac_reproj_threshold=DEFAULT_RANSAC_REPROJ_THRESHOLD,
                   ransac_confidence=DEFAULT_RANSAC_CONFIDENCE,
                   ransac_max_iter=DEFAULT_RANSAC_MAX_ITER, device="cuda",
                   sample=ransac_ops.sample_indices):
    """RANSAC filter: adds mmkeypoints*_orig, mmconf, H and geom_info."""
    feature_type = None
    mkpts0 = mkpts1 = None
    if "mkeypoints0_orig" in pred and "mkeypoints1_orig" in pred:
        mkpts0, mkpts1 = pred["mkeypoints0_orig"], pred["mkeypoints1_orig"]
        feature_type = "KEYPOINT"
    elif "line_keypoints0_orig" in pred and "line_keypoints1_orig" in pred:
        mkpts0 = pred["line_keypoints0_orig"]
        mkpts1 = pred["line_keypoints1_orig"]
        feature_type = "LINE"
    else:
        return set_null_pred(feature_type, pred)
    if mkpts0 is None or mkpts1 is None:
        return set_null_pred(feature_type, pred)
    if ransac_method not in ransac_zoo:
        ransac_method = DEFAULT_RANSAC_METHOD
    if len(mkpts0) < DEFAULT_MIN_NUM_MATCHES:
        return set_null_pred(feature_type, pred)

    geom_info = compute_geometry(
        pred, ransac_method=ransac_method,
        ransac_reproj_threshold=ransac_reproj_threshold,
        ransac_confidence=ransac_confidence,
        ransac_max_iter=ransac_max_iter, device=device, sample=sample,
    )
    if "Homography" in geom_info:
        mask = np.asarray(geom_info["mask_h"])
        if feature_type == "KEYPOINT":
            pred["mmkeypoints0_orig"] = mkpts0[mask]
            pred["mmkeypoints1_orig"] = mkpts1[mask]
            pred["mmconf"] = pred["mconf"][mask]
        elif feature_type == "LINE":
            pred["mline_keypoints0_orig"] = mkpts0[mask]
            pred["mline_keypoints1_orig"] = mkpts1[mask]
        pred["H"] = np.array(geom_info["Homography"])
    else:
        set_null_pred(feature_type, pred)
    geom_info.pop("mask_h", None)
    geom_info.pop("mask_f", None)
    pred["geom_info"] = geom_info
    return pred


def run_matching(
    image0,
    image1,
    match_threshold=DEFAULT_MATCHING_THRESHOLD,
    extract_max_keypoints=DEFAULT_SETTING_MAX_FEATURES,
    keypoint_threshold=DEFAULT_DEFAULT_KEYPOINT_THRESHOLD,
    key="superpoint+lightglue",
    ransac_method=DEFAULT_RANSAC_METHOD,
    ransac_reproj_threshold=DEFAULT_RANSAC_REPROJ_THRESHOLD,
    ransac_confidence=DEFAULT_RANSAC_CONFIDENCE,
    ransac_max_iter=DEFAULT_RANSAC_MAX_ITER,
    choice_geometry_type=DEFAULT_SETTING_GEOMETRY,
    matcher_zoo=None,
    force_resize=False,
    image_width=640,
    image_height=480,
    use_cached_model=True,
    device="cuda",
):
    """One pair through the zoo entry ``key`` on ``device``: extraction and
    matching (or the dense matcher), then the RANSAC filter. Returns the
    pred dict. As in the JAX package, ``match_threshold`` and
    ``extract_max_keypoints`` (and the extractor's ``keypoint_threshold``)
    are written into the zoo entry's conf in place, and the global model
    cache keys on that conf; here it keys on the device too. An entry
    whose model is not ported raises ``NotImplementedError`` naming it."""
    from ..pipeline import extract_features, match_dense, match_features
    from .modelcache import get_global_cache

    if image0 is None or image1 is None:
        raise ValueError("Error: No images found! Please upload two images.")
    if matcher_zoo is None:
        raise ValueError("matcher_zoo is required")
    dev = resolve_device(device)
    model = matcher_zoo[key]
    match_conf = model["matcher"]
    # update match config with UI values
    match_conf["model"]["match_threshold"] = match_threshold
    match_conf["model"]["max_keypoints"] = extract_max_keypoints

    cache = get_global_cache()
    matcher = cache.load_model((match_conf["model"]["name"], str(dev)),
                               lambda c: get_model(c, dev), match_conf)
    resize = ({"force_resize": True, "width": image_width,
               "height": image_height} if force_resize else {})
    if model["dense"]:
        pconf = {**match_conf.get("preprocessing", {}), **resize}
        pred = match_dense.match_images(matcher, image0, image1, pconf)
    else:
        extract_conf = model["feature"]
        extract_conf["model"]["max_keypoints"] = extract_max_keypoints
        extract_conf["model"]["keypoint_threshold"] = keypoint_threshold
        extractor = cache.load_model(
            (extract_conf["model"]["name"], str(dev)),
            lambda c: get_feature_model(c, dev), extract_conf)
        pconf = {**extract_conf.get("preprocessing", {}), **resize}
        pred0 = extract_features.extract(extractor, image0, pconf)
        pred1 = extract_features.extract(extractor, image1, pconf)
        pred = match_features.match_images(matcher, pred0, pred1)
        pred["image0_orig"] = image0
        pred["image1_orig"] = image1

    return filter_matches(
        pred,
        ransac_method=ransac_method,
        ransac_reproj_threshold=ransac_reproj_threshold,
        ransac_confidence=ransac_confidence,
        ransac_max_iter=ransac_max_iter,
        device=dev,
    )


def run_ransac(state_cache, choice_geometry_type, ransac_method,
               ransac_reproj_threshold, ransac_confidence, ransac_max_iter,
               output_dir=None, device="cuda",
               sample=ransac_ops.sample_indices):
    """The RANSAC filter again on a cached pred dict; with ``output_dir``
    the result is also pickled to ``<output_dir>/output.pkl``. ``sample``
    draws the hypotheses, as in ``filter_matches``."""
    if not state_cache:
        logger.info("Error: re-run failed, no state cached!")
        return None
    pred = filter_matches(
        state_cache,
        ransac_method=ransac_method,
        ransac_reproj_threshold=ransac_reproj_threshold,
        ransac_confidence=ransac_confidence,
        ransac_max_iter=ransac_max_iter,
        device=device,
        sample=sample,
    )
    if output_dir is not None:
        output = Path(output_dir) / "output.pkl"
        output.parent.mkdir(exist_ok=True, parents=True)
        with open(output, "wb") as f:
            pickle.dump(pred, f)
    return pred
