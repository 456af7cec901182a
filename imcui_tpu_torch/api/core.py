"""Programmatic matching API. Counterpart of ``imcui_tpu/api/core.py``:
same conf schema, same output keys, same ``extract``/``forward`` methods,
for both branches: sparse (an extractor and a matcher) and dense
(``standalone``: one matcher that takes the two images, through
``pipeline/match_dense.py``).

Models are constructed once on ``device`` (``"cuda"`` raises without a
card); geometric verification is the batched RANSAC of ``ops/ransac.py``
on that device. ``visualize`` is not ported.
"""

from typing import Any, Dict

import numpy as np

from .. import logger, resolve_device
from ..pipeline import extract_features, match_dense, match_features
from ..ui.utils import (DEFAULT_RANSAC_METHOD, filter_matches, get_model,
                        get_feature_model)


class ImageMatchingAPI:
    default_conf = {
        "ransac": {
            "enable": True,
            "estimator": "tpu",
            "geometry": "homography",
            "method": DEFAULT_RANSAC_METHOD,
            "reproj_threshold": 3,
            "confidence": 0.9999,
            "max_iter": 10000,
        },
    }

    def __init__(self, conf: dict = None, device: str = "cuda",
                 detect_threshold: float = 0.015,
                 max_keypoints: int = 1024,
                 match_threshold: float = 0.2) -> None:
        self.device = resolve_device(device)
        self.conf = {**self.default_conf, **(conf or {})}
        self._update_config(detect_threshold, max_keypoints, match_threshold)
        self._init_models()
        self.pred = None

    def parse_match_config(self, conf):
        """Model names in ``conf`` → the registry's conf dicts."""
        if conf["standalone"]:
            return {
                **conf,
                "matcher": match_dense.confs.get(
                    conf["matcher"]["model"]["name"]
                ),
                "standalone": True,
            }
        return {
            **conf,
            "feature": extract_features.confs.get(
                conf["feature"]["model"]["name"]
            ),
            "matcher": match_features.confs.get(
                conf["matcher"]["model"]["name"]
            ),
            "standalone": False,
        }

    def _update_config(self, detect_threshold=0.015, max_keypoints=1024,
                       match_threshold=0.2):
        self.standalone = self.conf["standalone"]
        if self.standalone:
            self.conf["matcher"]["model"]["match_threshold"] = \
                match_threshold
        else:
            self.conf["feature"]["model"]["max_keypoints"] = max_keypoints
            self.conf["feature"]["model"]["keypoint_threshold"] = \
                detect_threshold
            self.extract_conf = self.conf["feature"]
        self.match_conf = self.conf["matcher"]

    def _init_models(self):
        self.matcher = get_model(self.match_conf, self.device)
        if self.standalone:
            self.extractor = None
            logger.info(f"matcher weights: {self.matcher.meta}")
            return
        self.extractor = get_feature_model(self.conf["feature"], self.device)
        logger.info(f"extractor weights: {self.extractor.meta}; matcher "
                    f"weights: {self.matcher.meta}")

    def _forward(self, img0, img1):
        if self.standalone:
            return match_dense.match_images(
                self.matcher, img0, img1,
                self.match_conf.get("preprocessing", {}))
        pred0 = extract_features.extract(
            self.extractor, img0, self.extract_conf["preprocessing"]
        )
        pred1 = extract_features.extract(
            self.extractor, img1, self.extract_conf["preprocessing"]
        )
        pred = match_features.match_images(self.matcher, pred0, pred1)
        pred["image0_orig"] = img0
        pred["image1_orig"] = img1
        return pred

    def extract(self, img0: np.ndarray, **kwargs) -> Dict[str, np.ndarray]:
        """Single-image extraction: the valid keypoints, their scores and
        descriptors, and keypoints_orig at the original resolution;
        ``binarize`` turns the descriptors into (N, D) sign bits. A
        standalone (dense) matcher has no extractor and raises."""
        if self.extractor is None:
            raise RuntimeError(
                "extract() needs an extractor, and this API serves the "
                f"standalone matcher {self.match_conf['model']['name']!r}, "
                "which takes the two images itself: use forward()")
        self.extractor.conf["max_keypoints"] = kwargs.get("max_keypoints", 512)
        self.extractor.conf["keypoint_threshold"] = kwargs.get(
            "keypoint_threshold", 0.0
        )
        pred = extract_features.extract(
            self.extractor, img0, self.extract_conf["preprocessing"]
        )
        # trim padding (host boundary)
        trimmed = extract_features.trim_valid(pred)
        for k in ("image", "original_size", "size"):
            trimmed[k] = np.asarray(pred[k])
        s0 = trimmed["original_size"] / trimmed["size"]
        trimmed["keypoints_orig"] = (
            match_features.scale_keypoints(trimmed["keypoints"] + 0.5, s0)
            - 0.5
        )
        if kwargs.get("binarize", False):
            trimmed["descriptors"] = (trimmed["descriptors"] > 0).astype(
                np.uint8
            )
            trimmed["descriptors"] = trimmed["descriptors"].T  # N x DIM
        return trimmed

    def forward(self, img0: np.ndarray, img1: np.ndarray) -> Dict[str, Any]:
        """Match a pair. Output keys: image*_orig, keypoints*_orig,
        mkeypoints*_orig (raw matches), mmkeypoints*_orig (RANSAC
        inliers), mconf, mmconf, H, geom_info."""
        if not (isinstance(img0, np.ndarray) and isinstance(img1, np.ndarray)):
            raise TypeError("forward takes two numpy images")
        self.pred = self._forward(img0, img1)
        if self.conf["ransac"]["enable"]:
            self.pred = self._geometry_check(self.pred)
        return self.pred

    __call__ = forward

    def _geometry_check(self, pred):
        return filter_matches(
            pred,
            ransac_method=self.conf["ransac"]["method"],
            ransac_reproj_threshold=self.conf["ransac"]["reproj_threshold"],
            ransac_confidence=self.conf["ransac"]["confidence"],
            ransac_max_iter=self.conf["ransac"]["max_iter"],
            device=self.device,
        )

    def visualize(self, log_path=None) -> None:
        raise NotImplementedError(
            "visualize writes PNGs with the cv2 package, which the port "
            "does not use (ROADMAP §A, the rest of the user surfaces)")
