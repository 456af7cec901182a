"""Turbo serving path: the two-view step behind a micro-batcher.

Counterpart of ``imcui_tpu/api/turbo.py:TurboMatcher``. Every request is
resized onto one fixed canvas, concurrent requests are micro-batched
(parallel/dispatch.py) into a fixed pair batch, and one step —
SuperPoint → LightGlue → RANSAC (pipeline/two_view.py) — runs per batch
on ``device``.
"""

import logging
import threading

import numpy as np
import torch

from .. import resolve_device
from ..parallel.dispatch import MicroBatcher
from ..pipeline import two_view
from ..utils import image as image_utils

logger = logging.getLogger(__name__)


class TurboMatcher:
    """Fixed-shape two-view matching service core."""

    def __init__(self, canvas=1024, max_keypoints=1024, n_layers=9,
                 batch_size=4, max_wait_ms=4.0, num_hypotheses=512,
                 match_threshold=0.1, device="cuda"):
        self.device = resolve_device(device)
        self.canvas = canvas
        self.batch_size = batch_size
        self.params, self.meta = two_view.load_pretrained(
            n_layers=n_layers, device=self.device)
        self._step_kwargs = dict(
            max_keypoints=max_keypoints, num_hypotheses=num_hypotheses,
            match_threshold=match_threshold, ransac="fundamental")
        self._gen_lock = threading.Lock()
        self._generator = torch.Generator(device=self.device).manual_seed(0)
        # the first step builds the CUDA kernels; pay it here, not in a
        # user's request
        dummy = np.zeros((canvas, canvas, 3), np.uint8)
        self._run_batch([(self._prep(dummy), self._prep(dummy))])
        self._batcher = MicroBatcher(self._run_batch, batch_size=batch_size,
                                     max_wait_ms=max_wait_ms)
        logger.info("TurboMatcher ready: canvas %d, batch %d, %d layers, "
                    "weights %s", canvas, batch_size, n_layers, self.meta)

    def _prep(self, image):
        """RGB/gray ndarray → fixed canvas + valid size + rescale factor."""
        return image_utils.preprocess(image, grayscale=True,
                                      resize_max=self.canvas, dfactor=8,
                                      buckets=(self.canvas,))

    def _run_batch(self, items):
        n, c = self.batch_size, self.canvas
        im0 = np.zeros((n, 1, c, c), np.float32)
        im1 = np.zeros_like(im0)
        wh0 = np.ones((n, 2), np.int32)
        wh1 = np.ones((n, 2), np.int32)
        for i, (d0, d1) in enumerate(items):
            im0[i] = d0["image"][0]
            im1[i] = d1["image"][0]
            wh0[i] = d0["size"]
            wh1[i] = d1["size"]
        dev = self.device
        with self._gen_lock, torch.inference_mode():
            out = two_view.match_step(
                self.params, torch.from_numpy(im0).to(dev),
                torch.from_numpy(im1).to(dev), torch.from_numpy(wh0).to(dev),
                torch.from_numpy(wh1).to(dev), self._generator,
                device=dev, **self._step_kwargs)
        out = {k: v.cpu().numpy() for k, v in out.items()}
        return [{k: v[i] for k, v in out.items()} for i in range(len(items))]

    def match(self, image0, image1):
        """Match one pair; blocks until its micro-batch has run.

        Returns, at original resolution, the keypoints, the RANSAC-inlier
        correspondences mkeypoints0/1_orig with their confidences mconf,
        the fundamental matrix under "M" and num_inliers."""
        d0 = self._prep(image0)
        d1 = self._prep(image1)
        out = self._batcher.submit((d0, d1))
        s0 = d0["original_size"] / d0["size"]
        s1 = d1["original_size"] / d1["size"]
        inl = out["inliers"] & (out["matches0"] > -1)
        return {
            "keypoints0_orig": image_utils.keypoints_to_original(
                out["keypoints0"][out["mask0"]], s0),
            "keypoints1_orig": image_utils.keypoints_to_original(
                out["keypoints1"][out["mask1"]], s1),
            "mkeypoints0_orig": image_utils.keypoints_to_original(
                out["mkeypoints0"][inl], s0),
            "mkeypoints1_orig": image_utils.keypoints_to_original(
                out["mkeypoints1"][inl], s1),
            "mconf": out["matching_scores0"][inl],
            "M": out["M"],
            "num_inliers": int(out["num_inliers"]),
        }

    def close(self):
        self._batcher.close()
