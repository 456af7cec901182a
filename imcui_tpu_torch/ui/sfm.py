"""The WebUI's SfM engine. Counterpart of ``imcui_tpu/ui/sfm.py:1-133``:
``call`` runs the same stages (the images copied into a temporary
directory; exhaustive pairs, or pairs by retrieval on ``global_feature``
at ``top_k``; SuperPoint at ``max_keypoints`` and ``keypoint_threshold``,
``resize_max`` 1600, bfloat16 by default; mutual nearest-neighbour
matches; then ``reconstruction.main``) with every device stage on
``device``, and returns the same dicts. Without ``pycolmap`` the mapper
stops after verification and ``call`` returns ``status: "database-only
(mapper backend unavailable)"``, as the JAX engine does.

Deviation: the temporary copy of the images is removed when ``call``
returns (the JAX engine leaves it behind); nothing that ``call`` returns
points into it.
"""

import shutil
import tempfile
from pathlib import Path

from .. import logger, resolve_device
from ..pipeline import (extract_features, match_features,
                        pairs_from_exhaustive, pairs_from_retrieval,
                        reconstruction)


class SfmEngine:
    def __init__(self, cfg=None, device="cuda"):
        self.cfg = cfg or {}
        self.device = resolve_device(device)
        if "outputs" in self.cfg and Path(self.cfg["outputs"]).exists():
            self.outputs = Path(self.cfg["outputs"])
        else:
            self.outputs = tempfile.mkdtemp()

    def call(
        self,
        key,
        images,
        camera_model="PINHOLE",
        camera_params=None,
        max_keypoints=4096,
        keypoint_threshold=0.005,
        match_threshold=0.2,
        ransac_threshold=8,
        ransac_confidence=0.9999,
        ransac_max_iter=10000,
        scene_graph="all",
        global_feature="netvlad",
        top_k=10,
        mapper_refine_focal_length=False,
        mapper_refine_principle_points=False,
        mapper_refine_extra_params=False,
    ):
        """Reconstruct the image files ``images`` under ``outputs``: the
        feature, match and pairs files, then ``sfm/database.db`` and, with
        pycolmap, the model. The camera, match and RANSAC arguments are
        taken and unused, as in the JAX engine."""
        outputs = Path(self.outputs)
        outputs.mkdir(parents=True, exist_ok=True)
        temp_images = Path(tempfile.mkdtemp())
        try:
            for image in images:
                shutil.copy(str(image), str(temp_images))
            return self._run(
                outputs, temp_images, max_keypoints, keypoint_threshold,
                scene_graph, global_feature, top_k,
                {"ba_refine_focal_length": mapper_refine_focal_length,
                 "ba_refine_principal_point": mapper_refine_principle_points,
                 "ba_refine_extra_params": mapper_refine_extra_params})
        finally:
            shutil.rmtree(temp_images, ignore_errors=True)

    def _run(self, outputs, temp_images, max_keypoints, keypoint_threshold,
             scene_graph, global_feature, top_k, mapper_options):
        dev = self.device
        sfm_dir = outputs / "sfm"
        feature_dir = outputs / "features"
        feature_dir.mkdir(parents=True, exist_ok=True)
        sfm_pairs = outputs / "pairs-sfm.txt"

        feature_conf = {
            "output": "feats-superpoint",
            "model": {
                "name": "superpoint",
                "max_keypoints": max_keypoints,
                "keypoint_threshold": keypoint_threshold,
            },
            "preprocessing": {"grayscale": True, "resize_max": 1600,
                              "dfactor": 8},
        }
        match_conf = {
            "output": "matches-NN-mutual",
            "model": {"name": "nearest_neighbor", "do_mutual_check": True},
        }

        if scene_graph == "all" or global_feature is None:
            feature_path = extract_features.main(
                feature_conf, temp_images, feature_dir, device=dev
            )
            pairs_from_exhaustive.main(sfm_pairs, features=feature_path)
        else:
            retrieval_conf = extract_features.confs[global_feature]
            retrieval_path = extract_features.main(
                retrieval_conf, temp_images, feature_dir, device=dev
            )
            pairs_from_retrieval.main(
                retrieval_path, sfm_pairs, num_matched=top_k, device=dev
            )
            feature_path = extract_features.main(
                feature_conf, temp_images, feature_dir, device=dev
            )

        match_path = match_features.main(
            match_conf, sfm_pairs, features=feature_path,
            matches=feature_dir / "matches.h5", device=dev,
        )

        try:
            model = reconstruction.main(
                sfm_dir, temp_images, sfm_pairs, feature_path, match_path,
                mapper_options=mapper_options, device=dev,
            )
        except ImportError as e:
            logger.warning(str(e))
            return {
                "sfm_dir": str(sfm_dir),
                "database": str(sfm_dir / "database.db"),
                "status": "database-only (mapper backend unavailable)",
            }

        # a point cloud .obj for the Model3D widget
        if model is not None:
            obj_path = sfm_dir / "points3D.obj"
            try:
                with open(obj_path, "w") as f:
                    for pid, p in model.points3D.items():
                        x, y, z = p.xyz
                        r, g, b = p.color / 255.0
                        f.write(f"v {x} {y} {z} {r} {g} {b}\n")
            except Exception as e:  # pragma: no cover
                logger.warning(f"obj export failed: {e}")
            return {
                "sfm_dir": str(sfm_dir),
                "obj": str(obj_path),
                "status": "ok",
            }
        return {"sfm_dir": str(sfm_dir), "status": "failed"}

    def call_empty(self, *args, **kwargs):
        """The tab's handler while it has no inputs: logs and returns
        None."""
        logger.info("SfM engine invoked without inputs.")
        return None
