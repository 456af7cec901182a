"""Sparse matching. Counterpart of
``imcui_tpu/pipeline/match_features.py``: the ``confs`` registry,
``kpt_bucket``, ``pad_features``, ``scale_keypoints``,
``match_images(model, feat0, feat1)`` for one pair, and the batch
``main(conf, pairs, features, export_dir, ...)`` that matches a pairs
file over a feature file and writes one HDF5 group per pair (through
``utils/h5lite``).
"""

import pprint
from pathlib import Path

import numpy as np

from .. import logger
from ..configs import confs_dict
from ..models import matchers
from ..utils import h5lite
from ..utils.base_model import dynamic_load
from ..utils.io import names_to_pair
from ..utils.parsers_compat import parse_pairs_file

confs = confs_dict["matchers"]

# fixed shape buckets for keypoint counts
KPT_BUCKETS = (256, 512, 1024, 2048, 4096, 8192)


def kpt_bucket(n):
    for b in KPT_BUCKETS:
        if b >= n:
            return b
    return int(-(-n // 4096) * 4096)


def pad_features(kpts, scores, desc, n, scales=None, oris=None):
    """Pad dynamic-count features to n slots + mask. desc: (D, m)."""
    m = len(kpts)
    if m > n:
        raise ValueError(f"{m} keypoints do not fit {n} slots")
    out = {
        "keypoints": np.zeros((n, 2), np.float32),
        "scores": np.zeros((n,), np.float32),
        "descriptors": np.zeros((desc.shape[0], n), np.float32),
        "mask": np.zeros((n,), bool),
    }
    out["keypoints"][:m] = kpts
    out["scores"][:m] = scores
    out["descriptors"][:, :m] = desc
    out["mask"][:m] = True
    if scales is not None:
        out["scales"] = np.zeros((n,), np.float32)
        out["scales"][:m] = scales
    if oris is not None:
        out["oris"] = np.zeros((n,), np.float32)
        out["oris"][:m] = oris
    return out


def find_unique_new_pairs(pairs_all, match_path=None):
    """The pairs without their mirror images, and without those already
    in ``match_path`` under any of the four name orders."""
    pairs = set()
    for i, j in pairs_all:
        if (j, i) not in pairs:
            pairs.add((i, j))
    pairs = list(pairs)
    if match_path is not None and match_path.exists():
        with h5lite.File(match_path, "r") as fd:
            pairs_filtered = []
            for i, j in pairs:
                if (
                    names_to_pair(i, j) in fd
                    or names_to_pair(j, i) in fd
                    or names_to_pair(i, j, "_") in fd
                    or names_to_pair(j, i, "_") in fd
                ):
                    continue
                pairs_filtered.append((i, j))
        return pairs_filtered
    return pairs


def _read_features(fd, name, n_slots):
    """One image's features from an open feature file, padded to
    ``n_slots``, and its keypoint count."""
    grp = fd[name]
    kpts = grp["keypoints"].__array__().astype(np.float32)
    scores = grp["scores"].__array__().astype(np.float32) if "scores" in grp \
        else np.ones(len(kpts), np.float32)
    desc = grp["descriptors"].__array__().astype(np.float32)
    scales = grp["scales"].__array__().astype(np.float32) if "scales" in grp \
        else None
    oris = grp["oris"].__array__().astype(np.float32) if "oris" in grp \
        else None
    return pad_features(kpts[:n_slots], scores[:n_slots], desc[:, :n_slots],
                        n_slots, scales=scales, oris=oris), len(kpts)


def match_from_paths(conf, pairs, match_path, feature_path_q,
                     feature_path_r, device="cuda"):
    """Match ``pairs`` (query name, reference name) with ``conf``'s model
    on ``device`` and write each pair's ``matches0`` (int16) and
    ``matching_scores0`` (float16) to ``match_path``."""
    if not feature_path_q.exists():
        raise FileNotFoundError(f"Query feature file {feature_path_q}.")
    if not feature_path_r.exists():
        raise FileNotFoundError(f"Reference feature file {feature_path_r}.")
    match_path.parent.mkdir(exist_ok=True, parents=True)

    Model = dynamic_load(matchers, conf["model"]["name"])
    model = Model(conf["model"], device=device)

    # one bucket for the whole run: every pair runs on the same shapes
    with h5lite.File(feature_path_q, "r") as fq:
        max_n = max(len(fq[n]["keypoints"]) for n, _ in pairs) if pairs else 0
    with h5lite.File(feature_path_r, "r") as fr:
        max_n = max(
            [max_n] + [len(fr[n]["keypoints"]) for _, n in pairs]
        ) if pairs else max_n
    n_slots = kpt_bucket(max(max_n, 1))

    for name0, name1 in pairs:
        with h5lite.File(feature_path_q, "r") as fq, \
                h5lite.File(feature_path_r, "r") as fr:
            feat0, n0 = _read_features(fq, name0, n_slots)
            feat1, n1 = _read_features(fr, name1, n_slots)
        data = {
            "keypoints0": feat0["keypoints"][None],
            "scores0": feat0["scores"][None],
            "descriptors0": feat0["descriptors"][None],
            "mask0": feat0["mask"][None],
            "keypoints1": feat1["keypoints"][None],
            "scores1": feat1["scores"][None],
            "descriptors1": feat1["descriptors"][None],
            "mask1": feat1["mask"][None],
        }
        pred = model(data)
        matches = pred["matches0"][0].cpu().numpy()[:n0]
        scores = pred["matching_scores0"][0].cpu().numpy()[:n0]
        # indices ≥ n1 are padding artefacts; mark unmatched
        matches = np.where(matches < n1, matches, -1)
        pair = names_to_pair(name0, name1)
        with h5lite.File(match_path, "a") as fd:
            if pair in fd:
                del fd[pair]
            grp = fd.create_group(pair)
            grp.create_dataset("matches0", data=matches.astype(np.int16))
            grp.create_dataset(
                "matching_scores0", data=scores.astype(np.float16)
            )
    logger.info("Finished exporting matches.")


def main(conf, pairs, features, export_dir=None, matches=None,
         features_ref=None, overwrite=False, device="cuda"):
    """Match the pairs of ``pairs`` (a file or (name0, name1) tuples) over
    ``features`` (a file, or a feature name in ``export_dir``) and return
    the match file's path. Pairs already in the file are skipped unless
    ``overwrite``; the file is opened once per pair."""
    logger.info(
        "Matching local features with configuration:"
        f"\n{pprint.pformat(conf)}"
    )
    if isinstance(features, Path) or Path(features).exists():
        features_q = Path(features)
        if matches is None:
            raise ValueError(
                "Either provide both features and matches as Path or both "
                "as names."
            )
    else:
        if export_dir is None:
            raise ValueError(
                "Provide an export_dir if features is not a file path:"
                f" {features}."
            )
        features_q = Path(export_dir, f"{features}.h5")
        if matches is None:
            matches = Path(export_dir, f'{features}_{conf["output"]}_pairs.h5')
    if features_ref is None:
        features_ref = features_q

    pairs_all = parse_pairs_file(pairs)
    pairs_todo = find_unique_new_pairs(
        pairs_all, None if overwrite else Path(matches)
    )
    if len(pairs_todo) == 0:
        logger.info("Skipping the matching.")
        return Path(matches)
    match_from_paths(conf, pairs_todo, Path(matches), features_q,
                     Path(features_ref), device=device)
    return Path(matches)


def scale_keypoints(kpts, scale):
    """Keypoints (n, 2) times a per-axis scale (2,); a copy."""
    kpts = np.array(kpts, copy=True)
    scale = np.asarray(scale)
    if scale.size == 2 and np.any(scale != 1.0):
        kpts[:, 0] *= scale[0]
        kpts[:, 1] *= scale[1]
    return kpts


def match_images(model, feat0, feat1):
    """Match two ``extract`` results with ``model``. Returns the valid
    keypoints and the raw matches at model and original resolution
    (keypoints*, keypoints*_orig, mkeypoints*, mkeypoints*_orig, mconf)."""
    data = {
        "image0": feat0.get("image"),
        "keypoints0": np.asarray(feat0["keypoints"]),
        "scores0": np.asarray(feat0["scores"]),
        "descriptors0": np.asarray(feat0["descriptors"]),
        "image1": feat1.get("image"),
        "keypoints1": np.asarray(feat1["keypoints"]),
        "scores1": np.asarray(feat1["scores"]),
        "descriptors1": np.asarray(feat1["descriptors"]),
    }
    for k in ("mask", "scales", "oris"):
        if k in feat0:
            data[k + "0"] = np.asarray(feat0[k])
        if k in feat1:
            data[k + "1"] = np.asarray(feat1[k])
    pred = {k: v.cpu().numpy() for k, v in model(data).items()}

    kpts0 = np.asarray(feat0["keypoints"][0])
    kpts1 = np.asarray(feat1["keypoints"][0])
    matches = pred["matches0"][0]
    confid = pred["matching_scores0"][0]
    mask0 = np.asarray(feat0.get("mask", np.ones((1, len(kpts0)), bool))[0])

    valid = (matches > -1) & mask0
    mkpts0 = kpts0[valid]
    mkpts1 = kpts1[matches[valid]]
    mconfid = confid[valid]

    s0 = np.asarray(feat0["original_size"]) / np.asarray(feat0["size"])
    s1 = np.asarray(feat1["original_size"]) / np.asarray(feat1["size"])
    kpts0_origin = scale_keypoints(kpts0 + 0.5, s0) - 0.5
    kpts1_origin = scale_keypoints(kpts1 + 0.5, s1) - 0.5
    mkpts0_origin = scale_keypoints(mkpts0 + 0.5, s0) - 0.5
    mkpts1_origin = scale_keypoints(mkpts1 + 0.5, s1) - 0.5

    # report only valid keypoints upstream (padding stays internal)
    k0 = kpts0[mask0]
    mask1 = np.asarray(feat1.get("mask", np.ones((1, len(kpts1)), bool))[0])
    k1 = kpts1[mask1]
    return {
        "image0_orig": feat0.get("image_orig"),
        "image1_orig": feat1.get("image_orig"),
        "keypoints0": k0,
        "keypoints1": k1,
        "keypoints0_orig": kpts0_origin[mask0],
        "keypoints1_orig": kpts1_origin[mask1],
        "mkeypoints0": mkpts0,
        "mkeypoints1": mkpts1,
        "mkeypoints0_orig": mkpts0_origin,
        "mkeypoints1_orig": mkpts1_origin,
        "mconf": mconfid,
    }
