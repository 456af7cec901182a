"""Dense matching pipeline. Counterpart of
``imcui_tpu/pipeline/match_dense.py``: ``confs``, ``match_images(model,
image0, image1, conf)`` for the programmatic and UI path (point outputs,
line outputs copied through), the dense → sparse keypoint assignment
helpers, and the batch ``match_and_assign`` / ``main`` over a pairs file:
each image's correspondences are quantised to cells, each cell refined to
its best bin and the image's keypoints capped at ``max_kps`` by
accumulated score, then written as a feature file and a match file
(through ``utils/h5lite``). The bookkeeping is the JAX module's, in numpy
on the host, so ties order the same.
"""

import pprint
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import logger
from ..configs import confs_dict
from ..models import matchers
from ..utils import h5lite
from ..utils import image as image_utils
from ..utils.base_model import dynamic_load
from ..utils.io import names_to_pair
from ..utils.parsers_compat import parse_pairs_file
from .match_features import find_unique_new_pairs

confs = {
    name: conf for name, conf in confs_dict["matchers"].items()
    if "max_error" in conf or "cell_size" in conf
}


def to_cpts(kpts, cell_size):
    """Quantise keypoints to cell centres."""
    if cell_size > 0:
        kpts = np.round(np.asarray(kpts) / cell_size) * cell_size
    return [tuple(cpt) for cpt in kpts]


def assign_keypoints(kpts, other_cpts, max_error, update=False,
                     ref_bins=None, scores=None, cell_size=None):
    """Assign dense keypoints to quantised bins: without ``update`` the
    nearest of ``other_cpts`` within ``max_error`` (else -1); with it, each
    keypoint's cell is looked up or appended, and ``ref_bins`` collects the
    scores per finer bin."""
    from scipy.spatial import KDTree

    if not update:
        dist, kpt_ids = KDTree(np.array(other_cpts)).query(kpts)
        kpt_ids[dist > max_error] = -1
        return kpt_ids
    ps = cell_size if cell_size is not None else max_error
    ps = max(ps, max_error)
    cpts = to_cpts(kpts, ps)
    bpts = to_cpts(kpts, int(max_error))
    kpt_ids = []
    cpts_to_ids = {tuple(cpt): i for i, cpt in enumerate(other_cpts)}
    for cpt, bpt, score in zip(cpts, bpts, scores if scores is not None
                               else [1.0] * len(cpts)):
        kid = cpts_to_ids.get(cpt)
        if kid is None:
            kid = len(other_cpts)
            cpts_to_ids[cpt] = kid
            other_cpts.append(list(cpt))
            if ref_bins is not None:
                ref_bins.append({})
        if ref_bins is not None:
            ref_bins[kid][bpt] = ref_bins[kid].get(bpt, 0) + float(score)
        kpt_ids.append(kid)
    return np.array(kpt_ids)


def _to_numpy(v):
    return v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v)


def match_images(model, image_0, image_1, conf):
    """Dense matching of one pair of (H, W[, 3]) images with a standalone
    matcher. Returns the images, keypoints*/mkeypoints* at model resolution
    and ``*_orig`` at the original resolution, and mconf."""
    pconf = image_utils.load_conf(conf)

    def prep(image):
        return image_utils.preprocess(
            np.asarray(image), grayscale=pconf.grayscale,
            resize_max=pconf.resize_max, force_resize=pconf.force_resize,
            width=pconf.width, height=pconf.height, dfactor=pconf.dfactor)

    d0, d1 = prep(image_0), prep(image_1)
    # two aspect ratios can land the views on different canvases; a dense
    # model runs both towers on one shape, so zero-pad to the union canvas
    # (the sizes carry what is valid)
    if d0["image"].shape != d1["image"].shape:
        hb = max(d0["image"].shape[2], d1["image"].shape[2])
        wb = max(d0["image"].shape[3], d1["image"].shape[3])
        for d in (d0, d1):
            _, c, hh, ww = d["image"].shape
            if (hh, ww) != (hb, wb):
                canvas = np.zeros((1, c, hb, wb), np.float32)
                canvas[:, :, :hh, :ww] = d["image"]
                d["image"] = canvas
    pred = model({
        "image0": d0["image"], "image1": d1["image"],
        "size0": d0["size"][None], "size1": d1["size"][None],
    })
    pred = {k: _to_numpy(v) for k, v in pred.items()}

    s0 = np.asarray(image_0).shape[:2][::-1] / d0["size"].astype(np.float64)
    s1 = np.asarray(image_1).shape[:2][::-1] / d1["size"].astype(np.float64)

    ret = {"image0_orig": image_0, "image1_orig": image_1}
    if "keypoints0" in pred and "keypoints1" in pred:
        kpts0, kpts1 = (pred[k][0] if pred[k].ndim == 3 else pred[k]
                        for k in ("keypoints0", "keypoints1"))
        mconf = pred.get("scores", pred.get("mconf"))
        mask = pred.get("mask")
        if mask is not None:
            m = mask[0].astype(bool)
            kpts0, kpts1 = kpts0[m], kpts1[m]
            mconf = mconf[0][m] if mconf is not None else np.ones(len(kpts0))
        elif mconf is None:
            mconf = np.ones(len(kpts0))
        elif mconf.ndim == 2:
            mconf = mconf[0]
        kpts0_origin = image_utils.keypoints_to_original(kpts0, s0)
        kpts1_origin = image_utils.keypoints_to_original(kpts1, s1)
        ret.update({
            "keypoints0": kpts0, "keypoints1": kpts1,
            "keypoints0_orig": kpts0_origin, "keypoints1_orig": kpts1_origin,
            "mkeypoints0": kpts0, "mkeypoints1": kpts1,
            "mkeypoints0_orig": kpts0_origin,
            "mkeypoints1_orig": kpts1_origin,
            "mconf": mconf,
        })
    if "lines0" in pred and "lines1" in pred:
        for key in ("lines0", "lines1", "raw_lines0", "raw_lines1",
                    "line_keypoints0", "line_keypoints1"):
            if key in pred:
                ret[key] = pred[key]
        for idx, s in (("0", s0), ("1", s1)):
            for key in (f"line_keypoints{idx}", f"lines{idx}"):
                if pred.get(key) is not None:
                    ret[f"{key}_orig"] = image_utils.keypoints_to_original(
                        pred[key], s)
    return ret


def match_and_assign(conf, pairs_path, image_dir, match_path,
                     feature_path_q, feature_paths_refs=(),
                     max_kps=8192, overwrite=False, device="cuda"):
    """Match every new pair of ``pairs_path`` densely with ``conf``'s
    model on ``device``, aggregate each image's correspondences into at
    most ``max_kps`` keypoints, and write the matches to ``match_path``
    and the keypoints (``uncertainty`` = ``max_error``) to
    ``feature_path_q``."""
    pairs = parse_pairs_file(pairs_path)
    pairs = find_unique_new_pairs(pairs, None if overwrite else match_path)
    required_queries = set(sum(([n0, n1] for n0, n1 in pairs), []))
    if len(pairs) == 0 and len(required_queries) == 0:
        logger.info("Skipping dense matching.")
        return

    Model = dynamic_load(matchers, conf["model"]["name"])
    model = Model(conf["model"], device=device)

    cell_size = conf.get("cell_size", 1)
    max_error = conf.get("max_error", 1)
    pconf = SimpleNamespace(**{
        **{"grayscale": True, "resize_max": 1024, "force_resize": False,
           "width": 640, "height": 480, "dfactor": 8},
        **conf.get("preprocessing", {}),
    })

    cpdict = {n: [] for n in required_queries}  # name -> cell centers
    bindict = {n: [] for n in required_queries}  # name -> score bins
    raw = {}

    for name0, name1 in pairs:
        img0 = image_utils.read_image(Path(image_dir) / name0,
                                      pconf.grayscale)
        img1 = image_utils.read_image(Path(image_dir) / name1,
                                      pconf.grayscale)
        ret = match_images(model, img0, img1, vars(pconf))
        kpts0 = ret["mkeypoints0_orig"]
        kpts1 = ret["mkeypoints1_orig"]
        scores = ret["mconf"]
        ids0 = assign_keypoints(kpts0, cpdict[name0], max_error,
                                update=True, ref_bins=bindict[name0],
                                scores=scores, cell_size=cell_size)
        ids1 = assign_keypoints(kpts1, cpdict[name1], max_error,
                                update=True, ref_bins=bindict[name1],
                                scores=scores, cell_size=cell_size)
        raw[(name0, name1)] = (ids0, ids1, scores)

    # finalize per-image keypoints: refine each cell to its best bin,
    # cap at max_kps by accumulated score
    final_kpts = {}
    keep_ids = {}
    for name in required_queries:
        cpts = np.array(cpdict[name], float) if cpdict[name] else \
            np.zeros((0, 2))
        scores = np.array(
            [max(b.values()) if b else 0.0 for b in bindict[name]]
        )
        kpts = np.array(
            [max(b, key=b.get) if b else tuple(c)
             for b, c in zip(bindict[name], cpts)], float,
        ) if len(cpts) else cpts
        order = np.argsort(-scores)[:max_kps]
        remap = -np.ones(len(cpts), int)
        remap[order] = np.arange(len(order))
        final_kpts[name] = kpts[order] if len(cpts) else kpts
        keep_ids[name] = remap

    with h5lite.File(match_path, "a") as fd:
        for (name0, name1), (ids0, ids1, scores) in raw.items():
            r0, r1 = keep_ids[name0], keep_ids[name1]
            m0 = np.where(ids0 >= 0, r0[np.clip(ids0, 0, None)], -1)
            m1 = np.where(ids1 >= 0, r1[np.clip(ids1, 0, None)], -1)
            valid = (m0 > -1) & (m1 > -1)
            n_kpts0 = len(final_kpts[name0])
            matches0 = -np.ones(n_kpts0, np.int32)
            sc0 = np.zeros(n_kpts0, np.float16)
            matches0[m0[valid]] = m1[valid]
            sc0[m0[valid]] = scores[valid]
            pair = names_to_pair(name0, name1)
            if pair in fd:
                del fd[pair]
            grp = fd.create_group(pair)
            grp.create_dataset("matches0", data=matches0.astype(np.int16))
            grp.create_dataset("matching_scores0", data=sc0)

    with h5lite.File(feature_path_q, "a") as fd:
        for name, kpts in final_kpts.items():
            if name in fd:
                del fd[name]
            grp = fd.create_group(name)
            grp.create_dataset("keypoints", data=kpts.astype(np.float32))
            grp.create_dataset(
                "scores",
                data=np.ones(len(kpts), np.float16),
            )
            grp["keypoints"].attrs["uncertainty"] = max_error

    logger.info("Finished dense matching.")


def main(conf, pairs, image_dir, export_dir=None, matches=None,
         features=None, features_ref=None, max_kps=8192, overwrite=False,
         device="cuda"):
    """Dense matching of a pairs file into a feature file and a match
    file (named after ``conf["output"]`` in ``export_dir`` unless given);
    returns both paths."""
    logger.info(
        "Dense matching with configuration:" f"\n{pprint.pformat(conf)}"
    )
    if features is None:
        features = "feats_" + conf["output"]
    if isinstance(features, (str,)) and export_dir is not None:
        features_q = Path(export_dir, f"{features}.h5")
        if matches is None:
            matches = Path(export_dir, f'{conf["output"]}_pairs.h5')
    else:
        features_q = Path(features)
        if matches is None:
            raise ValueError("Provide matches path with explicit features.")
    match_and_assign(conf, pairs, image_dir, Path(matches), features_q,
                     max_kps=max_kps, overwrite=overwrite, device=device)
    return Path(features_q), Path(matches)
