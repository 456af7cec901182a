"""Dense matching pipeline. Counterpart of
``imcui_tpu/pipeline/match_dense.py``: ``confs``, ``match_images(model,
image0, image1, conf)`` for the programmatic and UI path (point outputs,
line outputs copied through), and the dense → sparse keypoint assignment
helpers. The batch export over pair files (``match_and_assign``, ``main``)
writes HDF5 with the h5py package, which this package does not import.
"""

import numpy as np

from ..configs import confs_dict
from ..utils import image as image_utils

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


def _needs_h5py(*_, **__):
    raise NotImplementedError(
        "the batch export over a pairs file writes HDF5 with the h5py "
        "package, which the port does not use (ROADMAP §A, the HDF5 "
        "batch pipelines); match_images serves one pair")


match_and_assign = _needs_h5py
main = _needs_h5py
