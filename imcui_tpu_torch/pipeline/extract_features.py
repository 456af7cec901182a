"""Feature extraction for the single-image path. Counterpart of
``imcui_tpu/pipeline/extract_features.py``: the ``confs`` registry,
``extract(model, image, conf)`` and ``trim_valid``. The batch ``main``
that writes HDF5 is not ported (it needs h5py).
"""

import numpy as np

from ..configs import confs_dict
from ..utils import image as image_utils

confs = confs_dict["extractors"]


def extract(model, image_0, conf):
    """Preprocess one image as ``conf`` says and run ``model`` on it.
    Returns the model's outputs as numpy arrays plus image, image_orig,
    image_size, original_size and size."""
    pconf = image_utils.load_conf(conf)
    data = image_utils.preprocess(
        image_0,
        grayscale=pconf.grayscale,
        resize_max=pconf.resize_max,
        force_resize=pconf.force_resize,
        width=pconf.width,
        height=pconf.height,
        dfactor=pconf.dfactor,
        interpolation=pconf.interpolation,
    )
    pred = model({
        "image": data["image"],
        "valid_wh": data["size"][None],
    })
    pred = {k: v.cpu().numpy() for k, v in pred.items()}
    pred["image_size"] = data["original_size"]
    pred.update(
        {
            "image": data["image"],
            "image_orig": image_0,
            "original_size": data["original_size"],
            "size": data["size"],
        }
    )
    return pred


def trim_valid(pred):
    """Drop padded keypoint slots (host-side, at the serialisation
    boundary only). Global/retrieval outputs have no keypoint slots and
    pass through unchanged."""
    if "keypoints" not in pred:
        return {k: np.asarray(v[0]) for k, v in pred.items()
                if k in ("global_descriptor", "local_descriptor")}
    mask = np.asarray(pred["mask"][0]).astype(bool)
    out = {
        "keypoints": np.asarray(pred["keypoints"][0])[mask],
        "scores": np.asarray(pred["scores"][0])[mask],
    }
    if "descriptors" in pred:
        out["descriptors"] = np.asarray(pred["descriptors"][0])[:, mask]
    for k in ("scales", "oris"):
        if k in pred:
            out[k] = np.asarray(pred[k][0])[mask]
    return out
