"""Feature extraction. Counterpart of
``imcui_tpu/pipeline/extract_features.py``: the ``confs`` registry,
``extract(model, image, conf)`` for one image, ``trim_valid``, and the
batch ``main(conf, image_dir, export_dir, ...)`` that writes one HDF5
group per image (through ``utils/h5lite``) with keypoints at the original
resolution and their ``uncertainty`` attribute.
"""

import pprint
from pathlib import Path
from types import SimpleNamespace

import numpy as np

from .. import logger
from ..configs import confs_dict
from ..models import extractors
from ..utils import h5lite
from ..utils import image as image_utils
from ..utils.base_model import dynamic_load
from ..utils.io import list_h5_names, parse_image_list

confs = confs_dict["extractors"]


def list_images(root, globs=("*.jpg", "*.png", "*.jpeg", "*.JPG", "*.PNG")):
    """Image files below ``root`` (recursively), as sorted posix paths
    relative to it, listed as the JAX package lists them."""
    paths = []
    for g in globs:
        paths += list(Path(root).glob("**/" + g))
    if len(paths) == 0:
        raise ValueError(f"Could not find any image in root: {root}.")
    paths = sorted(set(paths))
    return [p.relative_to(root).as_posix() for p in paths]


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


def main(conf, image_dir, export_dir=None, as_half=True, image_list=None,
         feature_path=None, overwrite=False, device="cuda"):
    """Extract features of every image of ``image_dir`` (or of
    ``image_list``) into ``feature_path`` (default ``export_dir /
    conf["output"].h5``) and return that path. Images already in the file
    are skipped unless ``overwrite``; the file is opened once per image,
    so an interrupted run keeps what it finished. Keypoints are stored at
    the original resolution, ``(kp + 0.5) * scale - 0.5``, float32 outputs
    as float16 when ``as_half``."""
    logger.info(
        "Extracting local features with configuration:"
        f"\n{pprint.pformat(conf)}"
    )
    image_dir = Path(image_dir)
    if image_list is None:
        names = list_images(image_dir)
    elif isinstance(image_list, (str, Path)):
        names = parse_image_list(image_list)
    else:
        names = list(image_list)

    if feature_path is None:
        feature_path = Path(export_dir, conf["output"] + ".h5")
    feature_path = Path(feature_path)
    feature_path.parent.mkdir(exist_ok=True, parents=True)
    skip_names = set(
        list_h5_names(feature_path)
        if feature_path.exists() and not overwrite
        else ()
    )
    names = [n for n in names if n not in skip_names]
    if len(names) == 0:
        logger.info("Skipping the extraction.")
        return feature_path

    Model = dynamic_load(extractors, conf["model"]["name"])
    model = Model(conf["model"], device=device)
    pconf = SimpleNamespace(
        **{**{"grayscale": False, "resize_max": None, "force_resize": False,
              "width": 640, "height": 480, "dfactor": 8,
              "interpolation": "cv2_area"},
           **conf.get("preprocessing", {})}
    )

    for name in names:
        image = image_utils.read_image(image_dir / name, pconf.grayscale)
        data = image_utils.preprocess(
            image,
            grayscale=pconf.grayscale,
            resize_max=pconf.resize_max,
            force_resize=pconf.force_resize,
            width=pconf.width,
            height=pconf.height,
            dfactor=pconf.dfactor,
            interpolation=pconf.interpolation,
        )
        pred = model({"image": data["image"], "valid_wh": data["size"][None]})
        pred = trim_valid({k: v.cpu().numpy() for k, v in pred.items()})

        # rescale keypoints to the original resolution
        scale = data["original_size"] / data["size"]
        uncertainty = 1.0
        if "keypoints" in pred:
            pred["keypoints"] = image_utils.keypoints_to_original(
                pred["keypoints"], scale
            )
            uncertainty = getattr(model, "detection_noise", 1.0) * np.mean(scale)
        if as_half:
            for k in pred:
                if pred[k].dtype == np.float32:
                    pred[k] = pred[k].astype(np.float16)

        with h5lite.File(feature_path, "a") as fd:
            if name in fd:
                del fd[name]
            grp = fd.create_group(name)
            for k, v in pred.items():
                grp.create_dataset(k, data=v)
            if "keypoints" in pred:
                grp["keypoints"].attrs["uncertainty"] = uncertainty

    logger.info("Finished exporting features.")
    return feature_path
