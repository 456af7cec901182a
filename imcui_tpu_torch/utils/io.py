"""Feature and match files, pair files and image lists. Counterpart of
``imcui_tpu/utils/io.py``: the same names, HDF5 layout and return values,
with the files read through this package's ``utils/h5lite`` (the port
does not use h5py).

Layout (hloc's): one group per image holding ``keypoints`` (with an
``uncertainty`` attribute), ``descriptors``, ``scores``, … and one group
per pair, named ``names_to_pair(name0, name1)``, holding ``matches0``
(int16, -1 where unmatched) and ``matching_scores0`` (float16).
"""

from pathlib import Path

import numpy as np

from . import h5lite


def list_h5_names(path):
    """The names of every group in an HDF5 file that holds a dataset, in
    set order as the JAX package returns them (not sorted)."""
    names = []
    with h5lite.File(path, "r") as fd:

        def visit_fn(_, obj):
            if isinstance(obj, h5lite.Dataset):
                names.append(obj.parent.name.strip("/"))

        fd.visititems(visit_fn)
    return list(set(names))


def get_keypoints(path, name, return_uncertainty=False):
    """One image's keypoints, and its ``uncertainty`` attribute if asked."""
    with h5lite.File(path, "r") as hfile:
        dset = hfile[name]["keypoints"]
        p = dset.__array__()
        uncertainty = dset.attrs.get("uncertainty")
    if return_uncertainty:
        return p, uncertainty
    return p


def names_to_pair(name0, name1, separator="/"):
    """The group name of a pair."""
    return separator.join((name0.replace("/", "-"), name1.replace("/", "-")))


def names_to_pair_old(name0, name1):
    return names_to_pair(name0, name1, separator="_")


def find_pair(hfile, name0, name1):
    """A pair's group under any of the four name orders files use, and
    whether it is stored reversed."""
    pair = names_to_pair(name0, name1)
    if pair in hfile:
        return pair, False
    pair = names_to_pair(name1, name0)
    if pair in hfile:
        return pair, True
    pair = names_to_pair_old(name0, name1)
    if pair in hfile:
        return pair, False
    pair = names_to_pair_old(name1, name0)
    if pair in hfile:
        return pair, True
    raise ValueError(
        f"Could not find pair {(name0, name1)}... "
        "Maybe you matched with a different list of pairs?"
    )


def get_matches(path, name0, name1):
    """A pair's matches as (N, 2) index pairs into (name0, name1) and
    their scores."""
    with h5lite.File(path, "r") as hfile:
        pair, reverse = find_pair(hfile, name0, name1)
        matches = hfile[pair]["matches0"].__array__()
        scores = hfile[pair]["matching_scores0"].__array__()
    idx = np.where(matches != -1)[0]
    matches = np.stack([idx, matches[idx]], -1)
    if reverse:
        matches = np.flip(matches, -1)
    scores = scores[idx]
    return matches, scores


def parse_retrieval(path):
    """A pairs file as {query: [references]}."""
    retrieval = {}
    with open(path) as f:
        for p in f.read().rstrip("\n").split("\n"):
            if len(p) == 0:
                continue
            q, r = p.split()
            retrieval.setdefault(q, []).append(r)
    return retrieval


def parse_image_list(path, with_intrinsics=False):
    """An image-list file: names, or (name, camera dict) pairs with
    COLMAP-style intrinsics (model, width, height, params)."""
    images = []
    with open(path) as f:
        for line in f.read().rstrip("\n").split("\n"):
            line = line.strip()
            if len(line) == 0 or line[0] == "#":
                continue
            if with_intrinsics:
                name, model, width, height, *params = line.split()
                camera = {
                    "model": model,
                    "width": int(width),
                    "height": int(height),
                    "params": np.array(params, float),
                }
                images.append((name, camera))
            else:
                images.append(line.split()[0])
    if len(images) == 0:
        raise ValueError(f"Could not find any image in the list {path}.")
    return images


def parse_image_lists(paths, with_intrinsics=False):
    """Every image list that the glob ``paths`` finds, concatenated."""
    images = []
    files = list(Path(paths.parent if isinstance(paths, Path) else ".").glob(
        paths.name if isinstance(paths, Path) else paths))
    if len(files) == 0:
        raise ValueError(f"No image lists found at {paths}")
    for lfile in files:
        images += parse_image_list(lfile, with_intrinsics=with_intrinsics)
    return images


def read_yaml(path):
    import yaml

    with open(path) as f:
        return yaml.safe_load(f)
