"""Pairs from global descriptors. Counterpart of
``imcui_tpu/pipeline/pairs_from_retrieval.py``: the same arguments and
pairs file; ``db_model`` takes the database names from a COLMAP model's
``images.bin``. The query × database similarity and the masked top-k run
on ``device``.
"""

from pathlib import Path

import numpy as np
import torch

from .. import logger, resolve_device
from ..models.layers import full_fp32
from ..utils import h5lite
from ..utils.io import list_h5_names, parse_image_list
from ..utils.read_write_model import read_images_binary


def get_descriptors(names, path, name2idx=None, key="global_descriptor"):
    """The ``key`` datasets of ``names`` stacked as float32 (N, D); with
    ``name2idx`` each name is read from ``path[name2idx[name]]``."""
    if name2idx is None:
        with h5lite.File(path, "r") as fd:
            desc = [fd[n][key].__array__() for n in names]
    else:
        desc = []
        for n in names:
            with h5lite.File(path[name2idx[n]], "r") as fd:
                desc.append(fd[n][key].__array__())
    return np.stack(desc, 0).astype(np.float32)


def pairs_from_score_matrix(scores, invalid, num_select, min_score=None):
    """The ``num_select`` best (i, j) of each row of ``scores`` that are
    not ``invalid`` (nor below ``min_score``), best first; ties keep the
    lower j first (a stable sort, as ``jnp.argsort``)."""
    if scores.shape != invalid.shape:
        raise ValueError(f"scores {tuple(scores.shape)} and invalid "
                         f"{tuple(invalid.shape)} differ")
    scores = torch.as_tensor(scores)
    invalid = torch.as_tensor(invalid, device=scores.device)
    if min_score is not None:
        invalid = invalid | (scores < min_score)
    scores = torch.where(invalid, -torch.inf, scores)
    topk = torch.argsort(-scores, dim=1, stable=True)[:, :num_select]
    valid = torch.gather(scores, 1, topk) > -torch.inf
    topk, valid = topk.cpu().numpy(), valid.cpu().numpy()
    return [
        (int(i), int(j))
        for i, row in enumerate(topk)
        for j, ok in zip(row, valid[i])
        if ok
    ]


def main(descriptors, output, num_matched, query_prefix=None,
         query_list=None, db_prefix=None, db_list=None, db_model=None,
         db_descriptors=None, min_score=None, device="cuda"):
    """Write the ``num_matched`` most similar database images of each
    query, one ``query db`` a line, to ``output`` and return the pairs."""
    logger.info("Extracting image pairs from a retrieval database.")
    device = resolve_device(device)

    if db_descriptors is None:
        db_descriptors = descriptors
    if isinstance(db_descriptors, (Path, str)):
        db_descriptors = [db_descriptors]
    name2db = {
        n: i for i, p in enumerate(db_descriptors)
        for n in list_h5_names(p)
    }
    db_names_h5 = list(name2db.keys())
    query_names_h5 = list_h5_names(descriptors)

    def parse_names(prefix, names, names_all):
        if prefix is not None:
            if not isinstance(prefix, (list, tuple)):
                prefix = [prefix]
            names = [n for n in names_all
                     if any(n.startswith(p) for p in prefix)]
        elif names is not None:
            if isinstance(names, (str, Path)):
                names = parse_image_list(names)
        else:
            names = names_all
        return names

    if db_model is not None:
        images = read_images_binary(Path(db_model) / "images.bin")
        db_names = [i.name for i in images.values()]
    else:
        db_names = parse_names(db_prefix, db_list, db_names_h5)
    if len(db_names) == 0:
        raise ValueError("Could not find any database image.")
    query_names = parse_names(query_prefix, query_list, query_names_h5)

    desc_db = get_descriptors(db_names, db_descriptors, name2db)
    desc_q = get_descriptors(query_names, descriptors)
    with full_fp32():
        sim = torch.matmul(torch.from_numpy(desc_q).to(device),
                           torch.from_numpy(desc_db).to(device).T)

    # avoid self-matching
    self_mask = np.array(query_names)[:, None] == np.array(db_names)[None]
    pairs = pairs_from_score_matrix(
        sim, torch.from_numpy(self_mask).to(device), num_matched,
        min_score=min_score)
    pairs = [(query_names[i], db_names[j]) for i, j in pairs]

    logger.info(f"Found {len(pairs)} pairs.")
    with open(output, "w") as f:
        f.write("\n".join(" ".join(p) for p in pairs))
    return pairs
