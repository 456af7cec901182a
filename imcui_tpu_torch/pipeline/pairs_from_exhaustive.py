"""All-against-all or query-against-reference pairs. Counterpart of
``imcui_tpu/pipeline/pairs_from_exhaustive.py``."""

from pathlib import Path

from .. import logger
from ..utils.io import list_h5_names, parse_image_list


def main(output, image_list=None, features=None, ref_list=None,
         ref_features=None):
    """Write the pairs, one ``name0 name1`` a line, to ``output`` and
    return them. Queries come from ``image_list`` (a file or names) or the
    groups of ``features``; references likewise from ``ref_list`` or
    ``ref_features``, else every query pair (i, j) with i < j."""
    if image_list is not None:
        if isinstance(image_list, (str, Path)):
            names_q = parse_image_list(image_list)
        else:
            names_q = list(image_list)
    elif features is not None:
        names_q = list_h5_names(features)
    else:
        raise ValueError("Provide either a list of images or a feature file.")

    self_matching = False
    if ref_list is not None:
        if isinstance(ref_list, (str, Path)):
            names_ref = parse_image_list(ref_list)
        else:
            names_ref = list(ref_list)
    elif ref_features is not None:
        names_ref = list_h5_names(ref_features)
    else:
        self_matching = True
        names_ref = names_q

    pairs = []
    for i, n1 in enumerate(names_q):
        for j, n2 in enumerate(names_ref):
            if self_matching and j <= i:
                continue
            pairs.append((n1, n2))

    logger.info(f"Found {len(pairs)} pairs.")
    with open(output, "w") as f:
        f.write("\n".join(" ".join(p) for p in pairs))
    return pairs
