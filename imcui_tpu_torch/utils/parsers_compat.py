"""Pairs-file parsing shared by the match pipelines. Counterpart of
``imcui_tpu/utils/parsers_compat.py``."""

from pathlib import Path


def parse_pairs_file(pairs):
    """Accept a path to a whitespace pairs file, or an iterable of
    (name0, name1)."""
    if isinstance(pairs, (str, Path)):
        path = Path(pairs)
        if not path.exists():
            raise FileNotFoundError(f"Pair file {path} does not exist.")
        out = []
        with open(path) as f:
            for line in f.read().rstrip("\n").split("\n"):
                if len(line) == 0:
                    continue
                a, b = line.split()
                out.append((a, b))
        return out
    return [tuple(p) for p in pairs]
