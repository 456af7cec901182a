"""Config registry, pure data: name → {output, model{name, …},
preprocessing{…}}. Counterpart of ``imcui_tpu/configs``."""

from .extractors import confs as extractor_confs
from .matchers import confs as matcher_confs

confs_dict = {
    "extractors": extractor_confs,
    "matchers": matcher_confs,
}
