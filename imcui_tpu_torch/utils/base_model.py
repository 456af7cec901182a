"""Model protocol and plugin discovery. Counterpart of
``imcui_tpu/utils/base_model.py``.

``Model(conf, device=...)`` merges ``default_conf`` with the user conf,
builds the model on ``device`` (``"cuda"`` raises without a card), checks
``required_inputs`` and dispatches dict of arrays in → dict of tensors
out. Parameters live in ``self.params`` (a tree of tensors on the
device); outputs are fixed-shape and mask-padded.
"""

import importlib
import inspect
from abc import ABCMeta, abstractmethod
from copy import deepcopy

from torch import nn

from .. import resolve_device


def merge_confs(default, user):
    """Recursively merge a user conf over a default conf."""
    out = deepcopy(default)
    for k, v in (user or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = merge_confs(out[k], v)
        else:
            out[k] = v
    return out


class BaseModel(nn.Module, metaclass=ABCMeta):
    """dict-in/dict-out model protocol."""

    default_conf = {}
    required_inputs = []

    def __init__(self, conf=None, device="cuda"):
        super().__init__()
        self.conf = merge_confs(self.default_conf, conf)
        self.device = resolve_device(device)
        self._init(self.conf)

    def forward(self, data):
        """Check required inputs, then dispatch to ``_forward``."""
        for key in self.required_inputs:
            if key not in data:
                raise KeyError(f"Missing key {key} in data")
        return self._forward(data)

    @abstractmethod
    def _init(self, conf):
        """Build ``self.params`` on ``self.device``."""
        raise NotImplementedError

    @abstractmethod
    def _forward(self, data):
        raise NotImplementedError


def dynamic_load(root, model):
    """Import ``<root>.<model>`` and return its unique BaseModel
    subclass."""
    module_path = f"{root.__name__}.{model}"
    try:
        module = importlib.import_module(module_path)
    except ModuleNotFoundError as e:
        if e.name != module_path:
            raise
        raise NotImplementedError(
            f"model {model!r} is not ported to {root.__name__} yet") from e
    classes = inspect.getmembers(module, inspect.isclass)
    classes = [c for c in classes if c[1].__module__ == module_path]
    classes = [c for c in classes if issubclass(c[1], BaseModel)]
    if len(classes) != 1:
        raise ImportError(f"{module_path} must define exactly one BaseModel "
                          f"subclass, found {classes}")
    return classes[0][1]
