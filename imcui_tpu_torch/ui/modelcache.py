"""Model cache of ``run_matching``. Counterpart of
``imcui_tpu/ui/modelcache.py``: ``ARCSizeAwareModelCache`` with the same
``load_model(key, loader, conf)`` API, eviction rules and log lines,
``_conf_key`` and ``get_global_cache``. The JAX module's
``LRUModelCache`` has no caller there and is not ported.

One deviation: where ``load_model`` must evict to fit while T1 holds no
more than its target ``p`` entries and T2 is empty, the JAX package's
``_replace`` evicts nothing and its loop never ends (a budget of bytes
that the models in T1 exceed after ghost hits have raised ``p``); this
cache evicts T1's oldest entry there. Everywhere else the two evict
alike.

A model's size is what its weights hold on their device: ``tree_nbytes``
walks ``model.params`` (dicts, lists and tuples of tensors and numpy
arrays), or, for a model that keeps its weights as ``nn.Module``
parameters and buffers instead, those. Eviction drops the cache's
reference and lets PyTorch free the memory.
"""

import threading
from collections import OrderedDict

import numpy as np
import torch

from .. import logger


def tree_nbytes(tree):
    """Bytes held by the tensors and numpy arrays in a nested tree."""
    if isinstance(tree, dict):
        return sum(tree_nbytes(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return sum(tree_nbytes(v) for v in tree)
    if isinstance(tree, torch.Tensor):
        return tree.numel() * tree.element_size()
    if isinstance(tree, np.ndarray):
        return tree.nbytes
    return 0


def model_nbytes(model):
    """``tree_nbytes`` of ``model.params``, else of the module's
    parameters and buffers."""
    params = getattr(model, "params", None)
    if params is None and isinstance(model, torch.nn.Module):
        params = [*model.parameters(), *model.buffers()]
    return tree_nbytes(params)


class ARCSizeAwareModelCache:
    """Adaptive replacement cache: recency (T1) against frequency (T2)
    with ghost lists (B1, B2), evicting until count and bytes fit."""

    def __init__(self, max_bytes=8 << 30, max_models=6):
        self.max_bytes = max_bytes
        self.max_models = max_models
        self._lock = threading.Lock()
        self.t1 = OrderedDict()  # recently used once: key -> (model, nbytes)
        self.t2 = OrderedDict()  # frequently used
        self.b1 = OrderedDict()  # ghost of t1 (keys only)
        self.b2 = OrderedDict()  # ghost of t2
        self.p = 0  # adaptation parameter (target size of t1, in entries)

    def _total_bytes(self):
        return sum(n for _, n in self.t1.values()) + sum(
            n for _, n in self.t2.values()
        )

    def _total_models(self):
        return len(self.t1) + len(self.t2)

    def _replace(self, in_b2, fit=False):
        """Evict one entry into its ghost list. ``fit`` (the loop that makes
        the cache fit) also takes T1's oldest when T1 is within its target
        and T2 is empty, where the JAX package evicts nothing and its loop
        never ends."""
        if self.t1 and (
            len(self.t1) > self.p or (in_b2 and len(self.t1) == self.p)
            or (fit and not self.t2)
        ):
            key, (model, n) = self.t1.popitem(last=False)
            self.b1[key] = None
            logger.info(f"ARC evict from T1: {key} ({n / 1e6:.1f} MB)")
        elif self.t2:
            key, (model, n) = self.t2.popitem(last=False)
            self.b2[key] = None
            logger.info(f"ARC evict from T2: {key} ({n / 1e6:.1f} MB)")
        # trim ghosts
        while len(self.b1) > self.max_models:
            self.b1.popitem(last=False)
        while len(self.b2) > self.max_models:
            self.b2.popitem(last=False)

    def load_model(self, key, loader, conf):
        ckey = (key, _conf_key(conf))
        with self._lock:
            if ckey in self.t1:
                model, n = self.t1.pop(ckey)
                self.t2[ckey] = (model, n)
                return model
            if ckey in self.t2:
                self.t2.move_to_end(ckey)
                return self.t2[ckey][0]

        model = loader(conf)
        nbytes = model_nbytes(model)

        with self._lock:
            if ckey in self.b1:
                self.p = min(self.max_models,
                             self.p + max(1, len(self.b2) // max(len(self.b1), 1)))
                del self.b1[ckey]
                self._replace(False)
                self.t2[ckey] = (model, nbytes)
            elif ckey in self.b2:
                self.p = max(0,
                             self.p - max(1, len(self.b1) // max(len(self.b2), 1)))
                del self.b2[ckey]
                self._replace(True)
                self.t2[ckey] = (model, nbytes)
            else:
                self.t1[ckey] = (model, nbytes)
            while (
                self._total_models() > self.max_models
                or self._total_bytes() > self.max_bytes
            ) and self._total_models() > 1:
                self._replace(False, fit=True)
        return model

    def clear(self):
        with self._lock:
            self.t1.clear()
            self.t2.clear()
            self.b1.clear()
            self.b2.clear()
            self.p = 0


def _conf_key(conf):
    """Hashable digest of a (nested) conf dict."""
    if isinstance(conf, dict):
        return tuple(sorted((k, _conf_key(v)) for k, v in conf.items()))
    if isinstance(conf, (list, tuple)):
        return tuple(_conf_key(v) for v in conf)
    return conf


_GLOBAL_CACHE = None


def get_global_cache():
    global _GLOBAL_CACHE
    if _GLOBAL_CACHE is None:
        _GLOBAL_CACHE = ARCSizeAwareModelCache()
    return _GLOBAL_CACHE
