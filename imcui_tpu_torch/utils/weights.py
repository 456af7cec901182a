"""Weight bridge: the JAX package's flat ``save_tree_npz`` checkpoints and
parameter trees, read into this package's layout.

A checkpoint is a flat ``.npz`` whose keys are dotted paths into a nested
tree of dicts and lists (``transformers.3.self_attn.Wqkv.w``). A level
whose keys are exactly ``0..n-1`` is a list (a layer stack); any other
level is a dict (LightGlue's ``ffn`` keeps torch's Sequential indices
``0``, ``1``, ``3`` as dict keys).

Layouts. The JAX trees store conv kernels HWIO ``(kh, kw, cin, cout)``
and linear weights ``(din, dout)``. This package keeps torch's layouts:
conv kernels OIHW ``(cout, cin, kh, kw)`` for ``F.conv2d`` and linear
weights ``(dout, din)`` for ``F.linear``. Every 4-D leaf named ``w`` is a
conv kernel and every 2-D leaf named ``w`` a linear weight (including
LightGlue's ``posenc.Wr.w`` and SuperGlue's 1 × 1 Conv1d layers, which
the JAX tree already holds as linears); all other leaves keep their
shape: biases, norm statistics, PReLU gains and SuperGlue's scalar
``bin_score``. A ``None`` leaf stays ``None``.
"""

import os
from pathlib import Path

import numpy as np
import torch


def _is_list_level(keys):
    return keys and sorted(keys, key=lambda k: (len(k), k)) == [
        str(i) for i in range(len(keys))]


def tree_from_flat(flat):
    """{dotted path: array} → nested dicts/lists (see module docstring)."""
    root = {}
    for path, arr in flat.items():
        node = root
        parts = path.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = arr

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if _is_list_level(list(node)):
            return [node[str(i)] for i in range(len(node))]
        return node

    return listify(root)


def flatten_tree(tree, prefix=""):
    """Nested dicts/lists → {dotted path: leaf}. A ``None`` leaf (a
    placeholder, as DISK's absent last gate) has no entry, as in the JAX
    package's ``save_tree_npz``."""
    out = {}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    for k, v in items:
        path = f"{prefix}.{k}" if prefix else str(k)
        if isinstance(v, (dict, list)):
            out.update(flatten_tree(v, path))
        elif v is not None:
            out[path] = v
    return out


def load_tree_npz(path):
    """Read a ``save_tree_npz`` checkpoint as a nested tree of numpy arrays
    in the JAX package's layout."""
    with np.load(path) as z:
        return tree_from_flat({k: z[k] for k in z.files})


def _map_leaves(tree, fn, name=None):
    if isinstance(tree, dict):
        return {k: _map_leaves(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_leaves(v, fn, name) for v in tree]
    return None if tree is None else fn(name, tree)


def params_from_jax(tree, device="cpu"):
    """JAX-layout parameter tree (numpy arrays) → this package's tree of
    float32 torch tensors in torch layout, on ``device``."""
    def conv(name, a):
        a = np.asarray(a, np.float32)
        if name == "w" and a.ndim == 4:
            a = a.transpose(3, 2, 0, 1)
        elif name == "w" and a.ndim == 2:
            a = a.T
        return torch.tensor(a, device=device)

    return _map_leaves(tree, conv)


def params_to_jax(tree):
    """Inverse of ``params_from_jax``: torch tree → JAX-layout numpy tree."""
    def conv(name, t):
        a = t.detach().cpu().numpy()
        if name == "w" and a.ndim == 4:
            a = a.transpose(2, 3, 1, 0)
        elif name == "w" and a.ndim == 2:
            a = a.T
        return np.array(a, order="C")  # keeps a 0-d leaf 0-d

    return _map_leaves(tree, conv)


def to_device(tree, device):
    """The tree with every tensor moved to ``device``."""
    return _map_leaves(tree, lambda _, t: t.to(device))


def assert_tree_matches(tree, reference, name=""):
    """Raise unless ``tree`` has exactly the leaves and shapes of
    ``reference``."""
    got = {k: tuple(v.shape) for k, v in flatten_tree(tree).items()}
    want = {k: tuple(v.shape) for k, v in flatten_tree(reference).items()}
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    bad = sorted(k for k in set(got) & set(want) if got[k] != want[k])
    if missing or extra or bad:
        raise ValueError(
            f"weight tree mismatch for {name}: missing={missing[:5]} "
            f"extra={extra[:5]} shape={[(k, got[k], want[k]) for k in bad[:5]]}")


def seeded_init(init, device, *args):
    """``init(generator, *args)`` drawn on ``device`` by a generator seeded
    0, every factory call of the init landing there: a large tree is never
    built on the host and copied. Each device draws its own stream, so a
    card's seed-0 tree is not the CPU's."""
    device = torch.device(device)
    with device:
        return init(torch.Generator(device).manual_seed(0), *args)


def load_or_init(path, init, name, device):
    """(tree, meta): the npz tree at ``path``, converted to this package's
    layout on ``device`` and checked against ``init``'s shapes, when the
    file exists; else ``init`` itself (``path`` may be None). ``meta``
    records which, so random weights are never taken for trained ones."""
    if path is not None and Path(path).exists():
        tree = params_from_jax(load_tree_npz(path), device)
        assert_tree_matches(tree, init, name)
        return tree, {"pretrained": True, "source": str(path)}
    why = f"{path} is absent" if path is not None \
        else f"no local tree for this {name} configuration"
    return to_device(init, device), {
        "pretrained": False, "source": f"random init (seed 0): {why}"}


def local_trained_npz(name):
    """Path of a tree trained inside the repository (``weights/<name>``),
    or None. ``IMCUI_WEIGHTS_DIR`` names another directory; pointed at an
    empty or missing one it turns every such tree off. The same lookup as
    the JAX package's ``utils/weights.py::local_trained_npz``."""
    d = os.environ.get("IMCUI_WEIGHTS_DIR")
    base = Path(d) if d else Path(__file__).resolve().parents[2] / "weights"
    p = base / name
    return p if p.exists() else None


def _read_like(path, init, name, device):
    """The npz tree at ``path`` in this package's layout, checked against
    ``init`` and nested as ``init`` is: a level that ``tree_from_flat``
    would make a list (keys 0..n-1, as LoFTR's ``layer1.0``/``layer1.1``)
    stays a dict where ``init`` has one."""
    tree = params_from_jax(load_tree_npz(path), device)
    assert_tree_matches(tree, init, name)
    flat = flatten_tree(tree)

    def like(node, prefix):
        if isinstance(node, dict):
            return {k: like(v, f"{prefix}.{k}" if prefix else k)
                    for k, v in node.items()}
        if isinstance(node, list):
            return [like(v, f"{prefix}.{i}" if prefix else str(i))
                    for i, v in enumerate(node)]
        return None if node is None else flat[prefix]

    return like(init, "")


def load_trained(conf, init, name, device, local=None):
    """(tree, meta) along three routes, in order:

    1. ``conf["checkpoint_npz"]`` names a ``save_tree_npz`` tree: that
       tree (a missing file raises);
    2. ``local`` names a tree in ``weights/`` (``local_trained_npz``) that
       exists: that tree, with ``meta["source"] = "local:<path>"``;
    3. ``init`` itself, with ``meta["pretrained"] = False``.

    A tree that does not have exactly ``init``'s leaves and shapes raises
    (``assert_tree_matches``), as the JAX package's ``load_tree_npz``
    does. Nothing is downloaded: the upstream ``.ckpt`` checkpoints the
    JAX package converts after a hub download are not in the repository,
    so their conversion is not ported."""
    npz = conf.get("checkpoint_npz")
    if npz:
        return _read_like(npz, init, name, device), {
            "pretrained": True, "source": str(npz)}
    path = local_trained_npz(local) if local else None
    if path is not None:
        return _read_like(path, init, name, device), {
            "pretrained": True, "source": f"local:{path}"}
    why = (f"no {local} in the weights directory" if local
           else f"no trained {name} tree in the repository")
    return to_device(init, device), {
        "pretrained": False, "source": f"random init (seed 0): {why}"}
