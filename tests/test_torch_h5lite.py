"""The port's HDF5 layer (``imcui_tpu_torch/utils/h5lite.py``) against
h5py on the CPU: h5py reads what h5lite writes, h5lite reads what h5py
writes with ``libver="latest"`` (the JAX package's files), at 3, 50 and
2000 groups (the fractal heap's indirect blocks and the B-tree's internal
nodes), appends in both directions, checksums and the named refusals.

Tolerances: none; every value read back is compared for equality, with
its dtype.
"""

import os
import struct

import h5py
import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from imcui_tpu_torch.utils import h5lite

DTYPES = ("f2", "f4", "f8", "i1", "i2", "i4", "i8", "u1", "u2", "u4", "u8")


def _item(i, dtype="f4"):
    """One image's group as the pipelines write it."""
    return {"keypoints": np.full((i % 7, 2), i, dtype),
            "descriptors": (np.arange(6).reshape(3, 2) + i % 97).astype("f2"),
            "scores": np.arange(i % 5, dtype="f2")}


def _write(f, i):
    grp = f.create_group(f"img_{i:05d}.png")
    for k, v in _item(i).items():
        grp.create_dataset(k, data=v)
    grp["keypoints"].attrs["uncertainty"] = np.float64(i) / 3


def _check(f, i):
    grp = f[f"img_{i:05d}.png"]
    for k, v in _item(i).items():
        got = np.asarray(grp[k])
        assert got.dtype == v.dtype and got.shape == v.shape, (i, k)
        np.testing.assert_array_equal(got, v)
    u = grp["keypoints"].attrs["uncertainty"]
    assert u == i / 3 and np.asarray(u).dtype == np.float64


def _h5py_file(path, n):
    with h5py.File(path, "w", libver="latest") as f:
        for i in range(n):
            _write(f, i)


def test_lookup3_matches_the_reference_values():
    # the values Bob Jenkins' lookup3.c prints for "" and the sentence
    assert h5lite.lookup3(b"") == 0xDEADBEEF
    assert h5lite.lookup3(b"Four score and seven years ago") == 0x17770551
    assert h5lite.lookup3(b"Four score and seven years ago", 1) == 0xCD628161


def test_h5py_reads_what_h5lite_writes(tmp_path):
    """Nested names, every dtype (scalar, 1-D, 2-D, zero rows), scalar
    and array attributes with h5py's dtypes for Python values."""
    path = tmp_path / "lite.h5"
    rng = np.random.default_rng(0)
    data = {}
    with h5lite.File(path, "w") as f:
        for j, dt in enumerate(DTYPES):
            shape = [(), (5,), (3, 4), (0, 2)][j % 4]
            v = (rng.normal(size=shape) * 50).astype(dt)
            data[f"a/b{j}/c.png/x"] = v
            f.create_dataset(f"a/b{j}/c.png/x", data=v)
        ds = f.create_group("top").create_dataset("k", data=np.zeros((0, 2)))
        ds.attrs["uncertainty"] = np.mean(np.array([1.5, 2.0]))
        ds.attrs["max_error"] = 2
        ds.attrs["vec"] = np.arange(3, dtype=np.float32)
        f["a"].attrs["flag"] = np.uint8(7)
    with h5py.File(path, "r") as f:
        for name, v in data.items():
            assert f[name].dtype == v.dtype and f[name].shape == v.shape
            np.testing.assert_array_equal(f[name][()], v)
        attrs = f["top/k"].attrs
        assert attrs["uncertainty"] == 1.75
        assert attrs["uncertainty"].dtype == np.float64
        assert attrs["max_error"] == 2 and attrs["max_error"].dtype == np.int64
        np.testing.assert_array_equal(attrs["vec"], np.arange(3))
        assert attrs["vec"].dtype == np.float32
        assert f["a"].attrs["flag"] == 7
        assert f["top/k"].shape == (0, 2)
        seen = []
        f.visititems(lambda n, o: seen.append(n))
    got = []
    with h5lite.File(path) as f:
        f.visititems(lambda n, o: got.append(n))
    assert got == seen


@pytest.mark.parametrize("n", [3, 50, 2000])
def test_h5lite_reads_what_h5py_writes(tmp_path, n):
    """h5py's libver="latest" file: compact links at 3 groups; at 50 the
    fractal heap's indirect block and a B-tree internal node; at 2000
    several internal nodes below the root."""
    path = tmp_path / "h5py.h5"
    _h5py_file(path, n)
    raw = path.read_bytes()
    if n >= 50:
        assert b"FHIB" in raw and b"BTIN" in raw
    if n == 2000:
        assert raw.count(b"BTIN") >= 3
    with h5lite.File(path) as f:
        assert len(f) == n and f.keys() == sorted(f"img_{i:05d}.png"
                                                  for i in range(n))
        for i in range(n):
            _check(f, i)
        assert f"img_{n - 1:05d}.png/keypoints" in f
        assert "img_x.png" not in f and "img_00000.png/nope" not in f


@pytest.mark.parametrize("n", [3, 50, 2000])
def test_appends_in_both_directions(tmp_path, n):
    """h5lite appends to (and deletes from) h5py's dense file, h5py reads
    it, h5py appends again, h5lite reads all of it."""
    path = tmp_path / "mixed.h5"
    _h5py_file(path, n)
    for i in range(n, n + 3):                 # one open per item
        with h5lite.File(path, "a") as f:
            _write(f, i)
    with h5lite.File(path, "a") as f:
        del f["img_00001.png"]
        del f[f"img_{n:05d}.png"]
        _write(f, n)                          # deleted and written again
    with h5py.File(path, "a", libver="latest") as f:
        assert len(f) == n + 2 and "img_00001.png" not in f
        for i in (0, n - 1, n, n + 2):
            _check(f, i)
        for i in range(n + 3, n + 6):
            _write(f, i)
        del f["img_00002.png"]
    with h5lite.File(path) as f:
        assert len(f) == n + 4
        for i in [0] + list(range(3, n + 6)):
            _check(f, i)
    with h5lite.File(path, "a") as f:         # h5py's form once more
        _write(f, n + 6)
    with h5py.File(path, "r") as f:
        assert len(f) == n + 5
        _check(f, n + 6)


def test_an_append_writes_only_the_new_item(tmp_path):
    """Appending one group to a 2000-group file writes its datasets and
    headers once, plus a few patched bytes: the file's old bytes stay
    but for the superblock and the root header's tail message."""
    path = tmp_path / "lite.h5"
    with h5lite.File(path, "w") as f:
        for i in range(2000):
            _write(f, i)
    before = path.read_bytes()
    with h5lite.File(path, "a") as f:
        _write(f, 2000)
    after = path.read_bytes()
    changed = np.flatnonzero(np.frombuffer(before, np.uint8)
                             != np.frombuffer(after[:len(before)], np.uint8))
    assert len(changed) <= 48, len(changed)
    assert len(after) - len(before) < 1200
    sizes = []
    for i in range(2001, 2301):               # one open per item
        with h5lite.File(path, "a") as f:
            _write(f, i)
        sizes.append(os.path.getsize(path))
    growth = np.diff(sizes)
    assert growth.max() < 32 * 2300           # a rewrite of the root
    assert growth.mean() < 1500               # linear on the whole
    with h5py.File(path, "r") as f:
        assert len(f) == 2301
        for i in (0, 1999, 2000, 2300):
            _check(f, i)


def test_paths_groups_and_errors(tmp_path):
    path = tmp_path / "p.h5"
    with h5lite.File(path, "w") as f:
        g = f.create_group("a/b")
        assert g.name == "/a/b" and g.parent.name == "/a"
        g.create_dataset("x", data=np.arange(3))
        assert "a" in f and "a/b/x" in f and "/a/b/x" in f
        assert "a/b/x/y" not in f and "a/c" not in f
        assert f["a"]["b/x"].name == "/a/b/x" and len(f["a/b/x"]) == 3
        with pytest.raises(ValueError, match="already exists"):
            f.create_group("a/b")
        with pytest.raises(KeyError):
            f["a/zz"]
        with pytest.raises(ValueError, match="dtype"):
            f.create_dataset("bool", data=np.ones(3, bool))
        del f["a/b/x"]
        assert "a/b/x" not in f
    with h5lite.File(path) as f:
        assert f.keys() == ["a"] and len(f["a/b"]) == 0
        with pytest.raises(ValueError, match="read-only"):
            f.create_group("c")
    with h5lite.File(path, "w") as f:        # truncates
        assert len(f) == 0


def test_an_interrupted_run_keeps_the_items_it_closed(tmp_path):
    path = tmp_path / "run.h5"
    for i in range(3):
        with h5lite.File(path, "a") as f:
            _write(f, i)
    with pytest.raises(RuntimeError):
        with h5lite.File(path, "a") as f:
            f.create_group("img_00003.png")
            raise RuntimeError("interrupted")
    with h5py.File(path, "r") as f:
        for i in range(3):
            _check(f, i)


@pytest.mark.parametrize("where", ["root", "heap", "btree"])
def test_a_flipped_checksum_byte_raises(tmp_path, where):
    path = tmp_path / "c.h5"
    if where == "root":
        with h5lite.File(path, "w") as f:
            _write(f, 1)
        with h5lite.File(path) as f:
            pos = f._root_addr + 12
    else:
        _h5py_file(path, 50)
        raw = path.read_bytes()
        pos = raw.index(b"FHDB" if where == "heap" else b"BTLF") + 40
    raw = bytearray(path.read_bytes())
    raw[pos] ^= 0x01
    path.write_bytes(raw)
    with pytest.raises(ValueError, match="checksum"):
        with h5lite.File(path) as f:
            f.visititems(lambda n, o: np.asarray(o)
                         if isinstance(o, h5lite.Dataset) else None)


def _must_understand_file(path):
    """An h5lite file whose root header holds a message of an unknown
    type marked "fail if not understood" (its tail NIL, retyped)."""
    with h5lite.File(path, "w") as f:
        f.create_group("g")
    with h5lite.File(path) as f:
        hdr = f._header
        _, _, ci, data, _ = hdr.msgs[-1]
    caddr, blk = hdr.chunks[ci]
    blk[data - 4], blk[data - 1] = 0x18, 0x80
    blk[-4:] = struct.pack("<I", h5lite.lookup3(blk[:-4]))
    raw = bytearray(path.read_bytes())
    raw[caddr:caddr + len(blk)] = blk
    path.write_bytes(raw)


UNSUPPORTED = {
    "chunked": (lambda f: f.create_dataset("d", data=np.ones((4, 4)),
                                           chunks=(2, 2)), "chunked"),
    "filtered": (lambda f: f.create_dataset("d", data=np.ones((4, 4)),
                                            compression="gzip"), "filtered"),
    "dense_attributes": (lambda f: [f.require_dataset(
        "d", (2,), "f8").attrs.__setitem__(f"a{i}", i)
        for i in range(12)], "dense attribute"),
    "string": (lambda f: f.create_dataset("d", data=np.array(
        [b"ab", b"cd"])), "string"),
    "enum": (lambda f: f.create_dataset("d", data=np.ones(3, bool)), "enum"),
    "compound": (lambda f: f.create_dataset("d", data=np.zeros(
        2, [("a", "f4"), ("b", "i4")])), "compound"),
    "big_endian": (lambda f: f.create_dataset("d", data=np.ones(
        3, ">f4")), "big-endian"),
    "string_attribute": (lambda f: f.create_group("g").attrs.__setitem__(
        "s", "text"), "string"),
    "soft_link": (lambda f: (f.create_group("g"), f.__setitem__(
        "s", h5py.SoftLink("/g"))), "soft link"),
    "external_link": (lambda f: f.__setitem__(
        "e", h5py.ExternalLink("other.h5", "/g")), "external link"),
}


@pytest.mark.parametrize("what", sorted(UNSUPPORTED) + [
    "superblock_0", "must_understand"])
def test_unsupported_features_raise_their_named_error(tmp_path, what):
    path = tmp_path / "u.h5"
    if what == "superblock_0":
        with h5py.File(path, "w") as f:      # h5py's default libver
            f.create_group("g")
        match = "superblock version 0"
    elif what == "must_understand":
        _must_understand_file(path)
        match = "must be understood"
    else:
        make, match = UNSUPPORTED[what]
        with h5py.File(path, "w", libver="latest") as f:
            make(f)
    with pytest.raises(ValueError, match=match):
        with h5lite.File(path) as f:
            f.visititems(lambda n, o: np.asarray(o)
                         if isinstance(o, h5lite.Dataset) else None)


_NAMES = st.text("abcxyz019._-", min_size=1, max_size=6).filter(
    lambda s: s not in (".", ".."))
_LEAF = st.tuples(st.sampled_from(DTYPES),
                  st.lists(st.integers(0, 3), max_size=2))
_TREE = st.dictionaries(
    st.lists(_NAMES, min_size=1, max_size=3).map("/".join), _LEAF,
    min_size=1, max_size=6)


def _leaves(tree):
    """Drop paths that are a prefix of another (a dataset cannot hold a
    group) and make each leaf's array from its spec."""
    keys = sorted(tree)
    out = {}
    for k in keys:
        if any(o.startswith(k + "/") for o in keys):
            continue
        dt, shape = tree[k]
        n = int(np.prod(shape, dtype=np.int64))
        out[k] = (np.arange(n) * 7 % 251).astype(dt).reshape(shape)
    return out


@settings(max_examples=25, deadline=None,
          suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(tree=_TREE, writer_first=st.booleans())
def test_random_trees_round_trip(tmp_path, tree, writer_first):
    """A random tree written by one library, appended to by the other,
    read back by both."""
    leaves = _leaves(tree)
    half = sorted(leaves)[:len(leaves) // 2]
    path = tmp_path / "r.h5"
    if path.exists():
        path.unlink()
    libs = [h5lite.File, lambda p, m: h5py.File(p, m, libver="latest")]
    if not writer_first:
        libs.reverse()
    with libs[0](path, "w") as f:
        for k in half:
            f.create_dataset(k, data=leaves[k])
    with libs[1](path, "a") as f:
        for k in sorted(set(leaves) - set(half)):
            f.create_dataset(k, data=leaves[k])
    for read in (h5lite.File, h5py.File):
        with read(path, "r") as f:
            for k, v in leaves.items():
                got = np.asarray(f[k])
                assert got.dtype == v.dtype and got.shape == v.shape, k
                np.testing.assert_array_equal(got, v)
