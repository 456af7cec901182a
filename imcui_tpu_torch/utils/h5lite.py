"""The subset of HDF5 that the batch pipelines' files use, read and
written with numpy and the standard library.

The port's copy of what the JAX package does with h5py: the feature,
match and descriptor files of ``pipeline/{extract_features,
match_features,match_dense,pairs_from_*}.py``. Those files hold a tree of
groups, numeric datasets and scalar attributes; h5py writes them with
``libver="latest"``.

The subset read:

- superblock versions 2 and 3 (offsets and lengths of 8 bytes);
- version-2 object headers (``OHDR``) and their continuation blocks
  (``OCHK``);
- messages: dataspace, datatype, fill value, data layout, link info, link,
  group info, attribute info, attribute and continuation; others are
  skipped unless they are marked "must understand";
- little-endian fixed-point and IEEE floating-point datatypes (i1..i8,
  u1..u8, f2, f4, f8);
- contiguous and compact layouts; an undefined address is a dataset whose
  storage was never allocated (zero rows, or all fill value);
- scalar and simple attributes stored in the object header;
- compact links (link messages) and dense links: the fractal heap
  (``FRHP``, direct blocks ``FHDB``, indirect blocks ``FHIB`` at any
  depth) and the version-2 B-tree of link names (``BTHD``, ``BTIN``,
  ``BTLF``, record type 5);
- every Jenkins lookup3 checksum is verified.

Anything else raises a ``ValueError`` that names it: superblock 0/1 (h5py's
default ``libver``), old-style groups, chunked or filtered datasets, dense
attribute storage, string, enum, compound and the other datatype classes,
big-endian types, soft and external links.

The writer keeps every group compact: links are link messages in the
group's object header, with a group-info message that raises the compact
limit to 65535 links. A group's header ends in a 16-byte NIL message. A
later open that adds links appends one ``OCHK`` block with them at the
end of the file and turns that NIL, in place, into the continuation
message that points at it. So appending an image's group writes its
datasets and headers once, plus one small block and a few patched bytes;
nothing already in the file is rewritten. A group whose header cannot be
extended so (one that h5py wrote, a dense one, one whose chain of blocks
has grown long) is rewritten once in this form at the end of the file,
and the link to it (or the superblock's root address) is patched in place.
Deleting a link turns its message into a NIL message in place. h5py 3.x
reads these files and appends to them.

Each ``File`` writes what it changed when it is closed, and then the
superblock (its end-of-file address, and the root address if the root
moved); a run that opens the file once per item keeps every item that
it closed.
"""

import os
import struct

import numpy as np

UNDEF = 0xFFFFFFFFFFFFFFFF
_SIGNATURE = b"\x89HDF\r\n\x1a\n"
_M32 = 0xFFFFFFFF

# header message types
_NIL, _DATASPACE, _LINFO, _DTYPE, _FILL_OLD, _FILL = 0, 1, 2, 3, 4, 5
_LINK, _LAYOUT, _GINFO, _FILTERS, _ATTR, _CONT = 6, 8, 10, 11, 12, 16
_SYMTAB, _AINFO = 17, 21
_MUST_UNDERSTAND = 0x08 | 0x80
# read (above) or safe to skip: times, reference count, B-tree K values,
# comment, the file settings (0x14), file-space info
_KNOWN = {_NIL, _DATASPACE, _LINFO, _DTYPE, _FILL_OLD, _FILL, _LINK, _LAYOUT,
          _GINFO, _FILTERS, _ATTR, _CONT, _SYMTAB, _AINFO,
          0x0D, 0x0E, 0x12, 0x13, 0x14, 0x16, 0x17}

_CLASS_NAMES = {2: "time", 3: "string", 4: "bitfield", 5: "opaque",
                6: "compound", 7: "reference", 8: "enum",
                9: "variable-length (string or sequence)", 10: "array"}
_MAX_COMPACT = 65535        # the group-info field is 16 bits
_TAIL = 16                  # NIL data bytes kept for a continuation message


def lookup3(data, initval=0):
    """Bob Jenkins' lookup3 ``hashlittle``, the checksum of every HDF5
    structure after version 0."""
    n = len(data)
    a = b = c = (0xDEADBEEF + n + initval) & _M32
    if n == 0:
        return c
    nfull = (n - 1) // 12
    words = struct.unpack_from(f"<{3 * nfull}I", data)
    for i in range(0, 3 * nfull, 3):
        a = (a + words[i]) & _M32
        b = (b + words[i + 1]) & _M32
        c = (c + words[i + 2]) & _M32
        a = (a - c) & _M32
        a ^= ((c << 4) | (c >> 28)) & _M32
        c = (c + b) & _M32
        b = (b - a) & _M32
        b ^= ((a << 6) | (a >> 26)) & _M32
        a = (a + c) & _M32
        c = (c - b) & _M32
        c ^= ((b << 8) | (b >> 24)) & _M32
        b = (b + a) & _M32
        a = (a - c) & _M32
        a ^= ((c << 16) | (c >> 16)) & _M32
        c = (c + b) & _M32
        b = (b - a) & _M32
        b ^= ((a << 19) | (a >> 13)) & _M32
        a = (a + c) & _M32
        c = (c - b) & _M32
        c ^= ((b << 4) | (b >> 28)) & _M32
        b = (b + a) & _M32
    ta, tb, tc = struct.unpack("<3I", bytes(data[12 * nfull:]).ljust(12, b"\0"))
    a = (a + ta) & _M32
    b = (b + tb) & _M32
    c = (c + tc) & _M32

    def rot(x, k):
        return ((x << k) | (x >> (32 - k))) & _M32

    c ^= b
    c = (c - rot(b, 14)) & _M32
    a ^= c
    a = (a - rot(c, 11)) & _M32
    b ^= a
    b = (b - rot(a, 25)) & _M32
    c ^= b
    c = (c - rot(b, 16)) & _M32
    a ^= c
    a = (a - rot(c, 4)) & _M32
    b ^= a
    b = (b - rot(a, 14)) & _M32
    c ^= b
    c = (c - rot(b, 24)) & _M32
    return c


def _u(buf, pos, size):
    return int.from_bytes(buf[pos:pos + size], "little")


# Copies of large blocks already verified, by (file, address). The batch
# pipelines open a file once per item, and each open re-reads the root
# group's header (~60 KB at 2000 images): a block whose bytes equal its
# copy is not hashed again. A block is trusted only on equal bytes, so a
# stale entry costs one hash, never a wrong answer; at most 64 are kept.
_VERIFIED = {}


def _check_sum(buf, end, what, addr, path=None):
    if path is not None and end >= 4096 and _VERIFIED.get((path, addr)) == buf:
        return
    if lookup3(buf[:end]) != _u(buf, end, 4):
        raise ValueError(f"HDF5 checksum mismatch in the {what} at {addr:#x}")
    if path is not None and end >= 4096:
        if len(_VERIFIED) >= 64:
            del _VERIFIED[next(iter(_VERIFIED))]
        _VERIFIED[(path, addr)] = bytes(buf)


def _log2(x):
    return x.bit_length() - 1


# --------------------------------------------------------------------------
# message codecs
# --------------------------------------------------------------------------

def _decode_dataspace(d):
    version, rank = d[0], d[1]
    if version == 1:
        pos, kind = 8, 1 if rank else 0
    elif version == 2:
        pos, kind = 4, d[3]
    else:
        raise ValueError(f"HDF5 dataspace version {version} is not supported")
    if kind == 2:
        raise ValueError("HDF5 null dataspaces are not supported")
    return tuple(struct.unpack_from(f"<{rank}Q", d, pos))


def _encode_dataspace(shape):
    return bytes([2, len(shape), 0, 1 if shape else 0]) + struct.pack(
        f"<{len(shape)}Q", *shape)


_FLOATS = {2: (15, 10, 5, 10, 15), 4: (31, 23, 8, 23, 127),
           8: (63, 52, 11, 52, 1023)}


def _decode_dtype(d):
    """A datatype message → (numpy dtype, encoded length)."""
    cls, bits, size = d[0] & 0x0F, _u(d, 1, 3), _u(d, 4, 4)
    if cls == 0:
        if bits & 1:
            raise ValueError("big-endian HDF5 integer datatypes are not "
                             "supported")
        offset, precision = struct.unpack_from("<HH", d, 8)
        if size not in (1, 2, 4, 8) or offset or precision != 8 * size:
            raise ValueError(f"HDF5 integer datatype of {precision} bits at "
                             f"offset {offset} in {size} bytes is not "
                             "supported")
        return np.dtype(f"<{'i' if bits & 8 else 'u'}{size}"), 12
    if cls == 1:
        if bits & 0x41:
            raise ValueError("big-endian (or VAX) HDF5 floating-point "
                             "datatypes are not supported")
        fields = struct.unpack_from("<HHBBBBI", d, 8)
        want = _FLOATS.get(size)
        if want is None or fields[0] != 0 or fields[1] != 8 * size or (
                (bits >> 8) & 0xFF, fields[2], fields[3], fields[5],
                fields[6]) != want or fields[4] != 0:
            raise ValueError(f"HDF5 {size}-byte floating-point datatype "
                             f"{fields} is not IEEE and not supported")
        return np.dtype(f"<f{size}"), 20
    raise ValueError(f"HDF5 {_CLASS_NAMES.get(cls, f'class-{cls}')} "
                     "datatypes are not supported")


def _encode_dtype(dtype):
    dtype = np.dtype(dtype)
    size = dtype.itemsize
    if dtype.kind in "iu" and size in (1, 2, 4, 8):
        return (bytes([0x10, 0x08 if dtype.kind == "i" else 0, 0, 0])
                + struct.pack("<IHH", size, 0, 8 * size))
    if dtype.kind == "f" and size in _FLOATS:
        sign, exp_loc, exp_size, mant_size, bias = _FLOATS[size]
        return (bytes([0x11, 0x20, sign, 0]) + struct.pack(
            "<IHHBBBBI", size, 0, 8 * size, exp_loc, exp_size, 0, mant_size,
            bias))
    raise ValueError(f"numpy dtype {dtype} has no HDF5 datatype here: only "
                     "little-endian i1..i8, u1..u8, f2, f4 and f8 are "
                     "written")


def _native(dtype):
    dtype = np.dtype(dtype)
    _encode_dtype(dtype)                   # raises on what is not written
    return dtype.newbyteorder("<")


def _decode_attr(d):
    """An attribute message → (name, numpy value)."""
    version = d[0]
    if version not in (1, 2, 3):
        raise ValueError(f"HDF5 attribute message version {version} is not "
                         "supported")
    flags = d[1] if version > 1 else 0
    if flags & 3:
        raise ValueError("HDF5 attributes with a shared datatype or "
                         "dataspace are not supported")
    name_size, dt_size, ds_size = struct.unpack_from("<HHH", d, 2)
    pos = 9 if version == 3 else 8

    def pad(n):
        return -(-n // 8) * 8 if version == 1 else n

    name = bytes(d[pos:pos + name_size]).split(b"\0")[0].decode("utf-8")
    pos += pad(name_size)
    dtype, _ = _decode_dtype(d[pos:pos + dt_size])
    pos += pad(dt_size)
    shape = _decode_dataspace(d[pos:pos + ds_size])
    pos += pad(ds_size)
    count = int(np.prod(shape, dtype=np.int64))
    value = np.frombuffer(bytes(d[pos:pos + count * dtype.itemsize]),
                          dtype).reshape(shape).copy()
    return name, value[()] if shape == () else value


def _encode_attr(name, value):
    name_b = name.encode("utf-8") + b"\0"
    dt, ds = _encode_dtype(value.dtype), _encode_dataspace(value.shape)
    return (bytes([3, 0]) + struct.pack("<HHH", len(name_b), len(dt), len(ds))
            + b"\0" + name_b + dt + ds + value.astype(value.dtype.newbyteorder(
                "<")).tobytes())


def _decode_link(d):
    """A link message → (name, object address)."""
    flags, pos = d[1], 2
    if flags == 0:                  # hard link, 1-byte length, ASCII
        end = 3 + d[2]
        return d[3:end].decode("utf-8"), _u(d, end, 8)
    kind = 0
    if flags & 0x08:
        kind, pos = d[pos], pos + 1
    if flags & 0x04:
        pos += 8
    if flags & 0x10:
        pos += 1
    width = 1 << (flags & 3)
    length = _u(d, pos, width)
    pos += width
    name = bytes(d[pos:pos + length]).decode("utf-8")
    if kind != 0:
        raise ValueError(f"HDF5 {'soft' if kind == 1 else 'external'} link "
                         f"{name!r} is not supported")
    return name, _u(d, pos + length, 8)


def _encode_link(name, addr):
    name_b = name.encode("utf-8")
    utf8 = not name.isascii()
    width = 0 if len(name_b) < 256 else 1
    return (bytes([1, width | (0x10 if utf8 else 0)])
            + (b"\x01" if utf8 else b"")
            + len(name_b).to_bytes(1 << width, "little") + name_b
            + struct.pack("<Q", addr))


def _msg(mtype, data, flags=0):
    return struct.pack("<BHB", mtype, len(data), flags) + data


def _nil(size):
    return _msg(_NIL, bytes(size))


def _header(msgs):
    body = b"".join(msgs)
    code = 0 if len(body) < 1 << 8 else 1 if len(body) < 1 << 16 else 2
    blk = b"OHDR" + bytes([2, code]) + len(body).to_bytes(1 << code,
                                                            "little") + body
    return blk + struct.pack("<I", lookup3(blk))


# --------------------------------------------------------------------------
# object headers, fractal heap, v2 B-tree
# --------------------------------------------------------------------------

class _Header:
    """A parsed object header: its chunks (file address, bytes) and its
    messages (type, flags, chunk index, data offset in the chunk, size)."""

    def __init__(self, f, addr):
        self.addr = addr
        self.chunks, self.msgs = [], []
        head = f._read(addr, 6)
        if head[:4] != b"OHDR":
            raise ValueError(f"no version-2 object header at {addr:#x} "
                             "(version-1 headers are not supported)")
        flags = head[5]
        pos = 6 + (16 if flags & 0x20 else 0) + (4 if flags & 0x10 else 0)
        width = 1 << (flags & 3)
        size = _u(f._read(addr + pos, width), 0, width)
        start = pos + width
        buf = f._read(addr, start + size + 4)
        _check_sum(buf, len(buf) - 4, "object header", addr, f.filename)
        self.mhs = 6 if flags & 0x04 else 4
        todo = [(addr, buf, start)]
        while todo:
            caddr, buf, start = todo.pop(0)
            self.chunks.append([caddr, buf])
            ci, pos, end = len(self.chunks) - 1, start, len(buf) - 4
            while pos + self.mhs <= end:
                mtype, msize, mflags = struct.unpack_from("<BHB", buf, pos)
                data = pos + self.mhs
                if data + msize > end:
                    raise ValueError(f"HDF5 message overruns its header "
                                     f"chunk at {caddr:#x}")
                if mtype not in _KNOWN and mflags & _MUST_UNDERSTAND:
                    raise ValueError(f"HDF5 message type {mtype:#x} at "
                                     f"{caddr + pos:#x} must be understood "
                                     "and is not supported")
                self.msgs.append([mtype, mflags, ci, data, msize])
                if mtype == _CONT:
                    naddr, nlen = struct.unpack_from("<QQ", buf, data)
                    if naddr == addr or any(c[0] == naddr
                                            for c in self.chunks):
                        raise ValueError(f"HDF5 continuation blocks of the "
                                         f"header at {addr:#x} loop")
                    nbuf = f._read(naddr, nlen)
                    if nbuf[:4] != b"OCHK":
                        raise ValueError(f"no continuation block at "
                                         f"{naddr:#x}")
                    _check_sum(nbuf, nlen - 4, "continuation block", naddr,
                               f.filename)
                    todo.append((naddr, nbuf, 4))
                pos = data + msize

    def data(self, msg):
        _, _, ci, pos, size = msg
        return self.chunks[ci][1][pos:pos + size]

    def of(self, mtype):
        return [m for m in self.msgs if m[0] == mtype]


class _FractalHeap:
    """Managed objects of a fractal heap, by heap ID."""

    def __init__(self, f, addr):
        self.f = f
        buf = f._read(addr, 146)
        if buf[:4] != b"FRHP" or buf[4] != 0:
            raise ValueError(f"no version-0 fractal heap at {addr:#x}")
        filter_len, self.flags = _u(buf, 7, 2), buf[9]
        if filter_len:
            raise ValueError("filtered fractal heaps are not supported")
        _check_sum(buf, 142, "fractal heap header", addr)
        self.addr = addr
        self.max_managed = _u(buf, 10, 4)
        (self.width, self.start, self.max_direct, max_bits, _,
         self.root, self.root_rows) = struct.unpack_from("<HQQHHQH", buf, 110)
        self.off_size = (max_bits + 7) // 8
        self.len_size = min((_log2(self.max_direct) + 7) // 8,
                            _log2(self.max_managed) // 8 + 1)
        self.max_direct_rows = _log2(self.max_direct) - _log2(self.start) + 2
        self.blocks = {}

    def _row(self, rel):
        """The row of the doubling table that holds block offset ``rel``,
        its first offset and its block size."""
        first = self.width * self.start
        if rel < first:
            return 0, 0, self.start
        row = _log2(rel // first) + 1
        return row, first << (row - 1), self.start << (row - 1)

    def _direct(self, addr, size, offset):
        if addr not in self.blocks:
            buf = self.f._read(addr, size)
            if buf[:4] != b"FHDB" or _u(buf, 5, 8) != self.addr:
                raise ValueError(f"no direct block of the heap at {addr:#x}")
            if _u(buf, 13, self.off_size) != offset:
                raise ValueError(f"heap direct block at {addr:#x} is not at "
                                 f"offset {offset}")
            if self.flags & 2:
                at = 13 + self.off_size
                stored = _u(buf, at, 4)
                buf[at:at + 4] = bytes(4)
                if lookup3(buf) != stored:
                    raise ValueError(f"HDF5 checksum mismatch in the heap "
                                     f"direct block at {addr:#x}")
            self.blocks[addr] = buf
        return self.blocks[addr]

    def _indirect(self, addr, rows):
        if addr not in self.blocks:
            direct = min(rows, self.max_direct_rows) * self.width
            n = rows * self.width
            size = 13 + self.off_size + 8 * n
            buf = self.f._read(addr, size + 4)
            if buf[:4] != b"FHIB" or _u(buf, 5, 8) != self.addr:
                raise ValueError(f"no indirect block of the heap at "
                                 f"{addr:#x}")
            _check_sum(buf, size, "heap indirect block", addr)
            entries = struct.unpack_from(f"<{n}Q", buf, 13 + self.off_size)
            self.blocks[addr] = (_u(buf, 13, self.off_size),
                                 entries[:direct], entries[direct:])
        return self.blocks[addr]

    def get(self, heap_id):
        if (heap_id[0] >> 4) & 3:
            raise ValueError("huge and tiny fractal-heap objects are not "
                             "supported (a link is a managed object)")
        offset = _u(heap_id, 1, self.off_size)
        length = _u(heap_id, 1 + self.off_size, self.len_size)
        if self.root_rows == 0:
            blk = self._direct(self.root, self.start, 0)
            return blk[offset:offset + length]
        addr, rows = self.root, self.root_rows
        while True:
            base, direct, indirect = self._indirect(addr, rows)
            row, row_off, bsize = self._row(offset - base)
            col = (offset - base - row_off) // bsize
            if row < self.max_direct_rows:
                start = base + row_off + col * bsize
                blk = self._direct(direct[row * self.width + col], bsize,
                                   start)
                return blk[offset - start:offset - start + length]
            addr = indirect[(row - self.max_direct_rows) * self.width + col]
            rows = _log2(bsize) - _log2(self.start * self.width) + 1


def _btree_records(f, addr):
    """Every record of a version-2 B-tree, leaves and internal nodes."""
    buf = f._read(addr, 38)
    if buf[:4] != b"BTHD" or buf[4] != 0:
        raise ValueError(f"no version-2 B-tree at {addr:#x}")
    _check_sum(buf, 34, "B-tree header", addr)
    btype = buf[5]
    node_size, rec_size, depth = struct.unpack_from("<IHH", buf, 6)
    root, root_nrec = struct.unpack_from("<QH", buf, 16)
    if btype != 5:
        raise ValueError(f"B-tree record type {btype} is not supported "
                         "(only link names, type 5)")

    def enc(x):
        return _log2(x) // 8 + 1 if x else 1

    max_nrec = [(node_size - 10) // rec_size]
    cum_max, cum_size = [max_nrec[0]], [0]
    nrec_size = enc(max_nrec[0])
    for d in range(1, depth + 1):
        ptr = 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
        max_nrec.append((node_size - (10 + ptr)) // (rec_size + ptr))
        cum_max.append((max_nrec[d] + 1) * cum_max[d - 1] + max_nrec[d])
        cum_size.append(enc(cum_max[d]))
    out = []

    def walk(addr, nrec, d):
        buf = f._read(addr, node_size)
        sig = b"BTLF" if d == 0 else b"BTIN"
        if buf[:4] != sig or buf[5] != btype:
            raise ValueError(f"no B-tree node of depth {d} at {addr:#x}")
        end = 6 + nrec * rec_size
        out.extend(bytes(buf[6 + i * rec_size:6 + (i + 1) * rec_size])
                   for i in range(nrec))
        if d == 0:
            _check_sum(buf, end, "B-tree leaf", addr)
            return
        children = []
        for _ in range(nrec + 1):
            caddr = _u(buf, end, 8)
            cn = _u(buf, end + 8, nrec_size)
            end += 8 + nrec_size + (cum_size[d - 1] if d > 1 else 0)
            children.append((caddr, cn))
        _check_sum(buf, end, "B-tree internal node", addr)
        for caddr, cn in children:
            walk(caddr, cn, d - 1)

    if root != UNDEF:
        walk(root, root_nrec, depth)
    return out


# --------------------------------------------------------------------------
# the h5py-shaped interface
# --------------------------------------------------------------------------

class AttributeManager:
    """``obj.attrs``: scalar and array numeric attributes."""

    def __init__(self, owner, values):
        self._owner, self._values = owner, values

    def __getitem__(self, key):
        return self._values[key]

    def get(self, key, default=None):
        return self._values.get(key, default)

    def __setitem__(self, key, value):
        self._owner._file._writable()
        value = np.asarray(value)
        value = value.astype(_native(value.dtype))
        self._values[key] = value[()] if value.shape == () else value
        self._owner._attrs_dirty = True

    def items(self):
        return self._values.items()


class _Node:
    def __init__(self, file, name, parent, header=None):
        self._file, self._name, self._parent = file, name, parent
        self._header = header
        self._addr = header.addr if header is not None else None
        self._attrs_dirty = False
        attrs = {}
        if header is not None:
            for m in header.of(_AINFO):
                d = header.data(m)
                pos = 4 if d[1] & 1 else 2
                if _u(d, pos, 8) != UNDEF:
                    raise ValueError(f"dense attribute storage on {name!r} "
                                     "is not supported")
            for m in header.of(_ATTR):
                key, value = _decode_attr(header.data(m))
                attrs[key] = value
        self.attrs = AttributeManager(self, attrs)

    @property
    def name(self):
        return self._name

    @property
    def parent(self):
        return self._parent if self._parent is not None else self

    def _attr_msgs(self):
        return [_msg(_ATTR, _encode_attr(k, np.asarray(v)))
                for k, v in self.attrs.items()]


class Dataset(_Node):
    """A numeric dataset; ``np.asarray(ds)`` reads it."""

    def __init__(self, file, name, parent, header=None, data=None):
        super().__init__(file, name, parent, header)
        if header is None:
            self.shape, self.dtype = data.shape, data.dtype
            self._compact = None
            self._data_addr = file._append(data.tobytes()) if data.size \
                else UNDEF
            self._data_size = data.nbytes
            return
        if header.of(_FILTERS):
            raise ValueError(f"filtered dataset {name!r} is not supported")
        self.shape = _decode_dataspace(header.data(header.of(_DATASPACE)[0]))
        self.dtype, _ = _decode_dtype(header.data(header.of(_DTYPE)[0]))
        layout = header.data(header.of(_LAYOUT)[0])
        if layout[0] not in (3, 4):
            raise ValueError(f"HDF5 data layout version {layout[0]} of "
                             f"{name!r} is not supported")
        cls = layout[1]
        self._compact = None
        if cls == 0:
            size = _u(layout, 2, 2)
            self._compact = bytes(layout[4:4 + size])
        elif cls == 1:
            self._data_addr, self._data_size = struct.unpack_from(
                "<QQ", layout, 2)
        else:
            raise ValueError(f"{'chunked' if cls == 2 else 'virtual'} "
                             f"dataset {name!r} is not supported (only "
                             "contiguous and compact)")

    def __len__(self):
        if not self.shape:
            raise TypeError("a scalar dataset has no len()")
        return self.shape[0]

    def __array__(self, dtype=None, copy=None):
        nbytes = int(np.prod(self.shape, dtype=np.int64)) * self.dtype.itemsize
        if self._compact is not None:
            raw = bytearray(self._compact)
        elif self._data_addr == UNDEF:
            raw = bytearray(nbytes)
        else:
            raw = self._file._read(self._data_addr, self._data_size)
        if len(raw) != nbytes:
            raise ValueError(f"dataset {self._name!r} holds {len(raw)} bytes "
                             f"for {nbytes} expected")
        out = np.frombuffer(raw, self.dtype).reshape(self.shape)
        return out if dtype is None else out.astype(dtype)

    def _header_bytes(self):
        if self._compact is not None:
            layout = bytes([3, 0]) + struct.pack(
                "<H", len(self._compact)) + self._compact
        else:
            layout = bytes([3, 1]) + struct.pack(
                "<QQ", self._data_addr, self._data_size)
        return _header([
            _msg(_DATASPACE, _encode_dataspace(self.shape)),
            _msg(_DTYPE, _encode_dtype(self.dtype), 1),
            _msg(_FILL, bytes([3, 0x0A]), 1),
            _msg(_LAYOUT, layout),
            *self._attr_msgs()])

    def _commit(self):
        """Write the header if it is new or its attributes changed; True
        when the object's address changed."""
        if self._addr is not None and not self._attrs_dirty:
            return False
        self._addr = self._file._append(self._header_bytes())
        self._attrs_dirty = False
        return True

    def __repr__(self):
        return f"<h5lite Dataset {self._name!r} {self.shape} {self.dtype}>"


class Group(_Node):
    """A group: ``in``, ``[]`` and ``del`` on ``/``-separated paths."""

    def __init__(self, file, name, parent, header=None):
        super().__init__(file, name, parent, header)
        self._links = {}          # name → address (not loaded) or node
        self._stored = {}         # name → (chunk, data offset) in the header
        self._added, self._to_nil, self._moved = [], [], set()
        self._tail = None
        self._dense = False
        if header is None:
            return
        if header.of(_SYMTAB):
            raise ValueError(f"old-style group {name!r} (symbol table) is "
                             "not supported")
        for m in header.of(_LINFO):
            d = header.data(m)
            pos = 10 if d[1] & 1 else 2
            heap, btree = struct.unpack_from("<QQ", d, pos)
            if heap != UNDEF:
                self._dense = True
                fheap = _FractalHeap(file, heap)
                for rec in _btree_records(file, btree):
                    key, addr = _decode_link(fheap.get(rec[4:]))
                    self._links[key] = addr
        for m in header.of(_LINK):
            key, addr = _decode_link(header.data(m))
            self._links[key] = addr
            self._stored[key] = (m[2], m[3])
        last = header.msgs[-1] if header.msgs else None
        ginfo = header.of(_GINFO)
        if (not self._dense and last is not None and last[0] == _NIL
                and last[4] >= _TAIL and last[2] == len(header.chunks) - 1
                and header.mhs == 4
                and ginfo and _u(header.data(ginfo[0]), 2, 2) == _MAX_COMPACT
                and header.data(ginfo[0])[1] & 1):
            self._tail = (last[2], last[3] - header.mhs, last[4])

    # ---- navigation -----------------------------------------------------

    def _child(self, key):
        target = self._links[key]
        if isinstance(target, _Node):
            return target
        header = _Header(self._file, target)
        path = f"{self._name.rstrip('/')}/{key}"
        if header.of(_LAYOUT) or header.of(_DATASPACE):
            node = Dataset(self._file, path, self, header)
        else:
            node = Group(self._file, path, self, header)
        self._links[key] = node
        return node

    def _walk(self, path, create=False):
        """(group holding the last component, last component)."""
        node = self._file if path.startswith("/") else self
        parts = [p for p in path.split("/") if p and p != "."]
        if not parts:
            raise KeyError(path)
        for part in parts[:-1]:
            if part not in node._links:
                if not create:
                    raise KeyError(path)
                node._new_group(part)
            node = node._child(part)
            if not isinstance(node, Group):
                raise KeyError(path)
        return node, parts[-1]

    def __contains__(self, path):
        if path in ("/", ""):
            return True
        try:
            group, key = self._walk(path)
        except KeyError:
            return False
        return key in group._links

    def __getitem__(self, path):
        if path == "/":
            return self._file
        try:
            group, key = self._walk(path)
            if key not in group._links:
                raise KeyError(path)
        except KeyError:
            raise KeyError(f"object {path!r} does not exist in "
                           f"{self._name!r}") from None
        return group._child(key)

    def __iter__(self):
        return iter(sorted(self._links))

    def __len__(self):
        return len(self._links)

    def keys(self):
        return sorted(self._links)

    def visititems(self, func):
        """Call ``func(name, obj)`` on every object below this group in
        name order, depth first, as h5py does; stop at the first value
        that is not None and return it."""
        def walk(group, prefix):
            for key in group.keys():
                obj = group._child(key)
                out = func(prefix + key, obj)
                if out is not None:
                    return out
                if isinstance(obj, Group):
                    out = walk(obj, prefix + key + "/")
                    if out is not None:
                        return out
            return None

        return walk(self, "")

    # ---- writing --------------------------------------------------------

    def _add(self, key, node):
        if len(self._links) >= _MAX_COMPACT:
            raise ValueError(f"group {self._name!r} holds {_MAX_COMPACT} "
                             "links, the most a compact group can; dense "
                             "link storage is not written")
        self._links[key] = node
        self._added.append(key)

    def _new_group(self, key):
        node = Group(self._file, f"{self._name.rstrip('/')}/{key}", self)
        self._add(key, node)
        return node

    def create_group(self, name):
        self._file._writable()
        group, key = self._walk(name, create=True)
        if key in group._links:
            raise ValueError(f"unable to create group {name!r}: the name "
                             "already exists")
        return group._new_group(key)

    def create_dataset(self, name, data):
        self._file._writable()
        data = np.asarray(data)
        data = np.array(data, order="C", dtype=_native(data.dtype))
        group, key = self._walk(name, create=True)
        if key in group._links:
            raise ValueError(f"unable to create dataset {name!r}: the name "
                             "already exists")
        node = Dataset(self._file, f"{group._name.rstrip('/')}/{key}", group,
                       data=data)
        group._add(key, node)
        return node

    def __delitem__(self, path):
        self._file._writable()
        group, key = self._walk(path)
        if key not in group._links:
            raise KeyError(f"object {path!r} does not exist")
        del group._links[key]
        if key in group._added:
            group._added.remove(key)
        elif key in group._stored:
            group._to_nil.append(group._stored.pop(key))
        group._moved.discard(key)
        if group._dense:
            group._to_nil.append(None)       # dense: rewritten on commit

    def _addr_of(self, key):
        target = self._links[key]
        return target._addr if isinstance(target, _Node) else target

    def _header_bytes(self):
        links = [_msg(_LINK, _encode_link(k, self._addr_of(k)))
                 for k in sorted(self._links)]
        return _header([
            _msg(_LINFO, bytes(2) + struct.pack("<QQ", UNDEF, UNDEF)),
            _msg(_GINFO, bytes([0, 1]) + struct.pack("<HH", _MAX_COMPACT, 6),
                 1),
            *self._attr_msgs(), *links, _nil(_TAIL)])

    def _commit(self):
        """Write what changed below and in this group; True when the
        group's header moved (its parent's link must follow)."""
        for key, target in self._links.items():
            if isinstance(target, _Node) and target._commit() \
                    and key not in self._added:
                self._moved.add(key)
        changed = self._added or self._to_nil or self._moved \
            or self._attrs_dirty
        if self._addr is not None and not changed:
            return False
        hdr = self._header
        long_chain = hdr is not None and \
            len(hdr.chunks) > 16 + len(self._links) // 16
        if (self._addr is None or self._dense or self._attrs_dirty
                or long_chain or (self._added and self._tail is None)):
            self._rewrite()
            return True
        f, patched = self._file, set()
        for ci, pos in self._to_nil:
            buf = hdr.chunks[ci][1]
            size = _u(buf, pos - hdr.mhs + 1, 2)
            buf[pos:pos + size] = bytes(size)
            buf[pos - hdr.mhs] = _NIL
            patched.add(ci)
        for key in self._moved:
            ci, pos = self._stored[key]
            buf = hdr.chunks[ci][1]
            size = _u(buf, pos - hdr.mhs + 1, 2)
            buf[pos + size - 8:pos + size] = struct.pack(
                "<Q", self._addr_of(key))
            patched.add(ci)
        if self._added:
            blk = b"OCHK" + b"".join(
                _msg(_LINK, _encode_link(k, self._addr_of(k)))
                for k in self._added) + _nil(_TAIL)
            blk += struct.pack("<I", lookup3(blk))
            addr = f._append(blk)
            ci, pos, size = self._tail
            buf = hdr.chunks[ci][1]
            buf[pos:pos + 4 + size] = _msg(_CONT, struct.pack(
                "<QQ", addr, len(blk)) + bytes(size - 16))
            patched.add(ci)
        for ci in sorted(patched):
            caddr, buf = hdr.chunks[ci]
            buf[-4:] = struct.pack("<I", lookup3(buf[:-4]))
            f._write_at(caddr, buf)
        return False

    def _rewrite(self):
        self._addr = self._file._append(self._header_bytes())

    def __repr__(self):
        return f"<h5lite Group {self._name!r} ({len(self._links)} members)>"


class File(Group):
    """``File(path, mode)``: ``r`` reads, ``a`` reads and writes the file
    or creates it, ``w`` truncates or creates it. Usable as a context
    manager; changes are written on close."""

    def __init__(self, path, mode="r"):
        if mode not in ("r", "a", "w"):
            raise ValueError(f"mode {mode!r} is not one of r, a, w")
        self.filename = os.fspath(path)
        self.mode = mode
        exists = os.path.exists(self.filename)
        if mode == "w" or (mode == "a" and not exists):
            self._fh = open(self.filename, "w+b")
            self._eof = self._size = 48
            self._fh.write(bytes(48))
            self._root_addr = self._append(
                Group(self, "/", None)._header_bytes())
            self._write_superblock()
        else:
            self._fh = open(self.filename, "rb" if mode == "r" else "r+b")
        try:
            if not hasattr(self, "_root_addr"):
                self._read_superblock()
            super().__init__(self, "/", None, _Header(self, self._root_addr))
        except BaseException:
            self._fh.close()
            self._fh = None
            raise

    # ---- the byte layer -------------------------------------------------

    def _read(self, addr, size):
        if addr == UNDEF or addr + size > self._size:
            raise ValueError(f"HDF5 address {addr:#x} + {size} lies beyond "
                             f"the end of {self.filename}")
        self._fh.seek(addr)
        buf = bytearray(size)
        if self._fh.readinto(buf) != size:
            raise ValueError(f"short read at {addr:#x} in {self.filename}")
        return buf

    def _append(self, data):
        addr = self._eof
        self._fh.seek(addr)
        self._fh.write(data)
        self._eof += len(data)
        self._size = max(self._size, self._eof)
        return addr

    def _write_at(self, addr, data):
        self._fh.seek(addr)
        self._fh.write(data)

    def _writable(self):
        if self.mode == "r":
            raise ValueError(f"{self.filename} is open read-only")

    def _read_superblock(self):
        self._size = os.fstat(self._fh.fileno()).st_size
        buf = self._read(0, 48) if self._size >= 48 else b""
        if buf[:8] != _SIGNATURE:
            raise ValueError(f"{self.filename} is not an HDF5 file (or has a "
                             "user block, which is not supported)")
        if buf[8] not in (2, 3):
            raise ValueError(f"HDF5 superblock version {buf[8]} is not "
                             "supported (only 2 and 3: write the file with "
                             "libver='latest')")
        if buf[9] != 8 or buf[10] != 8:
            raise ValueError("HDF5 offsets and lengths other than 8 bytes "
                             "are not supported")
        _check_sum(buf, 44, "superblock", 0)
        base, self._ext, eof, self._root_addr = struct.unpack_from(
            "<QQQQ", buf, 12)
        if base != 0:
            raise ValueError("an HDF5 base address other than 0 is not "
                             "supported")
        self._sb_version = buf[8]
        self._eof = max(eof, self._size)

    def _write_superblock(self):
        ext = getattr(self, "_ext", UNDEF)
        sb = _SIGNATURE + bytes([getattr(self, "_sb_version", 3), 8, 8, 0]) \
            + struct.pack("<QQQQ", 0, ext, self._eof, self._root_addr)
        self._write_at(0, sb + struct.pack("<I", lookup3(sb)))

    # ---- life cycle -----------------------------------------------------

    def close(self):
        """Write what changed, then the superblock, and close."""
        if getattr(self, "_fh", None) is None:
            return
        try:
            if self.mode != "r":
                if self._commit():
                    self._root_addr = self._addr
                self._write_superblock()
        finally:
            self._fh.close()
            self._fh = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __repr__(self):
        return f"<h5lite File {self.filename!r} (mode {self.mode})>"
