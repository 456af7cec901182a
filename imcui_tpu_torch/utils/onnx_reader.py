"""ONNX initialisers read from the protobuf wire format, with numpy only.

Counterpart of ``imcui_tpu/utils/onnx_reader.py``, of which this is the
port's own copy: the port imports nothing of the JAX package. OmniGlue's
upstream weights are ONNX graphs; their parameters are the
``TensorProto`` initialisers of ``ModelProto.graph``, which a few varint
and length-delimited fields recover as a flat ``{name: np.ndarray}``
without the ``onnx`` package.

The subset read (onnx.proto3):

- ModelProto: field 7, the graph (GraphProto);
- GraphProto: field 5, the initialisers (repeated TensorProto); subgraphs
  inside node attributes are not walked;
- TensorProto: 1 dims (int64, packed or not), 2 data_type, 8 name,
  9 raw_data, 4 float_data, 5 int32_data, 7 int64_data, 10 double_data.

A tensor with external data (field 13) or an unknown type raises.
Nothing reads an OmniGlue graph yet: no such file is in the repository,
and ``models/matchers/omniglue.py`` runs its seed-0 tree.
"""

import re

import numpy as np

# onnx TensorProto.DataType → numpy dtype
_DTYPES = {
    1: np.float32, 2: np.uint8, 3: np.int8, 4: np.uint16, 5: np.int16,
    6: np.int32, 7: np.int64, 9: np.bool_, 10: np.float16, 11: np.float64,
    12: np.uint32, 13: np.uint64,
}
_BF16 = 16


def _read_varint(buf, pos):
    result = shift = 0
    while True:
        b = buf[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not b & 0x80:
            return result, pos
        shift += 7
        if shift > 70:
            raise ValueError("varint too long (corrupt ONNX file)")


def _varints(buf, start, end):
    out, pos = [], start
    while pos < end:
        v, pos = _read_varint(buf, pos)
        out.append(v)
    return out


def _iter_fields(buf, start=0, end=None):
    """Yield (field number, wire type, value); a length-delimited value is
    its (start, end) span in ``buf``."""
    pos = start
    end = len(buf) if end is None else end
    while pos < end:
        tag, pos = _read_varint(buf, pos)
        field, wire = tag >> 3, tag & 7
        if wire == 0:
            val, pos = _read_varint(buf, pos)
        elif wire == 1:
            val, pos = buf[pos:pos + 8], pos + 8
        elif wire == 2:
            ln, pos = _read_varint(buf, pos)
            val, pos = (pos, pos + ln), pos + ln
        elif wire == 5:
            val, pos = buf[pos:pos + 4], pos + 4
        else:
            raise ValueError(f"unsupported wire type {wire}")
        yield field, wire, val


def _parse_tensor(buf, start, end):
    dims, dtype_id, name, raw, typed = [], 1, "", None, None
    for field, wire, val in _iter_fields(buf, start, end):
        if field == 1:
            dims.extend([val] if wire == 0 else _varints(buf, *val))
        elif field == 2 and wire == 0:
            dtype_id = val
        elif field == 8 and wire == 2:
            name = bytes(buf[val[0]:val[1]]).decode("utf-8")
        elif field == 9 and wire == 2:
            raw = bytes(buf[val[0]:val[1]])
        elif field == 4 and wire == 2:      # packed float_data
            typed = np.frombuffer(buf[val[0]:val[1]], dtype="<f4")
        elif field == 4 and wire == 5:      # one unpacked float
            one = np.frombuffer(val, dtype="<f4")
            typed = one if typed is None else np.concatenate([typed, one])
        elif field == 10 and wire == 2:     # packed double_data
            typed = np.frombuffer(buf[val[0]:val[1]], dtype="<f8")
        elif field in (5, 7) and wire == 2:  # packed int32/int64 varints
            typed = np.asarray(_varints(buf, *val), dtype=np.int64)
        elif field == 13:
            raise ValueError(
                f"ONNX tensor {name or '<unnamed>'} uses external data, "
                "which this reader does not follow")

    if dtype_id == _BF16:
        if raw is None:
            raise ValueError(f"bfloat16 tensor {name} without raw_data")
        arr = (np.frombuffer(raw, dtype="<u2").astype(np.uint32) << 16
               ).view(np.float32)
    elif raw is not None:
        dt = _DTYPES.get(dtype_id)
        if dt is None:
            raise ValueError(f"unsupported ONNX dtype {dtype_id} ({name})")
        arr = np.frombuffer(raw, dtype=np.dtype(dt).newbyteorder("<"))
    elif typed is not None:
        arr = typed.astype(_DTYPES.get(dtype_id, np.float32))
    else:
        arr = np.zeros(0, np.float32)
    return name, arr.reshape(dims) if dims else arr.reshape(())


def read_onnx_initializers(path):
    """An .onnx file → {initialiser name: np.ndarray}."""
    with open(path, "rb") as f:
        buf = memoryview(f.read())
    out = {}
    for field, wire, val in _iter_fields(buf):
        if field == 7 and wire == 2:                   # ModelProto.graph
            for gf, gw, gv in _iter_fields(buf, *val):
                if gf == 5 and gw == 2:                # initializer
                    name, arr = _parse_tensor(buf, *gv)
                    out[name] = arr
    return out


def onnx_to_state_dict(path, rename=()):
    """The initialisers under dotted torch-style names: slashes become
    dots, a ``:N`` suffix goes, then each (regex, replacement) of
    ``rename`` applies in turn."""
    sd = {}
    for name, arr in read_onnx_initializers(path).items():
        k = re.sub(r":\d+$", "", name.replace("/", ".").strip("."))
        for pattern, repl in rename:
            k = re.sub(pattern, repl, k)
        sd[k] = arr
    return sd
