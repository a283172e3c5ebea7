"""GGUF file writer (v3), for the synthetic models of tools/synth_gguf.py.

Wire format follows crabml-core/src/gguf.rs:399-570.
"""

from __future__ import annotations

import struct
from typing import Any, Callable, Sequence

import numpy as np

from .constants import GGML_BLOCK_SIZES, GGMLType, GGUF_MAGIC, GGUFValueType, tensor_nbytes


def _pack_str(s: str) -> bytes:
    b = s.encode("utf-8")
    return struct.pack("<Q", len(b)) + b


def _value_type_of(v: Any) -> GGUFValueType:
    if isinstance(v, bool):
        return GGUFValueType.BOOL
    if isinstance(v, int):
        return GGUFValueType.U32 if 0 <= v < 2**32 else GGUFValueType.I64
    if isinstance(v, float):
        return GGUFValueType.F32
    if isinstance(v, str):
        return GGUFValueType.STRING
    if isinstance(v, (list, tuple, np.ndarray)):
        return GGUFValueType.ARRAY
    raise TypeError(f"cannot infer GGUF type for {type(v)}")


def _pack_value(v: Any, typ: GGUFValueType) -> bytes:
    if typ == GGUFValueType.U8:
        return struct.pack("<B", v)
    if typ == GGUFValueType.I8:
        return struct.pack("<b", v)
    if typ == GGUFValueType.U16:
        return struct.pack("<H", v)
    if typ == GGUFValueType.I16:
        return struct.pack("<h", v)
    if typ == GGUFValueType.U32:
        return struct.pack("<I", v)
    if typ == GGUFValueType.I32:
        return struct.pack("<i", v)
    if typ == GGUFValueType.U64:
        return struct.pack("<Q", v)
    if typ == GGUFValueType.I64:
        return struct.pack("<q", v)
    if typ == GGUFValueType.F32:
        return struct.pack("<f", v)
    if typ == GGUFValueType.F64:
        return struct.pack("<d", v)
    if typ == GGUFValueType.BOOL:
        return struct.pack("<B", 1 if v else 0)
    if typ == GGUFValueType.STRING:
        return _pack_str(v)
    if typ == GGUFValueType.ARRAY:
        return _pack_array(v)
    raise TypeError(f"unsupported type {typ}")


_NP_TO_GGUF = {
    np.dtype(np.uint8): GGUFValueType.U8,
    np.dtype(np.int8): GGUFValueType.I8,
    np.dtype(np.uint16): GGUFValueType.U16,
    np.dtype(np.int16): GGUFValueType.I16,
    np.dtype(np.uint32): GGUFValueType.U32,
    np.dtype(np.int32): GGUFValueType.I32,
    np.dtype(np.uint64): GGUFValueType.U64,
    np.dtype(np.int64): GGUFValueType.I64,
    np.dtype(np.float32): GGUFValueType.F32,
    np.dtype(np.float64): GGUFValueType.F64,
}


def _pack_array(arr) -> bytes:
    if isinstance(arr, np.ndarray):
        et = _NP_TO_GGUF[arr.dtype]
        return (
            struct.pack("<IQ", int(et), arr.size) + arr.astype(arr.dtype).tobytes()
        )
    if len(arr) == 0:
        return struct.pack("<IQ", int(GGUFValueType.U32), 0)
    first = arr[0]
    if isinstance(first, str):
        out = struct.pack("<IQ", int(GGUFValueType.STRING), len(arr))
        return out + b"".join(_pack_str(s) for s in arr)
    if isinstance(first, float):
        a = np.asarray(arr, dtype=np.float32)
        return struct.pack("<IQ", int(GGUFValueType.F32), a.size) + a.tobytes()
    if isinstance(first, bool):
        out = struct.pack("<IQ", int(GGUFValueType.BOOL), len(arr))
        return out + b"".join(struct.pack("<B", 1 if b else 0) for b in arr)
    if isinstance(first, int):
        a = np.asarray(arr, dtype=np.int32)
        return struct.pack("<IQ", int(GGUFValueType.I32), a.size) + a.tobytes()
    raise TypeError(f"cannot pack array of {type(first)}")


class GGUFWriter:
    """Collects metadata and tensors, then writes a GGUF v3 file. A tensor's
    payload may be given as a function that returns it: it is called only
    while the file is written, so a multi-GB file never sits in memory."""

    def __init__(self, alignment: int = 32):
        self.alignment = alignment
        self._metadata: list[tuple[str, Any, GGUFValueType | None]] = []
        # (name, ggml_dims, typ, nbytes, payload or function returning it)
        self._tensors: list[tuple[str, tuple[int, ...], GGMLType, int, Any]] = []

    def add_metadata(self, key: str, value: Any, typ: GGUFValueType | None = None):
        self._metadata.append((key, value, typ))

    def add_tensor(
        self,
        name: str,
        typ: GGMLType,
        shape: Sequence[int],
        packed: bytes | np.ndarray | Callable[[], bytes | np.ndarray],
    ):
        """`shape` is numpy order; stored on disk in reversed (ggml) order.

        `packed` must already be in the ggml wire encoding for `typ`
        (use quant.codecs.quantize for float data), or be a function that
        returns it.
        """
        n_elems = int(np.prod(shape)) if len(shape) else 1
        blk = GGML_BLOCK_SIZES[typ][0]
        if len(shape) > 1 and shape[-1] % blk != 0:
            raise ValueError(
                f"tensor {name}: row length {shape[-1]} not a multiple of "
                f"{typ.name} block size {blk} (blocks must not span rows)"
            )
        ggml_dims = tuple(reversed(tuple(int(d) for d in shape)))
        self._tensors.append((name, ggml_dims, typ, tensor_nbytes(typ, n_elems), packed))

    def write(self, path: str):
        align = self.alignment
        header = bytearray()
        header += struct.pack("<IIQQ", GGUF_MAGIC, 3, len(self._tensors), len(self._metadata))
        for key, value, typ in self._metadata:
            typ = typ if typ is not None else _value_type_of(value)
            header += _pack_str(key)
            header += struct.pack("<I", int(typ))
            header += _pack_value(value, typ)

        # tensor infos with ascending aligned offsets
        offset = 0
        for name, ggml_dims, typ, nbytes, _ in self._tensors:
            header += _pack_str(name)
            header += struct.pack("<I", len(ggml_dims))
            for d in ggml_dims:
                header += struct.pack("<Q", d)
            header += struct.pack("<I", int(typ))
            header += struct.pack("<Q", offset)
            offset += (nbytes + align - 1) // align * align

        data_start = (len(header) + align - 1) // align * align
        with open(path, "wb") as f:
            f.write(header)
            f.write(b"\x00" * (data_start - len(header)))
            for name, _, typ, nbytes, packed in self._tensors:
                data = packed() if callable(packed) else packed
                # an array is written from its own buffer (no bytes copy)
                data = (np.ascontiguousarray(data).reshape(-1).view(np.uint8)
                        if isinstance(data, np.ndarray) else np.frombuffer(bytes(data), np.uint8))
                if data.nbytes != nbytes:
                    raise ValueError(
                        f"tensor {name}: expected {nbytes} packed bytes for "
                        f"{typ.name}, got {data.nbytes}"
                    )
                f.write(memoryview(data))
                f.write(b"\x00" * ((nbytes + align - 1) // align * align - nbytes))
