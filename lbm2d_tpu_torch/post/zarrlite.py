"""Minimal self-contained Zarr v2 directory-store writer/reader.

The environment has no ``zarr``/``numcodecs`` packages, so this module
implements the (simple, stable) Zarr v2 on-disk format directly: per-array
``.zarray`` JSON metadata, ``.zgroup``/``.zattrs`` files, and C-order chunk
files named ``i.j.k``. The default compressor is the numcodecs ``blosc``
codec in the reference's exact configuration (cname zstd, clevel 5,
bitshuffle -- c-blosc1 chunk container emitted by ``bloscmini``) when the
``zstandard`` module is present; the plain numcodecs ``zstd`` (raw frames)
and ``zlib`` codecs remain available, and ``None`` writes raw chunks.

Scope: what the dataset post-process needs -- groups, whole-array writes of
in-memory numpy data with arbitrary chunking, attribute dicts, and reads for
round-trip tests / the IO benchmark.
"""

from __future__ import annotations

import itertools
import json
import math
import os
import shutil
import zlib
from typing import Any, Dict, Optional, Sequence, Tuple

import numpy as np

try:  # numcodecs 'zstd' codec = raw zstd frames; zstandard provides them
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

from . import bloscmini

# the reference dataset contract is Blosc(zstd-5, bitshuffle)
# (src/post_process/h5_to_zarr_pipeline.py:13-19); bloscmini emits that
# c-blosc1 container directly, so "blosc" is the default whenever zstd
# bindings exist
DEFAULT_CODEC = "blosc" if _zstd is not None else "zlib"


def _compress(
    raw: bytes, comp_meta: Optional[Dict[str, Any]], itemsize: int = 1
) -> bytes:
    if comp_meta is None:
        return raw
    if comp_meta["id"] == "blosc":
        return bloscmini.compress(
            raw,
            typesize=itemsize,
            clevel=comp_meta["clevel"],
            shuffle=comp_meta["shuffle"],
            blocksize=comp_meta["blocksize"],
        )
    if comp_meta["id"] == "zstd":
        return _zstd.ZstdCompressor(level=comp_meta["level"]).compress(raw)
    return zlib.compress(raw, comp_meta["level"])


def _decompress(raw: bytes, comp_meta: Optional[Dict[str, Any]]) -> bytes:
    if comp_meta is None:
        return raw
    if comp_meta["id"] == "blosc":
        return bloscmini.decompress(raw)
    if comp_meta["id"] == "zstd":
        if _zstd is None:
            raise RuntimeError("zstd-compressed store needs the zstandard module")
        return _zstd.ZstdDecompressor().decompress(raw)
    if comp_meta["id"] != "zlib":
        raise ValueError(f"unsupported compressor {comp_meta}")
    return zlib.decompress(raw)

_DTYPE_MAP = {
    np.dtype("float16"): "<f2",
    np.dtype("float32"): "<f4",
    np.dtype("float64"): "<f8",
    np.dtype("int32"): "<i4",
    np.dtype("int64"): "<i8",
    np.dtype("uint8"): "|u1",
    np.dtype("bool"): "|b1",
}


def _dtype_str(dtype: np.dtype) -> str:
    dtype = np.dtype(dtype)
    if dtype in _DTYPE_MAP:
        return _DTYPE_MAP[dtype]
    return dtype.str


class ZarrGroup:
    """A Zarr v2 group backed by a directory."""

    def __init__(self, path: str, overwrite: bool = False):
        self.path = path
        if overwrite and os.path.isdir(path):
            shutil.rmtree(path)
        os.makedirs(path, exist_ok=True)
        zgroup = os.path.join(path, ".zgroup")
        if not os.path.exists(zgroup):
            with open(zgroup, "w") as fh:
                json.dump({"zarr_format": 2}, fh)
        self._attrs: Dict[str, Any] = self._read_attrs()

    # -- attrs ---------------------------------------------------------------

    def _read_attrs(self) -> Dict[str, Any]:
        p = os.path.join(self.path, ".zattrs")
        if os.path.exists(p):
            with open(p) as fh:
                return json.load(fh)
        return {}

    @property
    def attrs(self) -> Dict[str, Any]:
        return self._attrs

    def update_attrs(self, d: Dict[str, Any]) -> None:
        self._attrs.update(d)
        with open(os.path.join(self.path, ".zattrs"), "w") as fh:
            json.dump(self._attrs, fh, indent=2, default=str)

    # -- children ------------------------------------------------------------

    def create_group(self, name: str) -> "ZarrGroup":
        return ZarrGroup(os.path.join(self.path, name))

    def create_array(
        self,
        name: str,
        data: np.ndarray,
        chunks: Sequence[int],
        dtype=None,
        compressor: Optional[str] = DEFAULT_CODEC,
        level: int = 5,
    ) -> str:
        """Write a full in-memory array as a chunked Zarr v2 array."""
        data = np.asarray(data)
        if dtype is not None:
            data = data.astype(dtype)
        chunks = tuple(int(min(c, s)) for c, s in zip(chunks, data.shape))
        adir = os.path.join(self.path, name)
        os.makedirs(adir, exist_ok=True)

        if compressor == "blosc":
            # exact numcodecs Blosc meta the reference pipeline writes
            comp_meta = {
                "id": "blosc", "cname": "zstd", "clevel": level,
                "shuffle": bloscmini.BITSHUFFLE, "blocksize": 0,
            }
        elif compressor in ("zlib", "zstd"):
            comp_meta = {"id": compressor, "level": level}
        elif compressor is None:
            comp_meta = None
        else:
            raise ValueError(f"unknown compressor {compressor!r}")
        meta = {
            "zarr_format": 2,
            "shape": list(data.shape),
            "chunks": list(chunks),
            "dtype": _dtype_str(data.dtype),
            "compressor": comp_meta,
            "fill_value": 0,
            "order": "C",
            "filters": None,
        }
        with open(os.path.join(adir, ".zarray"), "w") as fh:
            json.dump(meta, fh, indent=2)

        grid = [math.ceil(s / c) for s, c in zip(data.shape, chunks)]
        for idx in itertools.product(*(range(g) for g in grid)):
            sl = tuple(
                slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, data.shape)
            )
            block = data[sl]
            # pad partial edge chunks to the full chunk shape (zarr v2 stores
            # full-size chunks with fill_value padding)
            if block.shape != chunks:
                full = np.zeros(chunks, data.dtype)
                full[tuple(slice(0, e) for e in block.shape)] = block
                block = full
            raw = _compress(
                np.ascontiguousarray(block).tobytes(), comp_meta,
                itemsize=data.dtype.itemsize,
            )
            with open(os.path.join(adir, ".".join(map(str, idx))), "wb") as fh:
                fh.write(raw)
        return adir


def open_array(path: str) -> np.ndarray:
    """Read a full Zarr v2 array written by this module (or compatible)."""
    with open(os.path.join(path, ".zarray")) as fh:
        meta = json.load(fh)
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    comp = meta.get("compressor")
    out = np.zeros(shape, dtype)
    grid = [math.ceil(s / c) for s, c in zip(shape, chunks)]
    for idx in itertools.product(*(range(g) for g in grid)):
        fname = os.path.join(path, ".".join(map(str, idx)))
        if not os.path.exists(fname):
            continue
        with open(fname, "rb") as fh:
            raw = fh.read()
        block = np.frombuffer(_decompress(raw, comp), dtype).reshape(chunks)
        sl = tuple(
            slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape)
        )
        out[sl] = block[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def read_region(path: str, sel: Sequence[slice]) -> np.ndarray:
    """Read a rectangular region, decompressing ONLY intersecting chunks.

    This is the access pattern Zarr exists for (random training crops,
    reference ``src/analysis/zarr_check.py``): a crop touching k chunks
    costs k chunk reads, not a whole-array scan. ``sel`` must be one
    ``slice(start, stop)`` per dimension (step 1).
    """
    with open(os.path.join(path, ".zarray")) as fh:
        meta = json.load(fh)
    shape = tuple(meta["shape"])
    chunks = tuple(meta["chunks"])
    dtype = np.dtype(meta["dtype"])
    comp = meta.get("compressor")
    if len(sel) != len(shape):
        raise ValueError(f"need {len(shape)} slices, got {len(sel)}")
    bounds = []
    for s, n in zip(sel, shape):
        start, stop, step = s.indices(n)
        if step != 1:
            raise ValueError("read_region supports contiguous slices only")
        bounds.append((start, stop))
    out = np.zeros([max(0, b - a) for a, b in bounds], dtype)
    if out.size == 0:
        return out
    chunk_ranges = [
        range(a // c, (b - 1) // c + 1) for (a, b), c in zip(bounds, chunks)
    ]
    for idx in itertools.product(*chunk_ranges):
        fname = os.path.join(path, ".".join(map(str, idx)))
        if not os.path.exists(fname):
            continue
        with open(fname, "rb") as fh:
            raw = fh.read()
        block = np.frombuffer(_decompress(raw, comp), dtype).reshape(chunks)
        sel_out, sel_blk = [], []
        for i, c, (a, b) in zip(idx, chunks, bounds):
            lo = max(a, i * c)
            hi = min(b, (i + 1) * c)
            sel_out.append(slice(lo - a, hi - a))
            sel_blk.append(slice(lo - i * c, hi - i * c))
        out[tuple(sel_out)] = block[tuple(sel_blk)]
    return out


def read_attrs(path: str) -> Dict[str, Any]:
    p = os.path.join(path, ".zattrs")
    if os.path.exists(p):
        with open(p) as fh:
            return json.load(fh)
    return {}
