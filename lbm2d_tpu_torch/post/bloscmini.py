"""Pure-Python c-blosc1 chunk codec (zstd + bitshuffle), numcodecs-compatible.

The reference dataset contract compresses Zarr chunks with numcodecs
``Blosc(cname="zstd", clevel=5, shuffle=Blosc.BITSHUFFLE)``
(``/root/reference/src/post_process/h5_to_zarr_pipeline.py:13-19``). This
environment has neither ``numcodecs`` nor ``blosc``, so this module emits the
c-blosc1 container format directly: any stock zarr 2.x + numcodecs reader
decodes the chunks, and the ``.zarray`` compressor id can say ``"blosc"``
truthfully.

Format implemented (c-blosc 1.x ``blosc.c``):

* 16-byte header:
  ``version(1) versionlz(1) flags(1) typesize(1) nbytes(i4) blocksize(i4)
  cbytes(i4)`` -- all little-endian. ``flags`` bit0 = byte shuffle, bit1 =
  pure memcpy, bit2 = bit shuffle; bits 5-7 = compressor format code
  (zstd = 4).
* memcpy mode (bit1): raw buffer follows the header verbatim.
* otherwise: ``nblocks`` little-endian int32 block-start offsets (relative
  to the chunk start), then per block one *stream*: int32 compressed size
  followed by the zstd frame -- zstd is a no-split codec in c-blosc, so each
  block is exactly one stream. A stream whose stored size equals the
  uncompressed block size is a verbatim copy (blosc's incompressible-block
  escape).
* filters are applied per block, before compression. BITSHUFFLE follows the
  kiyo-masui/bitshuffle transform ``bshuf_trans_bit_elem`` on
  ``n - n % 8`` elements with the tail memcpy'd raw (c-blosc ``shuffle.c``
  semantics); byte SHUFFLE is the plain [n, t] -> [t, n] byte transpose.

Scope: compressor ``zstd`` only (what the contract needs); decode also
accepts byte-shuffle/no-shuffle chunks. Encode never splits blocks (correct
for zstd) and picks a fixed 256 KiB auto blocksize -- readers take the
blocksize from the header, so this differs from c-blosc's L1-heuristic
choice without affecting compatibility.
"""

from __future__ import annotations

import struct
from typing import Optional

import numpy as np

try:
    import zstandard as _zstd
except ImportError:  # pragma: no cover
    _zstd = None

# header byte values (c-blosc blosc.h)
BLOSC_VERSION_FORMAT = 2
BLOSC_ZSTD_VERSION_FORMAT = 1
_FLAG_BYTE_SHUFFLE = 0x1
_FLAG_MEMCPY = 0x2
_FLAG_BIT_SHUFFLE = 0x4
_CODE_ZSTD = 4  # bits 5-7 of flags

# numcodecs Blosc shuffle enum
NOSHUFFLE = 0
SHUFFLE = 1
BITSHUFFLE = 2

_AUTO_BLOCKSIZE = 256 * 1024
_MAX_TYPESIZE = 255


def available() -> bool:
    return _zstd is not None


# -- filters ------------------------------------------------------------------


def _byte_shuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    """c-blosc SHUFFLE: byte-transpose [n, t] -> [t, n]; tail bytes raw."""
    n = block.size // typesize
    cut = n * typesize
    body = block[:cut].reshape(n, typesize).T
    return np.concatenate([np.ascontiguousarray(body).reshape(-1), block[cut:]])


def _byte_unshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    n = block.size // typesize
    cut = n * typesize
    body = block[:cut].reshape(typesize, n).T
    return np.concatenate([np.ascontiguousarray(body).reshape(-1), block[cut:]])


def _bit_shuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    """bshuf_trans_bit_elem on n - n % 8 elements; leftovers copied raw.

    Output layout (bitshuffle_core.c trans_byte_elem -> trans_bit_byte ->
    trans_bitrow_eight): row (e*8 + b) of length n/8 bytes holds bit ``b``
    of byte ``e`` of every element, packed LSB-first.
    """
    n = block.size // typesize
    m = n - n % 8
    cut = m * typesize
    if m == 0:
        return block.copy()
    a = block[:cut].reshape(m, typesize)
    bits = np.unpackbits(a[:, :, None], axis=2, bitorder="little")  # [m,t,8]
    planes = bits.transpose(1, 2, 0)  # [t, 8, m]
    packed = np.packbits(planes, axis=-1, bitorder="little")  # [t, 8, m/8]
    return np.concatenate([packed.reshape(-1), block[cut:]])


def _bit_unshuffle(block: np.ndarray, typesize: int) -> np.ndarray:
    n = block.size // typesize
    m = n - n % 8
    cut = m * typesize
    if m == 0:
        return block.copy()
    packed = block[:cut].reshape(typesize, 8, m // 8)
    bits = np.unpackbits(packed, axis=-1, bitorder="little")  # [t, 8, m]
    a = np.packbits(bits.transpose(2, 0, 1), axis=-1, bitorder="little")
    return np.concatenate([a.reshape(m * typesize), block[cut:]])


# -- chunk codec ----------------------------------------------------------------


def compress(
    raw: bytes,
    typesize: int,
    clevel: int = 5,
    shuffle: int = BITSHUFFLE,
    blocksize: int = 0,
) -> bytes:
    """Compress one buffer into a c-blosc1 chunk (zstd compressor)."""
    if _zstd is None:  # pragma: no cover
        raise RuntimeError("blosc codec needs the zstandard module")
    nbytes = len(raw)
    if not 1 <= typesize <= _MAX_TYPESIZE:
        typesize = 1  # c-blosc falls back to 1 for oversized items
    if shuffle not in (NOSHUFFLE, SHUFFLE, BITSHUFFLE):
        raise ValueError(f"unknown shuffle mode {shuffle}")
    if nbytes == 0:
        return _header(shuffle, typesize, 0, 0, 16, memcpy=True)

    if blocksize <= 0:
        blocksize = _AUTO_BLOCKSIZE
    # filters operate on whole elements; bitshuffle additionally wants the
    # per-block element count to be a multiple of 8 so no block carries a
    # raw tail except the last
    gran = typesize * 8 if shuffle == BITSHUFFLE else typesize
    blocksize = max(gran, blocksize - blocksize % gran)
    blocksize = min(blocksize, nbytes + (-nbytes) % gran)

    data = np.frombuffer(raw, np.uint8)
    comp = _zstd.ZstdCompressor(level=clevel)
    nblocks = (nbytes + blocksize - 1) // blocksize
    streams = []
    for i in range(nblocks):
        block = data[i * blocksize : min((i + 1) * blocksize, nbytes)]
        if shuffle == BITSHUFFLE:
            filtered = _bit_shuffle(block, typesize)
        elif shuffle == SHUFFLE:
            filtered = _byte_shuffle(block, typesize)
        else:
            filtered = block
        cdata = comp.compress(filtered.tobytes())
        if len(cdata) >= len(block):  # incompressible-block escape
            cdata = filtered.tobytes()
        streams.append(struct.pack("<i", len(cdata)) + cdata)

    bstarts = []
    off = 16 + 4 * nblocks
    for s in streams:
        bstarts.append(off)
        off += len(s)
    cbytes = off
    if cbytes >= nbytes + 16:
        # whole-chunk memcpy mode beats the compressed form
        return _header(shuffle, typesize, nbytes, blocksize, nbytes + 16,
                       memcpy=True) + raw
    return b"".join(
        [_header(shuffle, typesize, nbytes, blocksize, cbytes)]
        + [struct.pack("<i", b) for b in bstarts]
        + streams
    )


def _header(shuffle, typesize, nbytes, blocksize, cbytes, memcpy=False):
    flags = _CODE_ZSTD << 5
    if shuffle == SHUFFLE:
        flags |= _FLAG_BYTE_SHUFFLE
    elif shuffle == BITSHUFFLE:
        flags |= _FLAG_BIT_SHUFFLE
    if memcpy:
        flags |= _FLAG_MEMCPY
    return struct.pack(
        "<BBBBiii",
        BLOSC_VERSION_FORMAT,
        BLOSC_ZSTD_VERSION_FORMAT,
        flags,
        typesize,
        nbytes,
        blocksize,
        cbytes,
    )


def decompress(chunk: bytes) -> bytes:
    """Decode one c-blosc1 chunk (zstd streams; any shuffle mode)."""
    if len(chunk) < 16:
        raise ValueError("truncated blosc header")
    version, _, flags, typesize, nbytes, blocksize, cbytes = struct.unpack(
        "<BBBBiii", chunk[:16]
    )
    if version < 1:
        raise ValueError(f"bad blosc version byte {version}")
    if len(chunk) < cbytes:
        raise ValueError("truncated blosc chunk")
    if flags & _FLAG_MEMCPY:
        return bytes(chunk[16 : 16 + nbytes])
    code = flags >> 5
    if code != _CODE_ZSTD:
        raise ValueError(f"unsupported blosc inner compressor code {code}")
    if _zstd is None:  # pragma: no cover
        raise RuntimeError("blosc codec needs the zstandard module")
    nblocks = (nbytes + blocksize - 1) // blocksize
    bstarts = struct.unpack_from(f"<{nblocks}i", chunk, 16)
    dec = _zstd.ZstdDecompressor()
    out = np.empty(nbytes, np.uint8)
    for i, start in enumerate(bstarts):
        neblock = min(blocksize, nbytes - i * blocksize)
        (csize,) = struct.unpack_from("<i", chunk, start)
        stream = chunk[start + 4 : start + 4 + csize]
        filtered = stream if csize == neblock else dec.decompress(
            stream, max_output_size=neblock
        )
        block = np.frombuffer(filtered, np.uint8)
        if flags & _FLAG_BIT_SHUFFLE:
            block = _bit_unshuffle(block, typesize)
        elif flags & _FLAG_BYTE_SHUFFLE:
            block = _byte_unshuffle(block, typesize)
        out[i * blocksize : i * blocksize + neblock] = block
    return out.tobytes()
