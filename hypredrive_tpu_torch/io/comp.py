"""Compression codecs behind one API.

A copy of ``hypredrive_tpu/io/comp.py``; the LZ4 codec runs in the port's
native helper library (``io/native.py``), and ``zstandard`` is imported
only when a zstd blob is met, so its absence raises the typed
NOT_IMPLEMENTED error instead of failing at import.  Reference: src/internal/comp.c — zlib/zstd/lz4/lz4hc/blosc selected by id
or file extension.  Byte-format parity: every codec except ``none``
prefixes the compressed block with the uint64 original size, exactly as
``hypredrv_compress`` does (ref: comp.c:391-497), so containers written
by the reference decode here and vice versa.  lz4/lz4hc use the raw LZ4
block format via the native C++ codec (native/src/ij_io.cpp
hdrv_lz4_{compress,decompress}; clean-room implementation of the block
spec) with a pure-Python decoder fallback; blosc is a clean-room blosc1
chunk codec (see the blosc section below).
"""

from __future__ import annotations

import struct
import zlib

from ..core.errors import HypredrvError, ErrorCode

COMP_NONE = 0
COMP_ZLIB = 1
COMP_ZSTD = 2
COMP_LZ4 = 3
COMP_LZ4HC = 4
COMP_BLOSC = 5

_NAMES = {COMP_NONE: "none", COMP_ZLIB: "zlib", COMP_ZSTD: "zstd",
          COMP_LZ4: "lz4", COMP_LZ4HC: "lz4hc", COMP_BLOSC: "blosc"}
_EXTS = {"zz": COMP_ZLIB, "gz": COMP_ZLIB, "zst": COMP_ZSTD,
         "lz4": COMP_LZ4, "lz4hc": COMP_LZ4HC, "blosc": COMP_BLOSC}

_SIZE = struct.Struct("<Q")        # uint64 original-size prefix


def _max_decompressed_bytes() -> int:
    """Decompression cap against malicious size prefixes (CWE-789);
    ref: comp.c:36 HYPREDRV_MAX_DECOMPRESSED_BYTES (16 GiB default)."""
    import os

    return int(os.environ.get("HYPREDRV_MAX_DECOMPRESSED_BYTES", 16 << 30))


def codec_name(codec: int) -> str:
    return _NAMES.get(codec, f"unknown({codec})")


def codec_from_name(name: str) -> int:
    for k, v in _NAMES.items():
        if v == name.strip().lower():
            return k
    raise HypredrvError(f"unknown codec '{name}'", ErrorCode.INVALID_VAL)


def codec_from_filename(filename: str) -> int:
    # the reference's suffixes are ".lz4hc.bin" etc (comp.c:97-135)
    low = filename.lower()
    for ext, codec in sorted(_EXTS.items(), key=lambda kv: -len(kv[0])):
        if low.endswith(f".{ext}.bin") or low.endswith(f".{ext}"):
            return codec
    return COMP_NONE


# -- raw LZ4 block codec ------------------------------------------------------

def _lz4_native():
    try:
        from .native import get_lib

        lib = get_lib()
        if lib is not None and hasattr(lib, "hdrv_lz4_compress"):
            return lib
    except Exception:
        pass
    return None


def _lz4_block_compress(data: bytes) -> bytes:
    lib = _lz4_native()
    import numpy as np

    if lib is not None:
        import ctypes

        src = np.frombuffer(data, np.uint8)
        cap = len(data) + len(data) // 255 + 64
        dst = np.empty(cap, np.uint8)
        m = lib.hdrv_lz4_compress(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(data),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), cap)
        if m > 0:
            return dst[:m].tobytes()
    # fallback: literal-only sequences (valid LZ4, no compression)
    out = bytearray()
    n = len(data)
    lit = n
    token = min(lit, 15) << 4
    out.append(token)
    if lit >= 15:
        rest = lit - 15
        while rest >= 255:
            out.append(255)
            rest -= 255
        out.append(rest)
    out += data
    return bytes(out)


def _lz4_block_decompress(data: bytes, orig_size: int) -> bytes:
    lib = _lz4_native()
    import numpy as np

    if lib is not None:
        import ctypes

        src = np.frombuffer(data, np.uint8)
        dst = np.empty(max(1, orig_size), np.uint8)
        m = lib.hdrv_lz4_decompress(
            src.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), len(data),
            dst.ctypes.data_as(ctypes.POINTER(ctypes.c_int8)), orig_size)
        if m != orig_size:
            raise HypredrvError("malformed LZ4 block", ErrorCode.IO)
        return dst[:m].tobytes()
    # pure-Python safe decoder (correctness fallback)
    out = bytearray()
    ip, n = 0, len(data)
    while ip < n:
        token = data[ip]; ip += 1
        lit = token >> 4
        if lit == 15:
            while True:
                b = data[ip]; ip += 1
                lit += b
                if b != 255:
                    break
        out += data[ip:ip + lit]; ip += lit
        if ip >= n:
            break
        offset = data[ip] | (data[ip + 1] << 8); ip += 2
        mlen = (token & 15) + 4
        if (token & 15) == 15:
            while True:
                b = data[ip]; ip += 1
                mlen += b
                if b != 255:
                    break
        if offset == 0 or offset > len(out):
            raise HypredrvError("malformed LZ4 block", ErrorCode.IO)
        for _ in range(mlen):
            out.append(out[-offset])
    if len(out) != orig_size:
        raise HypredrvError("LZ4 size mismatch", ErrorCode.IO)
    return bytes(out)


# -- blosc1 chunk codec (clean-room) -----------------------------------------
#
# The reference compresses blobs with c-blosc1: blosc_set_compressor
# ("blosclz") + blosc_compress(clevel=9, doshuffle=1, typesize=1, ...)
# (ref: src/internal/comp.c:345-385).  typesize=1 makes the shuffle a
# no-op and every block a single split, so the chunk format reduces to
#
#   16-byte header: version(1) cversion(1) flags(1) typesize(1)
#                   nbytes(u32le) blocksize(u32le) cbytes(u32le)
#   flags: 0x1 byte-shuffle, 0x2 memcpyed, 0x4 bit-shuffle,
#          bits 5-7 inner codec (0=blosclz 1=lz4 3=zlib 4=zstd)
#   then (unless memcpyed): u32le bstarts[nblocks] — absolute offsets of
#   each block — and per block split: [i32le csize][payload]; a split
#   whose csize equals its uncompressed size is stored raw.
#
# Implemented from the published container format, not from blosc code.
# Decode accepts blosclz / lz4 / zlib / zstd inner streams and undoes the
# byte shuffle, so reference-written .blosc.bin blobs read back here;
# encode emits LZ4-inner chunks (every stock c-blosc build bundles LZ4),
# so blobs written here read back in the reference.

_BLOSC_VERSION_FORMAT = 2
_BLOSC_MAX_DISTANCE = 8191
_BLOSC_MIN_BUFFERSIZE = 128
_BLOSC_MAX_SPLITS = 16
_BLOSC_CODEC_BLOSCLZ = 0
_BLOSC_CODEC_LZ4 = 1
_BLOSC_CODEC_ZLIB = 3
_BLOSC_CODEC_ZSTD = 4


def _blosclz_decompress(src: bytes, orig_size: int) -> bytes:
    """Decode one blosclz 1.x stream (LZ77 with 5-bit offsets-hi/3-bit
    length control bytes; format per c-blosc1's container spec)."""
    out = bytearray()
    ip, n = 0, len(src)
    if n == 0:
        return bytes(out)
    ctrl = src[ip] & 31
    ip += 1
    loop = True
    while loop:
        if ctrl >= 32:
            length = (ctrl >> 5) - 1
            ofs = (ctrl & 31) << 8
            ref = len(out) - ofs
            if length == 6:          # 7 - 1: extended length
                while True:
                    code = src[ip]; ip += 1
                    length += code
                    if code != 255:
                        break
            code = src[ip]; ip += 1
            ref -= code
            if code == 255 and ofs == (31 << 8):
                ofs = (src[ip] << 8) | src[ip + 1]; ip += 2
                ref = len(out) - ofs - _BLOSC_MAX_DISTANCE
            if ip < n:
                ctrl = src[ip]; ip += 1
            else:
                loop = False
            length += 3
            if ref == len(out):      # RLE run of the previous byte
                if not out:
                    raise HypredrvError("malformed blosclz stream",
                                        ErrorCode.IO)
                out += bytes([out[-1]]) * length
            else:
                ref -= 1
                if ref < 0:
                    raise HypredrvError("malformed blosclz stream",
                                        ErrorCode.IO)
                if ref + length <= len(out):
                    out += out[ref:ref + length]      # no overlap: slice
                else:
                    for _ in range(length):           # overlapping copy
                        out.append(out[ref]); ref += 1
        else:
            ctrl += 1
            if ip + ctrl > n:
                raise HypredrvError("truncated blosclz stream",
                                    ErrorCode.IO)
            out += src[ip:ip + ctrl]
            ip += ctrl
            loop = ip < n
            if loop:
                ctrl = src[ip]; ip += 1
        if len(out) > orig_size:
            raise HypredrvError("blosclz overrun", ErrorCode.IO)
    return bytes(out)


def _blosclz_compress(data: bytes) -> bytes:
    """Minimal greedy blosclz 1.x encoder (hash-table match finder).

    Used for self-validation of the decoder and as an inner-codec
    option; emits only short-distance matches (<= 8191+255)."""
    n = len(data)
    out = bytearray()
    if n == 0:
        return bytes(out)
    htab = {}
    anchor = 0
    ip = 0

    def emit_literals(lo, hi):
        while lo < hi:
            run = min(32, hi - lo)
            out.append(run - 1)
            out.extend(data[lo:lo + run])
            lo += run

    while ip + 4 <= n:
        key = data[ip:ip + 3]
        ref = htab.get(key, -1)
        htab[key] = ip
        dist = ip - ref - 1
        # dist < 8190 keeps (hi, lo) clear of the (31, 255) long-
        # distance escape, so the short encoding is always unambiguous
        if 0 <= ref and dist < _BLOSC_MAX_DISTANCE - 1 and ip > 0:
            length = 3
            maxl = n - ip
            while length < maxl and data[ref + length] == data[ip + length] \
                    and length < 3 + 6 + 255 * 8:
                length += 1
            emit_literals(anchor, ip)
            l = length - 3          # encoded length
            if l < 6:
                out.append(((l + 1) << 5) | (dist >> 8))
            else:
                out.append((7 << 5) | (dist >> 8))
                rest = l - 6
                while rest >= 255:
                    out.append(255)
                    rest -= 255
                out.append(rest)
            out.append(dist & 0xFF)
            ip += length
            anchor = ip
        else:
            ip += 1
    emit_literals(anchor, n)
    return bytes(out)


def _byte_unshuffle(data: bytes, typesize: int) -> bytes:
    import numpy as np

    nb = len(data)
    main = (nb // typesize) * typesize
    arr = np.frombuffer(data[:main], np.uint8).reshape(typesize, -1)
    out = arr.T.reshape(-1).tobytes()
    return out + data[main:]


def _byte_shuffle(data: bytes, typesize: int) -> bytes:
    import numpy as np

    nb = len(data)
    main = (nb // typesize) * typesize
    arr = np.frombuffer(data[:main], np.uint8).reshape(-1, typesize)
    return arr.T.reshape(-1).tobytes() + data[main:]


def _blosc_split(codec: int, typesize: int, blocksize: int) -> bool:
    return (codec in (_BLOSC_CODEC_BLOSCLZ, _BLOSC_CODEC_LZ4)
            and typesize <= _BLOSC_MAX_SPLITS
            and blocksize // max(1, typesize) >= _BLOSC_MIN_BUFFERSIZE)


def _blosc_inner_decompress(codec: int, payload: bytes, osize: int) -> bytes:
    if codec == _BLOSC_CODEC_BLOSCLZ:
        return _blosclz_decompress(payload, osize)
    if codec == _BLOSC_CODEC_LZ4:
        return _lz4_block_decompress(payload, osize)
    if codec == _BLOSC_CODEC_ZLIB:
        return zlib.decompress(payload)
    if codec == _BLOSC_CODEC_ZSTD:
        import zstandard

        return zstandard.ZstdDecompressor().decompress(
            payload, max_output_size=max(1, osize))
    raise HypredrvError(f"blosc inner codec {codec} not supported",
                        ErrorCode.NOT_IMPLEMENTED)


def blosc_decompress(frame: bytes, orig_size: int) -> bytes:
    """Decode one blosc1 chunk (any inner codec above, byte-shuffle ok)."""
    if len(frame) < 16:
        raise HypredrvError("blosc chunk too short", ErrorCode.IO)
    flags, typesize = frame[2], frame[3]
    nbytes = int.from_bytes(frame[4:8], "little")
    blocksize = int.from_bytes(frame[8:12], "little")
    cbytes = int.from_bytes(frame[12:16], "little")
    if nbytes != orig_size or cbytes > len(frame):
        raise HypredrvError("blosc chunk header mismatch", ErrorCode.IO)
    if flags & 0x4:
        raise HypredrvError("blosc bit-shuffle not supported",
                            ErrorCode.NOT_IMPLEMENTED)
    if flags & 0x2:                              # memcpyed
        return bytes(frame[16:16 + nbytes])
    if nbytes == 0:
        return b""
    codec = flags >> 5
    if blocksize <= 0:
        raise HypredrvError("blosc blocksize invalid", ErrorCode.IO)
    nblocks = -(-nbytes // blocksize)
    # Every block needs an in-frame bstarts entry plus at least a 4-byte
    # split header, which bounds nblocks by the actual frame size — a tiny
    # chunk advertising huge nbytes with blocksize=1 must not drive a
    # multi-billion-entry loop (hang/OOM from a few bytes of input).
    table_end = 16 + 4 * nblocks
    if table_end > len(frame):
        raise HypredrvError("blosc chunk header mismatch", ErrorCode.IO)
    bstarts = [int.from_bytes(frame[16 + 4 * j:20 + 4 * j], "little")
               for j in range(nblocks)]
    # Block offsets must point past the bstarts table and into the chunk;
    # an offset of e.g. 0 would parse header bytes as split data.
    for bs in bstarts:
        if bs < table_end or bs >= max(cbytes, table_end + 1):
            raise HypredrvError("blosc block offset invalid", ErrorCode.IO)
    out = bytearray()
    for j in range(nblocks):
        neblock = min(blocksize, nbytes - j * blocksize)
        leftover = neblock != blocksize
        nsplits = typesize if (_blosc_split(codec, typesize, blocksize)
                               and not leftover) else 1
        pos = bstarts[j]
        nsb = neblock // nsplits
        block = bytearray()
        for _ in range(nsplits):
            if pos + 4 > len(frame):
                raise HypredrvError("blosc block truncated", ErrorCode.IO)
            csize = int.from_bytes(frame[pos:pos + 4], "little",
                                   signed=True)
            pos += 4
            if csize < 0 or pos + csize > len(frame):
                raise HypredrvError("blosc block truncated", ErrorCode.IO)
            payload = frame[pos:pos + csize]
            pos += csize
            if csize == nsb:
                block += payload                 # stored raw
            else:
                block += _blosc_inner_decompress(codec, payload, nsb)
        if len(block) != neblock:
            raise HypredrvError("blosc block size mismatch", ErrorCode.IO)
        if (flags & 0x1) and typesize > 1 and not leftover:
            block = bytearray(_byte_unshuffle(bytes(block), typesize))
        out += block
    if len(out) != nbytes:
        raise HypredrvError("blosc chunk size mismatch", ErrorCode.IO)
    return bytes(out)


def blosc_compress(data: bytes, inner: int = _BLOSC_CODEC_LZ4) -> bytes:
    """Encode one blosc1 chunk with typesize 1 (the reference's own
    setting) and the given inner codec; falls back to a memcpyed chunk
    when compression does not pay."""
    nbytes = len(data)
    typesize = 1

    def header(flags, blocksize, cbytes):
        return bytes([
            _BLOSC_VERSION_FORMAT, 1, flags, typesize,
        ]) + nbytes.to_bytes(4, "little") + \
            blocksize.to_bytes(4, "little") + cbytes.to_bytes(4, "little")

    def memcpyed():
        return header(0x2, min(nbytes, 1 << 16) or 1, 16 + nbytes) + data

    if nbytes == 0:
        return header(0x2, 1, 16)
    blocksize = min(nbytes, 1 << 16)
    nblocks = -(-nbytes // blocksize)
    bstarts = []
    blobs = []
    pos = 16 + 4 * nblocks
    for j in range(nblocks):
        neblock = min(blocksize, nbytes - j * blocksize)
        chunk = data[j * blocksize:j * blocksize + neblock]
        if inner == _BLOSC_CODEC_BLOSCLZ:
            comp = _blosclz_compress(chunk)
        else:
            comp = _lz4_block_compress(chunk)
        if len(comp) >= neblock:
            blob = neblock.to_bytes(4, "little", signed=True) + chunk
        else:
            blob = len(comp).to_bytes(4, "little", signed=True) + comp
        bstarts.append(pos)
        blobs.append(blob)
        pos += len(blob)
    if pos >= 16 + nbytes:
        return memcpyed()
    flags = inner << 5
    return header(flags, blocksize, pos) + \
        b"".join(b.to_bytes(4, "little") for b in bstarts) + b"".join(blobs)


# -- public API ---------------------------------------------------------------

def compress(codec: int, data: bytes, level: int = -1) -> bytes:
    if codec == COMP_NONE:
        return bytes(data)
    prefix = _SIZE.pack(len(data))
    if codec == COMP_ZLIB:
        return prefix + zlib.compress(data, 6 if level < 0 else level)
    if codec == COMP_ZSTD:
        try:
            import zstandard

            return prefix + zstandard.ZstdCompressor(
                level=5 if level < 0 else level).compress(data)
        except ImportError:
            raise HypredrvError("zstandard not available",
                                ErrorCode.NOT_IMPLEMENTED)
    if codec in (COMP_LZ4, COMP_LZ4HC):
        # lz4hc emits the same block format (only the encoder effort
        # differs); one encoder serves both ids (ref: comp.c:258-340)
        return prefix + _lz4_block_compress(data)
    if codec == COMP_BLOSC:
        return prefix + blosc_compress(data)
    raise HypredrvError(f"unknown codec {codec}", ErrorCode.INVALID_VAL)


def decompress(codec: int, data: bytes) -> bytes:
    if codec == COMP_NONE:
        return bytes(data)
    if len(data) < _SIZE.size:
        raise HypredrvError("compressed blob too short", ErrorCode.IO)
    (orig_size,) = _SIZE.unpack_from(data)
    if orig_size > _max_decompressed_bytes():
        # mirror the reference's decompressed-size cap against malicious
        # headers (ref: comp.c:36 HYPREDRV_MAX_DECOMPRESSED_BYTES)
        raise HypredrvError(
            f"blob advertises {orig_size} decompressed bytes "
            f"(cap {_max_decompressed_bytes()})", ErrorCode.IO)
    body = bytes(data[_SIZE.size:])
    try:
        if codec == COMP_ZLIB:
            out = zlib.decompress(body)
        elif codec == COMP_ZSTD:
            try:
                import zstandard

                out = zstandard.ZstdDecompressor().decompress(
                    body, max_output_size=max(1, orig_size))
            except ImportError:
                raise HypredrvError("zstandard not available",
                                    ErrorCode.NOT_IMPLEMENTED)
        elif codec in (COMP_LZ4, COMP_LZ4HC):
            out = _lz4_block_decompress(body, orig_size)
        elif codec == COMP_BLOSC:
            out = blosc_decompress(body, orig_size)
        else:
            raise HypredrvError(
                f"codec {codec_name(codec)} not available in this build",
                ErrorCode.NOT_IMPLEMENTED)
    except HypredrvError:
        raise
    except Exception as e:
        # zlib.error / zstandard.ZstdError / struct noise from corrupt
        # streams all surface as the typed IO error (fuzz contract: a
        # malformed blob never escapes untyped)
        raise HypredrvError(
            f"corrupt {codec_name(codec)} stream: {e}", ErrorCode.IO)
    if len(out) != orig_size:
        raise HypredrvError(
            f"decompressed size mismatch ({len(out)} vs {orig_size})",
            ErrorCode.IO)
    return out
