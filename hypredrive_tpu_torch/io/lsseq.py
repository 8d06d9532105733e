"""lsseq — single-file container for a *sequence* of linear systems.

Byte-layout parity with the reference container (ref: include/internal/
lsseq.h; readers/writers src/internal/lsseq.c):

  LSSeqHeader   magic "HDRVLSQ1", version 1, flags, codec,
                num_systems/parts/patterns/timesteps + section offsets
  Info block    magic "HDRVINF1": UTF-8 key=value manifest with FNV-1a
                hashes of payload and blob region
  PartMeta      row ranges / index+value widths per part
  PatternMeta   deduplicated sparsity patterns (rows/cols blobs) —
                systems sharing a pattern reference one pattern_id
                (= one XLA compilation per pattern downstream)
  SysPartMeta   per (system, part): values/rhs/dofmap blobs
  Timesteps     optional (timestep, ls_start) table feeding precon reuse

Blobs are compressed with the header codec (none/zlib/zstd here).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from ..core.errors import HypredrvError, ErrorCode
from . import comp

LSSEQ_MAGIC = 0x3151534C56445248  # "HDRVLSQ1"
LSSEQ_INFO_MAGIC = 0x31464E4956524448  # "HDRVINF1"
LSSEQ_VERSION = 1
INFO_VERSION = 1
ENDIAN_TAG = 0x01020304

FLAG_HAS_DOFMAP = 1 << 0
FLAG_HAS_TIMESTEPS = 1 << 1
FLAG_HAS_INFO = 1 << 2
INFO_FLAG_PAYLOAD_KV = 1 << 0

_HDR = struct.Struct("<Q7I4x6Q")          # LSSeqHeader (88 bytes)
_INFO = struct.Struct("<Q4I4Q")           # LSSeqInfoHeader (56 bytes)
_PART = struct.Struct("<5Q")              # LSSeqPartMeta (40)
_PATTERN = struct.Struct("<2I5Q")         # LSSeqPatternMeta (48)
_SYSPART = struct.Struct("<2I8Q")         # LSSeqSystemPartMeta (72)
_TIMESTEP = struct.Struct("<2i")          # LSSeqTimestepEntry (8)


def fnv1a64(data: bytes) -> int:
    h = 0xCBF29CE484222325
    for b in data:
        h ^= b
        h = (h * 0x100000001B3) & 0xFFFFFFFFFFFFFFFF
    return h


def _fnv1a64_np(data: bytes) -> int:
    """FNV-1a is inherently sequential; the native C extension will take
    this over for large blobs (see native/)."""
    return fnv1a64(data)


@dataclass
class LSSeqSummary:
    num_systems: int
    num_parts: int
    num_patterns: int
    num_timesteps: int
    codec: int
    has_dofmap: bool
    has_timesteps: bool


# ---------------------------------------------------------------------------
# writer
# ---------------------------------------------------------------------------

def write_lsseq(filename: str, systems: List[dict], codec: int = comp.COMP_ZLIB,
                info: Optional[Dict[str, str]] = None,
                timesteps: Optional[List[Tuple[int, int]]] = None,
                n_parts: int = 1):
    """systems: list of dicts {"A": csr, "b": array, "dofmap": optional}.

    All systems must share the global shape; sparsity patterns are
    deduplicated across systems (ref: LSSeqPatternMeta).
    """
    if not systems:
        raise HypredrvError("lsseq: no systems to write", ErrorCode.INVALID_ARG)
    from ..ops.csr import row_partition

    n = systems[0]["A"].shape[0]
    offsets = row_partition(n, n_parts)
    has_dof = any(s.get("dofmap") is not None for s in systems)

    # split each system into parts (COO per part)
    def part_coo(A, p):
        lo, hi = int(offsets[p]), int(offsets[p + 1])
        sub = sp.csr_matrix(A[lo:hi])
        sub.sort_indices()
        coo = sub.tocoo()
        return (coo.row + lo).astype(np.int64), coo.col.astype(np.int64), \
            coo.data.astype(np.float64)

    blob = bytearray()

    def add_blob(raw: bytes) -> Tuple[int, int]:
        cdata = comp.compress(codec, raw)
        off = len(blob)
        blob.extend(cdata)
        return off, len(cdata)

    # dedup patterns per part
    patterns: List[dict] = []
    pattern_ids: Dict[Tuple[int, bytes], int] = {}
    sys_parts = []  # [sys][part] dict
    for s in systems:
        row = []
        for p in range(n_parts):
            rows, cols, vals = part_coo(s["A"], p)
            key = (p, rows.tobytes() + b"|" + cols.tobytes())
            if key not in pattern_ids:
                r_off, r_size = add_blob(rows.tobytes())
                c_off, c_size = add_blob(cols.tobytes())
                pattern_ids[key] = len(patterns)
                patterns.append(dict(part_id=p, nnz=len(vals),
                                     rows_off=r_off, rows_size=r_size,
                                     cols_off=c_off, cols_size=c_size))
            pid = pattern_ids[key]
            v_off, v_size = add_blob(vals.tobytes())
            lo, hi = int(offsets[p]), int(offsets[p + 1])
            rhs = np.asarray(s["b"][lo:hi], dtype=np.float64)
            b_off, b_size = add_blob(rhs.tobytes())
            if s.get("dofmap") is not None:
                dof = np.asarray(s["dofmap"][lo:hi], dtype=np.int32)
                d_off, d_size = add_blob(dof.tobytes())
                d_n = len(dof)
            else:
                d_off = d_size = d_n = 0
            row.append(dict(pattern_id=pid, nnz=len(vals),
                            v_off=v_off, v_size=v_size,
                            b_off=b_off, b_size=b_size,
                            d_off=d_off, d_size=d_size, d_n=d_n))
        sys_parts.append(row)

    # info payload
    info = dict(info or {})
    info.setdefault("writer", "hypredrive_tpu_torch")
    info.setdefault("num_systems", str(len(systems)))
    info.setdefault("global_nrows", str(n))
    payload = "".join(f"{k}={v}\n" for k, v in info.items()).encode()

    flags = FLAG_HAS_INFO
    if has_dof:
        flags |= FLAG_HAS_DOFMAP
    if timesteps:
        flags |= FLAG_HAS_TIMESTEPS

    # layout
    pos = _HDR.size
    info_pos = pos
    pos += _INFO.size + len(payload)
    part_meta_pos = pos
    pos += _PART.size * n_parts
    pattern_meta_pos = pos
    pos += _PATTERN.size * len(patterns)
    sys_part_pos = pos
    pos += _SYSPART.size * len(systems) * n_parts
    ts_pos = pos
    pos += _TIMESTEP.size * len(timesteps or [])
    blob_pos = pos

    blob_bytes = bytes(blob)
    header = _HDR.pack(
        LSSEQ_MAGIC, LSSEQ_VERSION, flags, codec, len(systems), n_parts,
        len(patterns), len(timesteps or []),
        part_meta_pos, pattern_meta_pos, sys_part_pos, ts_pos, blob_pos, 0)
    info_hdr = _INFO.pack(
        LSSEQ_INFO_MAGIC, INFO_VERSION, INFO_FLAG_PAYLOAD_KV, ENDIAN_TAG, 0,
        len(payload), _fnv1a64_np(payload), _fnv1a64_np(blob_bytes),
        len(blob_bytes))

    with open(filename, "wb") as f:
        f.write(header)
        f.write(info_hdr)
        f.write(payload)
        for p in range(n_parts):
            f.write(_PART.pack(int(offsets[p]), int(offsets[p + 1]) - 1,
                               int(offsets[p + 1] - offsets[p]), 8, 8))
        for pt in patterns:
            f.write(_PATTERN.pack(pt["part_id"], 0, pt["nnz"],
                                  pt["rows_off"], pt["rows_size"],
                                  pt["cols_off"], pt["cols_size"]))
        for row in sys_parts:
            for m in row:
                f.write(_SYSPART.pack(m["pattern_id"], 0, m["nnz"],
                                      m["v_off"], m["v_size"],
                                      m["b_off"], m["b_size"],
                                      m["d_off"], m["d_size"], m["d_n"]))
        for ts, start in (timesteps or []):
            f.write(_TIMESTEP.pack(ts, start))
        f.write(blob_bytes)


# ---------------------------------------------------------------------------
# reader
# ---------------------------------------------------------------------------

def _typed_frombuffer(buf: bytes, dtype):
    """np.frombuffer with the fuzz contract: a blob whose size is not a
    multiple of the element size raises the typed IO error."""
    if len(buf) % np.dtype(dtype).itemsize:
        raise HypredrvError(
            f"lsseq blob size {len(buf)} not a multiple of "
            f"{np.dtype(dtype).itemsize}", ErrorCode.IO)
    return np.frombuffer(buf, dtype=dtype)


class LSSeqFile:
    def __init__(self, filename: str):
        self.filename = filename
        with open(filename, "rb") as f:
            raw = f.read()
        self.raw = raw
        if len(raw) < _HDR.size:
            raise HypredrvError(f"truncated lsseq file {filename}",
                                ErrorCode.IO)
        (magic, version, self.flags, self.codec, self.num_systems,
         self.num_parts, self.num_patterns, self.num_timesteps,
         self.off_part, self.off_pattern, self.off_syspart, self.off_ts,
         self.off_blob, self.off_blob_table) = _HDR.unpack_from(raw, 0)
        if magic != LSSEQ_MAGIC:
            raise HypredrvError(
                f"bad lsseq magic in {filename}", ErrorCode.IO)
        if version != LSSEQ_VERSION:
            raise HypredrvError(
                f"unsupported lsseq version {version}", ErrorCode.IO)

        # info block
        self.info: Dict[str, str] = {}
        if self.flags & FLAG_HAS_INFO:
            if len(raw) < _HDR.size + _INFO.size:
                raise HypredrvError(
                    f"truncated lsseq info block in {filename}",
                    ErrorCode.IO)
            (im, iv, ifl, endian, _res, psize, phash, bhash, bbytes) = \
                _INFO.unpack_from(raw, _HDR.size)
            if im != LSSEQ_INFO_MAGIC or endian != ENDIAN_TAG:
                raise HypredrvError("bad lsseq info block", ErrorCode.IO)
            payload = raw[_HDR.size + _INFO.size:
                          _HDR.size + _INFO.size + psize]
            if _fnv1a64_np(payload) != phash:
                raise HypredrvError("lsseq info payload hash mismatch",
                                    ErrorCode.IO)
            for line in payload.decode().splitlines():
                if "=" in line:
                    k, v = line.split("=", 1)
                    self.info[k] = v

        # validate every advertised table against the actual file size
        # BEFORE unpacking (fuzz contract: corrupt counts/offsets raise
        # the typed IO error, never struct.error or a giant allocation;
        # ref: lsseq.c header validation)
        total = len(raw)
        tables = (
            ("part", self.off_part, self.num_parts, _PART.size),
            ("pattern", self.off_pattern, self.num_patterns,
             _PATTERN.size),
            ("syspart", self.off_syspart,
             self.num_systems * self.num_parts, _SYSPART.size),
            ("timestep", self.off_ts, self.num_timesteps,
             _TIMESTEP.size),
        )
        for name, off, cnt, sz in tables:
            if not (0 <= cnt <= total and 0 <= off <= total
                    and off + cnt * sz <= total):
                raise HypredrvError(
                    f"lsseq {name} table out of bounds in {filename} "
                    f"(offset {off}, count {cnt})", ErrorCode.IO)
        try:
            self.parts = [
                _PART.unpack_from(raw, self.off_part + i * _PART.size)
                for i in range(self.num_parts)]
            self.patterns = [
                _PATTERN.unpack_from(raw,
                                     self.off_pattern + i * _PATTERN.size)
                for i in range(self.num_patterns)]
            self.sys_parts = [
                [_SYSPART.unpack_from(
                    raw, self.off_syspart
                    + (s * self.num_parts + p) * _SYSPART.size)
                 for p in range(self.num_parts)]
                for s in range(self.num_systems)]
            self.timesteps = [
                _TIMESTEP.unpack_from(raw, self.off_ts + i * _TIMESTEP.size)
                for i in range(self.num_timesteps)]
        except struct.error as e:
            raise HypredrvError(f"corrupt lsseq tables in {filename}: {e}",
                                ErrorCode.IO)

    def _blob(self, off: int, size: int) -> bytes:
        if off < 0 or size < 0 or \
                self.off_blob + off + size > len(self.raw):
            raise HypredrvError("lsseq blob out of bounds", ErrorCode.IO)
        data = self.raw[self.off_blob + off:self.off_blob + off + size]
        return comp.decompress(self.codec, data)

    def summary(self) -> LSSeqSummary:
        return LSSeqSummary(
            num_systems=self.num_systems, num_parts=self.num_parts,
            num_patterns=self.num_patterns, num_timesteps=self.num_timesteps,
            codec=self.codec,
            has_dofmap=bool(self.flags & FLAG_HAS_DOFMAP),
            has_timesteps=bool(self.flags & FLAG_HAS_TIMESTEPS))

    def pattern_id(self, ls_id: int, part: int = 0) -> int:
        return self.sys_parts[ls_id][part][0]

    def read_matrix(self, ls_id: int) -> sp.csr_matrix:
        if not 0 <= ls_id < self.num_systems:
            raise HypredrvError(f"lsseq: system {ls_id} out of range",
                                ErrorCode.INVALID_ARG)
        if not self.parts:
            raise HypredrvError("lsseq has no part table", ErrorCode.IO)
        nrows = max(int(p[1]) for p in self.parts) + 1
        # Bound with the same allocation guard the IJ readers use — the
        # CSR indptr alone is 8*(nrows+1) bytes, so a crafted part table
        # must not be able to force a multi-GB allocation.
        from .ij import _check_dims
        _check_dims(nrows, nrows, "<lsseq>", ErrorCode.IO)
        all_r, all_c, all_v = [], [], []
        for p in range(self.num_parts):
            (pid, _fl, nnz, v_off, v_size, *_rest) = self.sys_parts[ls_id][p]
            if not 0 <= pid < self.num_patterns:
                raise HypredrvError(
                    f"lsseq pattern id {pid} out of range", ErrorCode.IO)
            pat = self.patterns[pid]
            rows = _typed_frombuffer(self._blob(pat[3], pat[4]), np.int64)
            cols = _typed_frombuffer(self._blob(pat[5], pat[6]), np.int64)
            vals = _typed_frombuffer(self._blob(v_off, v_size), np.float64)
            if len(rows) != len(cols) or len(rows) != len(vals):
                raise HypredrvError(
                    "lsseq pattern/value blob lengths disagree",
                    ErrorCode.IO)
            if len(rows) and (rows.min() < 0 or cols.min() < 0
                              or rows.max() >= nrows
                              or cols.max() >= nrows):
                raise HypredrvError(
                    "lsseq matrix entry out of bounds", ErrorCode.IO)
            all_r.append(rows)
            all_c.append(cols)
            all_v.append(vals)
        A = sp.coo_matrix(
            (np.concatenate(all_v),
             (np.concatenate(all_r), np.concatenate(all_c))),
            shape=(nrows, nrows)).tocsr()
        A.sort_indices()
        return A

    def read_rhs(self, ls_id: int) -> np.ndarray:
        out = []
        for p in range(self.num_parts):
            m = self.sys_parts[ls_id][p]
            out.append(_typed_frombuffer(self._blob(m[5], m[6]),
                                         np.float64))
        return np.concatenate(out)

    def read_dofmap(self, ls_id: int) -> Optional[np.ndarray]:
        if not (self.flags & FLAG_HAS_DOFMAP):
            return None
        out = []
        for p in range(self.num_parts):
            m = self.sys_parts[ls_id][p]
            if m[9] == 0:
                return None
            out.append(_typed_frombuffer(self._blob(m[7], m[8]),
                                         np.int32))
        return np.concatenate(out).astype(np.int64)

    def read_timesteps(self) -> List[Tuple[int, int]]:
        return [(int(t), int(s)) for t, s in self.timesteps]


def read_summary(filename: str) -> LSSeqSummary:
    return LSSeqFile(filename).summary()
