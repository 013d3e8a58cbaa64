"""OpenNI 1.x recording (.oni) container: pure-Python reader + writer
(a copy of ``slambench_tpu/io/oni.py``; the port imports nothing of the
JAX package).

The reference converts Kinect recordings with ``oni2raw`` by linking the
OpenNI runtime and replaying the file through ``xn::Player``
(reference: kfusion/thirdparty/oni2raw.cpp:76-255). The benchmark's hosts
have no OpenNI stack, so this module parses the container directly: the .oni
file is a flat stream of little-endian records (OpenNI 1.x
``DataRecords`` layout) — a file header (magic ``NI10``), node-creation
records carrying each stream's name/type/codec, property records
(resolution, etc.), and per-frame ``NEW_DATA`` records whose payload is
the frame image under the node's codec.

Record header (all uint32 LE unless noted)::

    magic      0x0052494E  ("NIR\\0")
    type       record type (NODE_ADDED / *_PROPERTY / NEW_DATA / END ...)
    node_id    stream the record belongs to
    fields_sz  total header+fields byte size (payload starts here)
    payload_sz payload byte size
    undo_pos   uint64, position of the record this one supersedes

Supported payload codecs: ``UNC_`` (uncompressed) and the OpenNI
16-bit-depth zero codec ``16zP``/``16zT`` (embedded-table variant
parsed, table ignored — values are stored verbatim in the stream).

Fidelity caveat: this environment has no camera and no sample
recordings. The record-walk (file header, NODE_ADDED_1_0_0_5 trailing
fields, codec fourccs incl. ``NONE``, multi-node streams, property and
seek-table records, inter-record resync) is validated against a
hand-assembled byte-level fixture built independently of
:class:`OniWriter` from the documented OpenNI 1.x structures
(tests/test_oni.py:test_oni_independent_fixture); the 16z codec's
nibble semantics remain validated by round-trip only. The parser
RE-SYNCS on the record magic after any malformed record, so a
field-layout mismatch in one record type degrades to skipping that
record rather than aborting the conversion.
"""

from __future__ import annotations

import io
import struct
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

MAGIC_FILE = b"NI10"
MAGIC_RECORD = 0x0052494E            # b"NIR\0" little-endian

# OpenNI 1.x record types (XnRecordType).
NODE_ADDED_1_0_0_4 = 0x02
INT_PROPERTY = 0x03
REAL_PROPERTY = 0x04
STRING_PROPERTY = 0x05
GENERAL_PROPERTY = 0x06
NODE_REMOVED = 0x07
NODE_DATA_BEGIN = 0x08
NODE_STATE_READY = 0x09
NEW_DATA = 0x0A
END = 0x0B
SEEK_TABLE = 0x0C
NODE_ADDED_1_0_0_5 = 0x0D
NODE_ADDED = 0x0E
_NODE_ADDED_TYPES = (NODE_ADDED, NODE_ADDED_1_0_0_5, NODE_ADDED_1_0_0_4)

# XnProductionNodeType values for the two streams we care about.
NODE_TYPE_DEPTH = 1
NODE_TYPE_IMAGE = 3

_REC_HDR = struct.Struct("<IIIIIQ")   # magic, type, node, fields, payload, undo


def _pack_str(s: bytes) -> bytes:
    return struct.pack("<I", len(s) + 1) + s + b"\0"


def _read_str(buf: bytes, off: int) -> Tuple[bytes, int]:
    (n,) = struct.unpack_from("<I", buf, off)
    off += 4
    s = buf[off:off + n]
    return s.rstrip(b"\0"), off + n


@dataclass
class OniNode:
    node_id: int
    name: bytes = b""
    node_type: int = 0
    codec: bytes = b"UNC_"
    int_props: Dict[bytes, int] = field(default_factory=dict)
    frames: int = 0

    @property
    def resolution(self) -> Tuple[int, int]:
        """(width, height); OpenNI map generators store XRes/YRes."""
        return (int(self.int_props.get(b"XRes", 640)),
                int(self.int_props.get(b"YRes", 480)))


def _uncompress_depth_16z(payload: bytes, n_pixels: int) -> np.ndarray:
    """OpenNI XnStreamUncompressDepth16Z: zero-run-length + small-delta
    packed nibble stream over uint16 depth (written from the published
    codec structure; exercised by the round-trip suite only — see module
    caveat)."""
    out = np.zeros(n_pixels, np.uint16)
    ip = 0
    op = 0
    last = 0
    data = payload
    n = len(data)
    while ip < n and op < n_pixels:
        b0 = data[ip]
        hi, lo = b0 >> 4, b0 & 0xF
        if hi == 0xF:                       # full 16-bit value follows
            if lo == 0xF:
                if ip + 2 >= n:
                    break
                last = data[ip + 1] | (data[ip + 2] << 8)
                out[op] = last
                op += 1
                ip += 3
            else:                           # zero run of length lo
                op += lo
                ip += 1
        else:
            # two 4-bit deltas (biased by -6) applied successively
            last = (last + hi - 6) & 0xFFFF
            out[op] = last
            op += 1
            if op < n_pixels and lo != 0xF:
                last = (last + lo - 6) & 0xFFFF
                out[op] = last
                op += 1
            ip += 1
    return out


def _compress_depth_16z(depth: np.ndarray) -> bytes:
    """Inverse of :func:`_uncompress_depth_16z` (full-value escape for
    every pixel — valid, if not minimal, 16z stream)."""
    flat = np.ascontiguousarray(depth, np.uint16).reshape(-1)
    out = bytearray()
    for v in flat.tolist():
        out.append(0xFF)
        out.append(v & 0xFF)
        out.append(v >> 8)
    return bytes(out)


class OniReader:
    """Walks an .oni record stream; yields depth frames as uint16 mm.

    Tolerant: any record whose fields cannot be parsed is skipped and
    the stream re-synchronises on the next record magic."""

    def __init__(self, path: str):
        self.path = path
        self.nodes: Dict[int, OniNode] = {}
        self._f = open(path, "rb")
        hdr = self._f.read(4)
        if hdr != MAGIC_FILE:
            raise ValueError(f"{path}: not an ONI recording "
                             f"(magic {hdr!r}, want {MAGIC_FILE!r})")
        # version (4B: major, minor, maintenance uint8 + pad), uint32
        # build, uint64 max timestamp, uint32 max node id.
        self._f.read(4 + 4 + 8 + 4)
        self._data_start = self._f.tell()

    def close(self):
        self._f.close()

    def _resync(self) -> bool:
        """Scan forward to the next record magic."""
        needle = struct.pack("<I", MAGIC_RECORD)
        chunk_pos = self._f.tell()
        while True:
            chunk = self._f.read(1 << 16)
            if len(chunk) < len(needle):      # EOF (a 1-3 byte tail can
                return False                  # not hold the magic)
            i = chunk.find(needle)
            if i >= 0:
                self._f.seek(chunk_pos + i)
                return True
            # Overlap by 3 bytes so a magic straddling the chunk edge is
            # found; guaranteed forward progress since len(chunk) >= 4.
            chunk_pos += len(chunk) - 3
            self._f.seek(chunk_pos)

    def records(self) -> Iterator[Tuple[int, int, bytes, bytes]]:
        """Yields (type, node_id, fields_bytes, payload_bytes)."""
        while True:
            pos = self._f.tell()
            raw = self._f.read(_REC_HDR.size)
            if len(raw) < _REC_HDR.size:
                return
            magic, rtype, node, fsize, psize, _undo = _REC_HDR.unpack(raw)
            if magic != MAGIC_RECORD or fsize < _REC_HDR.size \
                    or fsize + psize > (1 << 31):
                self._f.seek(pos + 1)
                if not self._resync():
                    return
                continue
            fields = self._f.read(fsize - _REC_HDR.size)
            payload = self._f.read(psize)
            if len(fields) + _REC_HDR.size < fsize or len(payload) < psize:
                return
            yield rtype, node, fields, payload
            if rtype == END:
                return

    def _node(self, node_id: int) -> OniNode:
        return self.nodes.setdefault(node_id, OniNode(node_id))

    def depth_frames(self) -> Iterator[np.ndarray]:
        """Yields each depth frame as a [H, W] uint16 array."""
        for rtype, node_id, fields, payload in self.records():
            try:
                if rtype in _NODE_ADDED_TYPES:
                    n = self._node(node_id)
                    off = 0
                    n.name, off = _read_str(fields, off)
                    (n.node_type,) = struct.unpack_from("<I", fields, off)
                    off += 4
                    n.codec = fields[off:off + 4]
                elif rtype == INT_PROPERTY:
                    n = self._node(node_id)
                    off = 0
                    name, off = _read_str(fields, off)
                    (val,) = struct.unpack_from("<Q", fields, off)
                    n.int_props[name] = val
                elif rtype == NEW_DATA:
                    n = self._node(node_id)
                    if n.node_type != NODE_TYPE_DEPTH:
                        continue
                    w, h = n.resolution
                    codec = n.codec.replace(b"\0", b"_")
                    if codec in (b"16zP", b"16zT"):
                        body = payload
                        if codec == b"16zT":
                            # embedded tables: uint32 size + table, twice
                            for _ in range(2):
                                (tsz,) = struct.unpack_from("<I", body, 0)
                                body = body[4 + tsz:]
                        flat = _uncompress_depth_16z(body, w * h)
                    elif codec in (b"UNC_", b"NONE"):
                        flat = np.frombuffer(
                            payload[:w * h * 2], np.uint16).copy()
                        if flat.size < w * h:
                            continue
                    else:
                        raise NotImplementedError(
                            f"ONI codec {codec!r} not supported "
                            "(UNC_/16zP/16zT are)")
                    n.frames += 1
                    yield flat.reshape(h, w)
            except NotImplementedError:
                raise
            except Exception:
                continue       # malformed record: skip, stream re-syncs

    @property
    def depth_node(self) -> Optional[OniNode]:
        for n in self.nodes.values():
            if n.node_type == NODE_TYPE_DEPTH:
                return n
        return None


class OniWriter:
    """Writes the subset of the record layout the reader consumes
    (uncompressed or full-escape-16z depth stream). Used for tooling
    round-trips and the test suite."""

    def __init__(self, path: str, width: int, height: int,
                 codec: bytes = b"UNC_"):
        self.w, self.h = width, height
        self.codec = codec
        self.node_id = 1
        self.frame = 0
        self._f = open(path, "wb")
        self._f.write(MAGIC_FILE)
        self._f.write(struct.pack("<BBBB", 1, 0, 0, 0))   # version
        self._f.write(struct.pack("<I", 0))               # build
        self._f.write(struct.pack("<Q", 0))               # max timestamp
        self._f.write(struct.pack("<I", 1))               # max node id
        self._record(NODE_ADDED,
                     _pack_str(b"Depth1")
                     + struct.pack("<I", NODE_TYPE_DEPTH) + codec)
        self._int_prop(b"XRes", width)
        self._int_prop(b"YRes", height)
        self._record(NODE_STATE_READY, b"")

    def _record(self, rtype: int, fields: bytes, payload: bytes = b""):
        self._f.write(_REC_HDR.pack(MAGIC_RECORD, rtype, self.node_id,
                                    _REC_HDR.size + len(fields),
                                    len(payload), 0))
        self._f.write(fields)
        self._f.write(payload)

    def _int_prop(self, name: bytes, value: int):
        self._record(INT_PROPERTY, _pack_str(name)
                     + struct.pack("<Q", value))

    def write(self, depth: np.ndarray, timestamp_us: int = 0):
        depth = np.ascontiguousarray(depth, np.uint16)
        if depth.shape != (self.h, self.w):
            raise ValueError(f"frame {depth.shape} != ({self.h},{self.w})")
        if self.codec in (b"16zP", b"16zT"):
            body = _compress_depth_16z(depth)
            if self.codec == b"16zT":
                body = struct.pack("<I", 0) + struct.pack("<I", 0) + body
        else:
            body = depth.tobytes()
        self.frame += 1
        self._record(NEW_DATA,
                     struct.pack("<QI", timestamp_us, self.frame), body)

    def close(self):
        self._record(END, b"")
        self._f.close()
