"""On-disk container format.

The reference serializes every artifact with encoding/gob + transparent
gzip fallback (src/lib/file_decoder.go:56-78, file_encoder.go).  gob is
record-oriented and decode-heavy; here the equivalent is a flat,
self-describing binary container designed so column payloads are raw
little-endian arrays that can be mmapped and handed to the device with
zero copies:

    magic "SYB1" | uint32 header_len | header JSON | pad to 64 | sections...

The header carries a user `meta` dict plus a section table
(name, dtype, shape, offset, nbytes).  Sections are 64-byte aligned.
A `.gz` sibling is tried transparently when the plain file is missing,
mirroring sybil's GetFileDecoder fallback.
"""

from __future__ import annotations

import gzip
import json
import os
import struct
import tempfile

import numpy as np

MAGIC = b"SYB1"
ALIGN = 64


def _align(n: int) -> int:
    return (n + ALIGN - 1) // ALIGN * ALIGN


def write_container(path: str, meta: dict, sections: dict[str, np.ndarray],
                    compress: bool = False) -> None:
    """Atomically write a container (temp file + rename, like the
    reference's RenameAndMod publish at src/lib/file_utils.go:28)."""
    sec_table = []
    offset = 0
    blobs = []
    for name, arr in sections.items():
        arr = np.ascontiguousarray(arr)
        raw = arr.tobytes()
        sec_table.append({
            "name": name,
            "dtype": arr.dtype.str,
            "shape": list(arr.shape),
            "offset": offset,
            "nbytes": len(raw),
        })
        blobs.append(raw)
        offset = _align(offset + len(raw))

    header = json.dumps({"meta": meta, "sections": sec_table}).encode()
    head = MAGIC + struct.pack("<I", len(header)) + header
    base = _align(len(head))

    out = bytearray(base + offset)
    out[: len(head)] = head
    pos = base
    for raw, sec in zip(blobs, sec_table):
        sec_off = base + sec["offset"]
        out[sec_off: sec_off + len(raw)] = raw

    dirname = os.path.dirname(path) or "."
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".tmp_container")
    try:
        with os.fdopen(fd, "wb") as f:
            if compress:
                f.write(gzip.compress(bytes(out)))
            else:
                f.write(bytes(out))
        os.chmod(tmp, 0o664)
        os.rename(tmp, path + ".gz" if compress else path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


class Container:
    """A parsed container; sections are lazy zero-copy views when the
    source was a plain (non-gzip) file."""

    def __init__(self, buf: bytes | memoryview, path: str = ""):
        self.path = path
        if bytes(buf[:4]) != MAGIC:
            raise ValueError(f"bad container magic in {path!r}")
        (hlen,) = struct.unpack("<I", buf[4:8])
        header = json.loads(bytes(buf[8: 8 + hlen]).decode())
        self.meta = header["meta"]
        self._sections = {s["name"]: s for s in header["sections"]}
        self._base = _align(8 + hlen)
        self._buf = buf

    def section_names(self):
        return list(self._sections)

    def __contains__(self, name):
        return name in self._sections

    def read(self, name: str) -> np.ndarray:
        sec = self._sections[name]
        start = self._base + sec["offset"]
        arr = np.frombuffer(self._buf, dtype=np.dtype(sec["dtype"]),
                            count=int(np.prod(sec["shape"], dtype=np.int64)),
                            offset=start)
        return arr.reshape(sec["shape"])


def read_container(path: str, mmap: bool = True) -> Container:
    """Open `path`, falling back to `path.gz` (transparent gzip), as the
    reference's GetFileDecoder does (src/lib/file_decoder.go:56-78)."""
    if os.path.exists(path):
        if mmap:
            buf = np.memmap(path, dtype=np.uint8, mode="r")
            return Container(memoryview(buf), path)
        with open(path, "rb") as f:
            return Container(f.read(), path)
    gz = path + ".gz"
    if os.path.exists(gz):
        with gzip.open(gz, "rb") as f:
            return Container(f.read(), gz)
    raise FileNotFoundError(path)


# --- small JSON helpers with the same atomic-publish discipline ---

def write_json_atomic(path: str, obj, backup: bool = False) -> None:
    dirname = os.path.dirname(path) or "."
    if backup and os.path.exists(path):
        # metadata checkpoint, like info.bak (src/lib/table_io.go:40)
        try:
            with open(path, "rb") as f:
                data = f.read()
            with open(path + ".bak", "wb") as f:
                f.write(data)
        except OSError:
            pass
    fd, tmp = tempfile.mkstemp(dir=dirname, prefix=".tmp_json")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(obj, f)
        os.chmod(tmp, 0o664)
        os.rename(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def read_json(path: str):
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    gz = path + ".gz"
    if os.path.exists(gz):
        with gzip.open(gz, "rt") as f:
            return json.load(f)
    raise FileNotFoundError(path)
