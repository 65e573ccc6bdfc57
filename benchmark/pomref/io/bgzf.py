"""BGZF (blocked gzip) blocks, as the maker writes them: each block a gzip
member with an FEXTRA 'BC' subfield carrying its compressed size, and the
28-byte empty block that ends a file."""
from __future__ import annotations

import struct
import zlib

# 28-byte empty BGZF block used as EOF marker (fixed by the SAM spec).
BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)

BLOCK = 0xFF00  # uncompressed payload per block (htslib default)


def _deflate_block(payload: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(payload) + co.flush()
    bsize = len(comp) + 26  # 18 header + comp + 8 trailer
    if bsize > 0x10000:
        raise ValueError("BGZF block too large after compression")
    hdr = (
        b"\x1f\x8b\x08\x04\x00\x00\x00\x00\x00\xff"
        + struct.pack("<H", 6)
        + b"BC"
        + struct.pack("<H", 2)
        + struct.pack("<H", bsize - 1)
    )
    return hdr + comp + struct.pack("<II", zlib.crc32(payload) & 0xFFFFFFFF, len(payload) & 0xFFFFFFFF)
