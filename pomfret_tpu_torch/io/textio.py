"""Plain-or-gzipped line streaming (replaces the gzread loops at
blockjoin.c:1909-1975, 2016-2147)."""
from __future__ import annotations

import gzip
from typing import Iterator


def open_text(path: str):
    with open(path, "rb") as f:
        head = f.read(2)
    if head == b"\x1f\x8b":
        return gzip.open(path, "rt")
    return open(path, "rt")


def iter_lines(path: str) -> Iterator[str]:
    """Yield lines without trailing newline. Note: like the reference's
    gzread loop, a final line without '\\n' is dropped."""
    with open_text(path) as f:
        pending = ""
        for chunk in iter(lambda: f.read(1 << 20), ""):
            pending += chunk
            parts = pending.split("\n")
            pending = parts.pop()
            for line in parts:
                yield line
