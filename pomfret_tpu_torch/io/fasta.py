"""Minimal FASTA reader/writer with .fai indexing.

Used by the CRAM path to resolve reference bases (the reference tool gets
this through htslib's cram reference machinery: REF_PATH / @SQ UR lookup).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple


def write_fasta(path: str, seqs: Dict[str, str], width: int = 60) -> None:
    with open(path, "w") as f:
        for name, s in seqs.items():
            f.write(f">{name}\n")
            for i in range(0, len(s), width):
                f.write(s[i : i + width] + "\n")
    write_fai(path)


def write_fai(path: str) -> None:
    """Build <path>.fai (name, length, offset, linebases, linewidth)."""
    entries = []
    with open(path, "rb") as f:
        name = None
        length = 0
        offset = 0
        linebases = 0
        linewidth = 0
        seq_start = 0
        pos = 0
        for line in f:
            if line.startswith(b">"):
                if name is not None:
                    entries.append((name, length, seq_start, linebases, linewidth))
                name = line[1:].split()[0].decode()
                length = 0
                linebases = 0
                linewidth = 0
                seq_start = pos + len(line)
            else:
                bases = len(line.rstrip(b"\r\n"))
                if linebases == 0:
                    linebases = bases
                    linewidth = len(line)
                length += bases
            pos += len(line)
        if name is not None:
            entries.append((name, length, seq_start, linebases, linewidth))
    with open(path + ".fai", "w") as f:
        for e in entries:
            f.write("\t".join(str(x) for x in e) + "\n")


class FastaReader:
    def __init__(self, path: str):
        self.path = path
        self._fai: Dict[str, Tuple[int, int, int, int]] = {}
        fai = path + ".fai"
        if not os.path.exists(fai):
            write_fai(path)
        with open(fai) as f:
            for line in f:
                name, length, off, lb, lw = line.rstrip("\n").split("\t")
                self._fai[name] = (int(length), int(off), int(lb), int(lw))
        self._f = open(path, "rb")

    @property
    def names(self) -> List[str]:
        return list(self._fai)

    def length(self, name: str) -> int:
        return self._fai[name][0]

    def fetch(self, name: str, start: int = 0, end: Optional[int] = None) -> str:
        """0-based half-open [start, end) of contig `name` (uppercased)."""
        length, off, lb, lw = self._fai[name]
        if end is None or end > length:
            end = length
        start = max(0, start)
        if start >= end:
            return ""
        first = off + (start // lb) * lw + (start % lb)
        self._f.seek(first)
        need = end - start
        out = []
        got = 0
        while got < need:
            chunk = self._f.read(min(1 << 20, (need - got) + lw))
            if not chunk:
                break
            s = chunk.replace(b"\n", b"").replace(b"\r", b"")
            out.append(s[: need - got])
            got += len(s[: need - got])
        return b"".join(out).decode().upper()

    def close(self) -> None:
        self._f.close()
