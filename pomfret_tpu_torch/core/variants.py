"""Variant domain model (variant_t, blockjoin.c:165-210) and VCF variant
extraction (insert_variant_from_vcf_line, blockjoin.c:1432-1543)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

VAR_OP_M = 0
VAR_OP_X = 1
VAR_OP_I = 2
VAR_OP_D = 3

HAPTAG_UNPHASED = 254

_NT4 = {c: i for i, c in enumerate("ACGT")}
_NT4.update({c: i for i, c in enumerate("acgt")})
_NT4["U"] = 3
_NT4["u"] = 3


def seq_nt4(s: str) -> Tuple[int, ...]:
    return tuple(_NT4.get(c, 4) for c in s)


@dataclass
class Variant:
    pos: int            # 0-based reference position
    op: int             # VAR_OP_*
    length: int
    chars: Tuple[int, ...]   # nt4-coded; ALT for SNP/INS, deleted REF for DEL
    haptag: int         # for VCF-derived variants: haptag of the REF allele


def _find_format_field(fmt: str, key: str) -> int:
    for i, f in enumerate(fmt.split(":")):
        if f == key:
            return i
    return -1


def variant_from_vcf_fields(cols: List[str]) -> Optional[Variant]:
    """Parse one already-split VCF data line into a phased variant or None
    (mirrors insert_variant_from_vcf_line's acceptance rules)."""
    if len(cols) < 10:
        return None
    pos = int(cols[1]) - 1
    ref = cols[3]
    alt = cols[4]
    i_gt = _find_format_field(cols[8], "GT")
    if i_gt < 0:
        return None
    sample_fields = cols[9].split(":")
    if i_gt >= len(sample_fields):
        return None
    gt = sample_fields[i_gt]
    if len(gt) != 3 or gt[1] != "|":
        return None
    if gt[0] not in "01" or gt[2] not in "01":
        return None
    ref_l, alt_l = len(ref), len(alt)
    hp = int(gt[0])
    if ref_l == 1 and alt_l == 1:
        return Variant(pos, VAR_OP_X, 1, seq_nt4(alt), hp)
    if ref_l == alt_l:
        return None  # MNP: reference warns + skips
    if ref_l > alt_l:
        n = ref_l - alt_l
        # reference takes exactly op_l chars starting at ref+1 (blockjoin.c:1519-1524)
        return Variant(pos + 1, VAR_OP_D, n, seq_nt4(ref[1 : 1 + n]), hp)
    n = alt_l - ref_l
    return Variant(pos, VAR_OP_I, n, seq_nt4(alt[1 : 1 + n]), hp)
