"""Phase-block / gap loading from VCF, GTF and TSV.

Reimplements load_intervals_from_file and its per-line helpers
(blockjoin.c:1305-1430, 1977-2176), preserving the behavior-defining quirks:

- a gap's "end" is the NEXT block's PS id (whatshap convention: PS == block
  start position), blockjoin.c:1417;
- `prev_group_ID` is global across chromosomes, so `abs_start` is only ever
  set for the first chromosome of a VCF (later chromosomes keep abs_start=0,
  whose phase blocks are then skipped as placeholders by the GTF writer);
- PS == '.' lines are skipped without touching the state;
- multi-sample VCFs are rejected.
"""
from __future__ import annotations

import sys
from typing import Callable, List, Optional

from ..core.intervals import Ranges, Storage, UINT32_MAX
from ..core.variants import Variant, variant_from_vcf_fields
from ..utils.log import log_err, log_info
from .textio import iter_lines

IS_VCF = 0
IS_GTF = 1
IS_TSV = 2


class _VcfState:
    def __init__(self):
        self.prev_pos = UINT32_MAX       # per-chromosome (reset on switch)
        self.prev_group_id = UINT32_MAX  # global (reference quirk)


def _check_vcf_header_columns(line: str) -> None:
    n = len(line.split("\t"))
    if n < 10:
        log_err("insert_vcf_line", f"vcf only has {n} columns; mandatory >=8; "
                "we also need FORMAT and at least 1 sample")
        sys.exit(1)
    if n > 10:
        log_err("insert_vcf_line", "multi-sample vcf not implemented, TODO/TBD")
        sys.exit(1)


def insert_vcf_line(cols: List[str], rg: Ranges, vs: _VcfState) -> int:
    """Collect phase-gap intervals from PS fields (blockjoin.c:1348-1430).
    `cols` is the tab-split data line. Returns 1 if the line carried a PS."""
    pos = int(cols[1])
    if vs.prev_pos != UINT32_MAX and pos < vs.prev_pos:
        log_err("insert_vcf_line", f"vcf not sorted? last line pos={vs.prev_pos}, current pos={pos}")
        sys.exit(1)
    fmt = cols[8].split(":")
    try:
        i_ps = fmt.index("PS")
    except ValueError:
        return 0
    sample = cols[9].split(":")
    if i_ps >= len(sample):
        return 0
    used = 1
    ps = sample[i_ps]
    if ps == ".":
        return used
    group_id = int(ps)
    if vs.prev_group_id == UINT32_MAX:
        vs.prev_group_id = group_id
        vs.prev_pos = pos
        rg.abs_start = pos
    if group_id == vs.prev_group_id:
        vs.prev_pos = pos
    else:
        if vs.prev_pos != UINT32_MAX:
            rg.starts.append(vs.prev_pos)
            rg.ends.append(group_id)  # gap end == next block's PS id
            rg.decisions.append(-1)
        vs.prev_group_id = group_id
        vs.prev_pos = pos
    return used


def insert_gtf_line(cols: List[str], rg: Ranges, prev_end: int, is_tsv: bool) -> int:
    """GTF (cols 3,4) / TSV (cols 1,2) block line (blockjoin.c:1305-1345).
    Returns the updated prev_end."""
    ci_s, ci_e = (1, 2) if is_tsv else (3, 4)
    if len(cols) <= max(ci_s, ci_e):
        return prev_end
    start = int(cols[ci_s])
    if prev_end != UINT32_MAX:
        rg.starts.append(prev_end)
        rg.ends.append(start)
        rg.decisions.append(-1)
    else:
        rg.abs_start = start
    return int(cols[ci_e])


def load_intervals_from_file(
    path: str,
    fmt: int,
    st: Storage,
    load_vcf_variants_too: bool = False,
    haptag_callback: Optional[Callable[[str, List[Variant]], None]] = None,
    var_storage: Optional[List[List[Variant]]] = None,
) -> None:
    """Populate `st` with per-chromosome gap lists; optionally collect phased
    variants and/or run per-chromosome read pre-haplotagging.

    Mirrors load_intervals_from_file (blockjoin.c:1977-2176):
    - var_storage given: only variants are collected, into var_storage[i]
      for chromosomes already present in st.ref_names (st is NOT extended);
    - haptag_callback given (with load_vcf_variants_too): the callback is
      invoked once per completed chromosome with its phased variants
      (the pre_haplotagging_read_in_one_ref hook).
    """
    vs = _VcfState()
    prev_end = UINT32_MAX
    cur_rg: Optional[Ranges] = None
    cur_chrom: Optional[str] = None
    phased_variants: List[Variant] = []
    collecting_inline = load_vcf_variants_too and var_storage is None
    if collecting_inline:
        st.stores_raw_tag = True
    i_ref_cache = -1
    cache_chrom = None

    tot_variants = 0
    used_variants = 0

    for line in iter_lines(path):
        if not line:
            continue
        if line[0] == "#":
            if len(line) > 1 and line[1] != "#" and fmt == IS_VCF:
                _check_vcf_header_columns(line)
            continue
        cols = line.split("\t")
        tok = cols[0]
        if not st.ref_names:
            st.ref_names.append(tok)
            st.ranges.append(Ranges())
            cur_rg = st.ranges[0]
            cur_chrom = tok
            log_info("load_intervals_from_file", f"at ref {tok}")
        else:
            found = False
            for i in range(len(st.ref_names) - 1, -1, -1):
                if st.ref_names[i] == tok:
                    found = True
                    cur_rg = st.ranges[i]
                    cur_chrom = st.ref_names[i]
                    break
            if not found:
                # previous chromosome is complete
                prev_rg = st.ranges[-1]
                if prev_end != UINT32_MAX:
                    prev_rg.abs_end = prev_end
                if load_vcf_variants_too and phased_variants:
                    if var_storage is None and haptag_callback is not None:
                        haptag_callback(st.ref_names[-1], phased_variants)
                        phased_variants = []
                if not (load_vcf_variants_too and var_storage is not None):
                    st.ref_names.append(tok)
                    st.ranges.append(Ranges())
                    cur_rg = st.ranges[-1]
                    cur_chrom = tok
                else:
                    cur_chrom = tok
                prev_end = UINT32_MAX
                vs.prev_pos = UINT32_MAX  # per-chromosome reset
                # NOTE: vs.prev_group_id intentionally NOT reset (quirk)

        if fmt in (IS_GTF, IS_TSV):
            if cols[0] == cur_chrom:
                prev_end = insert_gtf_line(cols, cur_rg, prev_end, fmt == IS_TSV)
        else:  # VCF
            if load_vcf_variants_too and var_storage is not None:
                if cache_chrom != cur_chrom:
                    i_ref_cache = -1
                    for i, nm in enumerate(st.ref_names):
                        if nm == cur_chrom:
                            i_ref_cache = i
                            break
                    cache_chrom = cur_chrom
                if i_ref_cache >= 0 and cols[0] == cur_chrom:
                    v = variant_from_vcf_fields(cols)
                    if v is not None:
                        var_storage[i_ref_cache].append(v)
            elif collecting_inline:
                if cols[0] == cur_chrom:
                    v = variant_from_vcf_fields(cols)
                    if v is not None:
                        phased_variants.append(v)
                    used = insert_vcf_line(cols, cur_rg, vs)
                    if used >= 0:
                        tot_variants += 1
                        used_variants += used
                    prev_end = vs.prev_pos
            else:
                if cols[0] == cur_chrom:
                    used = insert_vcf_line(cols, cur_rg, vs)
                    if used >= 0:
                        tot_variants += 1
                        used_variants += used
                    prev_end = vs.prev_pos

    # EOF: final chromosome
    if collecting_inline and cur_chrom is not None and haptag_callback is not None:
        haptag_callback(cur_chrom, phased_variants)
        phased_variants = []
    if prev_end != UINT32_MAX and cur_rg is not None:
        cur_rg.abs_end = prev_end
    if fmt == IS_VCF:
        log_info("load_intervals_from_file",
                 f"loaded from vcf: total {tot_variants} variants, used {used_variants} when looking for phaseblocks")
