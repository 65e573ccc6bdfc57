"""Dropped-interval phase recovery (blockjoin.c:2475-2692).

Tiny phased blocks swallowed by gap-merging get their variants re-phased by
majority vote of meth-phased reads carrying the ALT allele.
"""
from __future__ import annotations

from typing import Dict, List

from ..io.bam import BamReader
from ..io.intervals_loader import IS_VCF, load_intervals_from_file
from .intervals import Storage
from .variants import HAPTAG_UNPHASED, Variant
from .varhaptag import parse_variants_for_one_read


def recover_variant_phase_in_one_interval(
    st: Storage, bam: BamReader, refname: str, start: int, end: int,
    poss: List[int], pos2haptag: Dict[int, int],
) -> None:
    # piggyback: (pos, typ, payload); typ 0 = known pos (payload = coverage),
    # typ 1 = read variant (payload = index). blockjoin.c:2475-2615.
    known = [[p, 0] for p in poss]  # [pos, coverage]
    read_vars: List[Variant] = []
    for rec in bam.fetch_region_1based(refname, start, end):
        hap_meth = st.qname2haptag.get(rec.qname)
        if hap_meth is None:
            continue
        if st.stores_raw_tag:
            hap_raw = st.qname2haptag_raw.get(rec.qname)
            if hap_raw is None:
                continue
        else:
            hp = rec.get_tag("HP")
            hap_raw = HAPTAG_UNPHASED if hp is None or hp == 0 else hp - 1
        if hap_raw == HAPTAG_UNPHASED:
            continue
        prev_n = len(read_vars)
        read_vars.extend(parse_variants_for_one_read(rec))
        for v in read_vars[prev_n:]:
            v.haptag = (hap_meth << 4) | (hap_raw & 0xF)
        # NOTE: the reference's coverage counting here is dead code — the
        # comparison at blockjoin.c:2543-2547 tests the whole packed u64
        # against genomic positions, so counters never increment. Omitted.

    if not known:
        return
    pb = [(p, 0, 0) for p, _ in known]
    pb += [(v.pos, 1, i) for i, v in enumerate(read_vars)]
    pb.sort()
    i = 0
    n = len(pb)
    while i < n - 1:  # last entry never processed as a known pos (quirk)
        if pb[i][1] == 1:
            i += 1
            continue
        ref_pos = pb[i][0]
        hp_cnt = [0, 0]
        j = i + 1
        while j < n:
            if pb[j][1] == 0:
                break
            if pb[j][0] != ref_pos:
                break
            hap = read_vars[pb[j][2]].haptag >> 4
            if hap in (0, 1):
                hp_cnt[hap] += 1
            j += 1
        if hp_cnt[0] > hp_cnt[1]:
            hap_of_ref = 1  # variant called on hap0 -> REF has hap1
        elif hp_cnt[1] > hp_cnt[0]:
            hap_of_ref = 0
        else:
            hap_of_ref = HAPTAG_UNPHASED
        pos2haptag[ref_pos] = hap_of_ref
        i = j


def recover_variant_phase_in_dropped_intervals(st: Storage, bam: BamReader,
                                               fn_vcf: str) -> None:
    # collect all phased variants per chromosome (mode-A load)
    st2 = Storage(ref_names=list(st.ref_names))
    from .intervals import Ranges
    st2.ranges = [Ranges() for _ in st.ref_names]
    vars_v: List[List[Variant]] = [[] for _ in st.ref_names]
    load_intervals_from_file(fn_vcf, IS_VCF, st2, load_vcf_variants_too=True,
                             var_storage=vars_v)

    st.varphase_in_dropped = [dict() for _ in st.ref_names]
    for i_ref, refname in enumerate(st.ref_names):
        vars_ = vars_v[i_ref]
        rg = st.ranges[i_ref]
        prev_i = 0
        for (ds, de) in rg.dropped:
            start = ds - 1
            end = de + 1
            poss: List[int] = []
            for i in range(prev_i, len(vars_)):
                pos = vars_[i].pos
                if start <= pos < end:
                    poss.append(pos)
                if pos >= end:
                    prev_i = i
                    break
            recover_variant_phase_in_one_interval(
                st, bam, refname, start, end, poss,
                st.varphase_in_dropped[i_ref])
