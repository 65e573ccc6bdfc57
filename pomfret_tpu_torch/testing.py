"""Synthetic data, packed batches and a step checker, for the tests and
chip_smoke.py.

- The synthetic diploid methylation data generator (a copy of the JAX
  package's testing.py): sorted+indexed BAMs with MM/ML/MD/HP tags and
  phased VCFs with PS blocks, with known ground truth. The reference
  genome is built from {A,T,G} plus explicit CpG dinucleotides so that
  EVERY C is a CpG C (MM delta encoding becomes exact and simple for both
  strands). Haplotypes differ in CpG methylation state and in SNPs (for
  the varhaptag path). make_datasets makes the scale and accuracy sets
  with their chromosomes in parallel, byte for byte as the serial maker.
- Randomized and crafted loop batches, the bench-shape batch and
  checked_step, for holding the kernels against their plain versions.
- run_processes: one CLI command run by several processes of one gloo
  process group on this host; Spawned: one call in a process of its own;
  peak_rss_mib: a process's own peak RSS.
"""
from __future__ import annotations

import bisect
import contextlib
import gzip
import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from .io.bam import BamRecord
from .io.bam_writer import BamWriter
from .io.records import make_record
from .io.basemod import revcomp


@dataclass
class SynthConfig:
    ref_len: int = 200_000
    cpg_every: int = 120          # one CpG per this many bp
    read_len: int = 20_000
    read_stagger: int = 700       # per-haplotype start offset step
    meth_qual: int = 250
    unmeth_qual: int = 5
    noise: float = 0.0            # per-site probability of flipped state
    nocall: float = 0.0           # per-site probability of mid-band qual
    frac_reverse: float = 0.3
    seed: int = 0
    chrom: str = "chr1"


class SynthRegion:
    def __init__(self, cfg: SynthConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng
        # genome over {A,T,G}, then place CG dinucleotides
        base = rng.choice(list("ATG"), size=cfg.ref_len)
        self.cpg_sites: List[int] = []
        p = cfg.cpg_every // 2
        while p + 1 < cfg.ref_len - 2:
            base[p] = "C"
            base[p + 1] = "G"
            self.cpg_sites.append(p)
            p += cfg.cpg_every
        self.ref = "".join(base)
        self.cpg_arr = np.array(self.cpg_sites, dtype=np.int64)
        # methylation truth: hap0 methylated, hap1 unmethylated (all sites
        # informative; callers can mask ranges via set_uninformative)
        self.meth_state = np.zeros((2, len(self.cpg_sites)), dtype=np.int8)
        self.meth_state[0, :] = 1  # hap0 meth
        self.meth_state[1, :] = 0
        self.snps: List[Tuple[int, str, str, int]] = []  # pos0, ref, alt, hap_with_alt

    def set_uninformative(self, start: int, end: int) -> None:
        m = (self.cpg_arr >= start) & (self.cpg_arr < end)
        self.meth_state[0, m] = 0
        self.meth_state[1, m] = 0

    def add_snps(self, positions: Sequence[int], hap_with_alt: Sequence[int]) -> None:
        """SNPs at reference 'A' positions, ALT='T' (never creates CpGs)."""
        for pos, hap in zip(positions, hap_with_alt):
            assert self.ref[pos] == "A", f"SNP host base at {pos} is {self.ref[pos]}"
            self.snps.append((pos, "A", "T", hap))
        self.snps.sort()

    # ------------------------------------------------------------------
    def hap_seq(self, start: int, end: int, hap: int) -> str:
        s = list(self.ref[start:end])
        for pos, ref, alt, hap_alt in self.snps:
            if start <= pos < end and hap_alt == hap:
                s[pos - start] = alt
        return "".join(s)

    def _pick_indel_spot(self, start: int, end: int, dlen: int) -> Optional[int]:
        """A reference position p in (start+200, end-200) such that
        [p-2, p+dlen+2) contains no C or G (so CpG sites are unaffected)."""
        for _ in range(50):
            p = int(self.rng.integers(start + 200, end - 200))
            win = self.ref[p - 2 : p + dlen + 2]
            if "C" not in win and "G" not in win:
                return p
        return None

    def make_read(self, qname: str, start: int, hap: int,
                  reverse: bool, tagged: bool,
                  hp_label: Optional[int] = None,
                  softclip: int = 0, with_indel: Optional[str] = None
                  ) -> BamRecord:
        """One read of cfg.read_len from `hap` starting at `start`.

        hp_label overrides the HP tag value (1-based); None -> untagged.
        softclip prepends that many clipped 'T' bases; with_indel in
        {'I','D'} splices a small CpG-neutral indel into the middle.
        """
        cfg = self.cfg
        end = min(start + cfg.read_len, cfg.ref_len)
        seq = self.hap_seq(start, end, hap)
        L = end - start

        # optional CpG-neutral indel in the aligned portion
        cigar_mid = [("M", L)]
        ins_read_off = None      # read offset of inserted bases (post-splice)
        del_ref_off = None
        if with_indel == "I":
            p = self._pick_indel_spot(start, end, 0)
            if p is not None:
                ro = p - start
                seq = seq[:ro] + "TT" + seq[ro:]
                cigar_mid = [("M", ro), ("I", 2), ("M", L - ro)]
                ins_read_off = ro
                L += 2
        elif with_indel == "D":
            p = self._pick_indel_spot(start, end, 3)
            if p is not None:
                ro = p - start
                seq = seq[:ro] + seq[ro + 3:]
                cigar_mid = [("M", ro), ("D", 3), ("M", L - ro - 3)]
                del_ref_off = ro
                L -= 3

        if softclip:
            seq = "T" * softclip + seq
            cigar = [("S", softclip)] + cigar_mid
            L += softclip
        else:
            cigar = cigar_mid

        # read-position -> reference-position map from the CIGAR
        ref_of = np.full(L, -1, dtype=np.int64)
        rp, i = start, 0
        for op, ln in cigar:
            if op == "S" or op == "I":
                i += ln
            elif op == "M":
                ref_of[i : i + ln] = np.arange(rp, rp + ln)
                i += ln
                rp += ln
            elif op == "D":
                rp += ln

        # per-site meth state from the haplotype profile
        m = (self.cpg_arr >= start) & (self.cpg_arr + 1 < end)
        sites = self.cpg_arr[m]
        site_idx = np.flatnonzero(m)
        states = self.meth_state[hap, site_idx].astype(np.int8)
        if cfg.noise > 0:
            flip = self.rng.random(len(states)) < cfg.noise
            states = np.where(flip, 1 - states, states)
        quals = np.where(states == 1, cfg.meth_qual, cfg.unmeth_qual)
        if cfg.nocall > 0:
            nc = self.rng.random(len(states)) < cfg.nocall
            quals = np.where(nc, 128, quals)
        pos2qual = {int(s): int(q) for s, q in zip(sites, quals)}

        # MM/ML over the ORIGINAL read orientation; clips/insertions are
        # C-free, so every origin C is a CpG C (possibly trailing/unaligned)
        stored = seq
        origin = revcomp(stored) if reverse else stored
        site_of_origin_c = {}
        for j in range(L - 1):
            if origin[j] == "C" and origin[j + 1] == "G":
                sp = (L - 2 - j) if reverse else j  # stored CpG-C position
                if ref_of[sp] >= 0:
                    site_of_origin_c[j] = int(ref_of[sp])
        all_c = [j for j in range(L) if origin[j] == "C"]
        deltas: List[int] = []
        mlvals: List[int] = []
        skipped = 0
        for ci in all_c:
            site = site_of_origin_c.get(ci)
            if site is None or site not in pos2qual:
                skipped += 1
                continue
            deltas.append(skipped)
            mlvals.append(pos2qual[site])
            skipped = 0
        mm = "C+m?," + ",".join(str(d) for d in deltas) + ";" if deltas else "C+m?;"

        # MD: walk aligned ops against the reference
        md_parts: List[str] = []
        run = 0
        rp, i = start, 0
        for op, ln in cigar:
            if op == "S" or op == "I":
                i += ln
            elif op == "M":
                for k in range(ln):
                    if seq[i + k] == self.ref[rp + k]:
                        run += 1
                    else:
                        md_parts.append(str(run))
                        md_parts.append(self.ref[rp + k])
                        run = 0
                i += ln
                rp += ln
            elif op == "D":
                md_parts.append(str(run))
                md_parts.append("^" + self.ref[rp : rp + ln])
                run = 0
                rp += ln
        md_parts.append(str(run))
        md = "".join(md_parts)

        tags = [("MM", "Z", mm)]
        if mlvals:
            tags.append(("ML", "B:C", mlvals))
        tags.append(("MD", "Z", md))
        tags.append(("de", "f", 0.01))
        if tagged:
            tags.append(("HP", "i", (hap + 1) if hp_label is None else hp_label))
        return make_record(qname, 0, start, stored, cigar,
                           flag=16 if reverse else 0, mapq=60, tags=tags)

    def make_reads(self, tagged: bool = True,
                   hp_label_fn=None,
                   region: Optional[Tuple[int, int]] = None,
                   frac_clipped: float = 0.0,
                   frac_indel: float = 0.0) -> List[BamRecord]:
        recs = list(self.iter_reads(tagged, hp_label_fn, region,
                                    frac_clipped, frac_indel))
        recs.sort(key=lambda r: r.pos)
        return recs

    def iter_reads(self, tagged: bool = True, hp_label_fn=None,
                   region: Optional[Tuple[int, int]] = None,
                   frac_clipped: float = 0.0, frac_indel: float = 0.0):
        """make_reads' records one at a time, in the order they are drawn
        (every hap-0 read, then every hap-1 read), before its sort by
        position."""
        cfg = self.cfg
        lo, hi = region if region else (0, cfg.ref_len)
        k = 0
        for hap in (0, 1):
            start = lo + (cfg.read_stagger // 2) * hap
            while start + cfg.read_len <= hi:
                reverse = bool(self.rng.random() < cfg.frac_reverse)
                hp_label = hp_label_fn(start, hap) if hp_label_fn else None
                clip = 50 if self.rng.random() < frac_clipped else 0
                indel = None
                if self.rng.random() < frac_indel:
                    indel = "I" if self.rng.random() < 0.5 else "D"
                yield self.make_read(f"read_{hap}_{k}", start, hap, reverse,
                                     tagged, hp_label, softclip=clip,
                                     with_indel=indel)
                k += 1
                start += cfg.read_stagger

    def write_bam(self, path: str, recs: List[BamRecord]) -> None:
        with BamWriter(path, [self.cfg.chrom], [self.cfg.ref_len],
                       header_text="@HD\tVN:1.6\tSO:coordinate\n",
                       keep_index_info=True) as w:
            for r in recs:
                w.write(r)
        w.build_index(n_ref=1)

    def write_vcf(self, path: str, ps_of_pos, extra_format: str = "GT:PS",
                  flip_gt_in_block=None) -> None:
        """Write a phased VCF over self.snps.

        ps_of_pos(pos0) -> PS id (int) or None to leave the variant unphased.
        flip_gt_in_block(pos0) -> bool: True writes the GT with hap roles
        swapped (simulates a switch error between blocks).
        """
        lines = [
            "##fileformat=VCFv4.2",
            f"##contig=<ID={self.cfg.chrom},length={self.cfg.ref_len}>",
            '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">',
            '##FORMAT=<ID=PS,Number=1,Type=Integer,Description="Phase set">',
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample",
        ]
        for pos, ref, alt, hap_alt in self.snps:
            ps = ps_of_pos(pos)
            # GT convention: allele of hap0 | allele of hap1
            a0, a1 = (1, 0) if hap_alt == 0 else (0, 1)
            if flip_gt_in_block and flip_gt_in_block(pos):
                a0, a1 = a1, a0
            if ps is None:
                gt, fmt = f"{a0}/{a1}", "GT"
                lines.append(f"{self.cfg.chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t60\tPASS\t.\t{fmt}\t{gt}")
            else:
                lines.append(f"{self.cfg.chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t60\tPASS\t.\tGT:PS\t{a0}|{a1}:{ps}")
        data = "\n".join(lines) + "\n"
        if path.endswith(".gz"):
            with gzip.open(path, "wt") as f:
                f.write(data)
        else:
            with open(path, "w") as f:
                f.write(data)


def make_two_chrom_scenario(tmpdir: str, cfg: Optional[SynthConfig] = None):
    """Two chromosomes, each with a two-block joinable gap, in ONE BAM/VCF.

    Exercises the multi-chromosome quirks end-to-end (abs_start only set for
    the first chromosome of a VCF -> later chromosomes produce placeholder
    phase blocks that the GTF writer skips, blockjoin.c:1406-1410, 2743).
    Returns (bam, vcf, truths per chrom).
    """
    import os
    cfgs = []
    regions = []
    truths = []
    for ci, chrom in enumerate(("chr1", "chr2")):
        c = SynthConfig(**{**(cfg.__dict__ if cfg else SynthConfig().__dict__),
                           "chrom": chrom, "seed": ci})
        sr = SynthRegion(c)
        b1 = (5_000, 80_000)
        b2 = (120_000, 195_000)
        snp_pos = []
        for lo, hi in (b1, b2):
            p = lo
            while p < hi:
                for q in range(p, min(p + 200, c.ref_len)):
                    if sr.ref[q] == "A":
                        snp_pos.append(q)
                        break
                p += 2_000
        sr.add_snps(snp_pos, [i % 2 for i in range(len(snp_pos))])
        block1 = [p for p in snp_pos if b1[0] <= p < b1[1]]
        block2 = [p for p in snp_pos if b2[0] <= p < b2[1]]
        truths.append({
            "gap": (block1[-1] + 1, block2[0] + 1),
            "ps1": block1[0] + 1, "ps2": block2[0] + 1,
            "blocks": (b1, b2), "region": sr,
        })
        cfgs.append(c)
        regions.append(sr)

    # one BAM with both chromosomes
    from .io.bam_writer import BamWriter
    bam = os.path.join(tmpdir, "twochrom.bam")
    w = BamWriter(bam, [c.chrom for c in cfgs], [c.ref_len for c in cfgs],
                  header_text="@HD\tVN:1.6\tSO:coordinate\n",
                  keep_index_info=True)
    for ci, sr in enumerate(regions):
        recs = sr.make_reads(tagged=True)
        for r in recs:
            r.refID = ci
            r.qname = f"c{ci}_" + r.qname
            w.write(r)
    w.close()
    w.build_index(n_ref=2)

    # one VCF with both chromosomes
    vcf = os.path.join(tmpdir, "twochrom.vcf.gz")
    lines = [
        "##fileformat=VCFv4.2",
        "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample",
    ]
    for ci, (sr, t) in enumerate(zip(regions, truths)):
        for pos, ref, alt, hap_alt in sr.snps:
            ps = t["ps1"] if pos < t["blocks"][0][1] else t["ps2"]
            a0, a1 = (1, 0) if hap_alt == 0 else (0, 1)
            lines.append(f"{cfgs[ci].chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t60\tPASS\t.\tGT:PS\t{a0}|{a1}:{ps}")
    data = "\n".join(lines) + "\n"
    with gzip.open(vcf, "wt") as f:
        f.write(data)
    return bam, vcf, truths


_MARGIN = 5_000


def _block_layout(n_blocks: int, block_len: int, gap_len: int):
    """(ref_len, blocks) of make_multichrom_multigap_scenario, the same on
    every chromosome: a 5 kb margin at each end and n_blocks blocks of
    block_len between gaps of gap_len."""
    ref_len = _MARGIN * 2 + n_blocks * block_len + (n_blocks - 1) * gap_len
    blocks = []
    p = _MARGIN
    for _ in range(n_blocks):
        blocks.append((p, p + block_len))
        p += block_len + gap_len
    return ref_len, blocks


def _scenario_region(ci: int, ref_len: int, blocks, read_stagger: int,
                     per_chrom) -> Tuple[SynthRegion, List[int]]:
    """Chromosome ci's region (seed ci, per_chrom[ci]'s settings) and its
    SNPs: one on the first 'A' of each 2 kb step inside each block,
    alternating haplotypes."""
    kw = dict(ref_len=ref_len, chrom=f"chr{ci + 1}", seed=ci,
              read_stagger=read_stagger)
    if per_chrom is not None:
        kw.update(per_chrom[ci])
    sr = SynthRegion(SynthConfig(**kw))
    snp_pos = []
    for lo, hi in blocks:
        q = lo
        while q < hi:
            for r in range(q, min(q + 200, sr.cfg.ref_len)):
                if sr.ref[r] == "A":
                    snp_pos.append(r)
                    break
            q += 2_000
    sr.add_snps(snp_pos, [i % 2 for i in range(len(snp_pos))])
    return sr, snp_pos


def _hp_labeller(blocks, trans_alternate: bool):
    """make_reads' hp_label_fn under trans_alternate, else None: domain i+1
    starts at block i's end (reads starting in a gap belong to the next
    block, matching the two-block fixture's start >= gap[0] rule) and odd
    domains swap the labels. All chromosomes share one block layout, so
    one boundary list serves all."""
    if not trans_alternate:
        return None
    domain_starts = [blocks[i][1] for i in range(len(blocks) - 1)]

    def label(start, hap):
        bi = bisect.bisect_right(domain_starts, start)
        return ((1 - hap) + 1) if bi % 2 else (hap + 1)
    return label


class _Scenario:
    """One set of make_multichrom_multigap_scenario: its regions and truths
    (built here, in the calling process), its BAM written chromosome by
    chromosome, then its index and VCF."""

    def __init__(self, tmpdir, n_chroms=2, n_blocks=4, block_len=60_000,
                 gap_len=30_000, read_stagger=700, per_chrom=None,
                 bam_threads=1, bam_name="multichrom.bam",
                 trans_alternate=False):
        if per_chrom is not None:
            n_chroms = len(per_chrom)
        self.n_chroms = n_chroms
        self.chrom_args = ((n_blocks, block_len, gap_len), read_stagger,
                           per_chrom, trans_alternate)
        self.ref_len, self.blocks = _block_layout(n_blocks, block_len,
                                                  gap_len)
        self.bam = os.path.join(tmpdir, bam_name)
        self.vcf = os.path.join(tmpdir, "multichrom.vcf.gz")
        self.parts = os.path.join(tmpdir, f".{bam_name}.parts")
        self.bam_threads = bam_threads
        self.trans_alternate = trans_alternate
        self.regions = []
        self.truths = []
        self.w = None

    def build_regions(self) -> None:
        _, read_stagger, per_chrom, trans = self.chrom_args
        n_gaps = len(self.blocks) - 1
        for ci in range(self.n_chroms):
            sr, snp_pos = _scenario_region(ci, self.ref_len, self.blocks,
                                           read_stagger, per_chrom)
            block_snps = [[s for s in snp_pos if lo <= s < hi]
                          for lo, hi in self.blocks]
            ps_ids = [bs[0] + 1 for bs in block_snps]
            self.truths.append({
                "blocks": list(self.blocks), "ps_ids": ps_ids, "region": sr,
                "gaps": [(block_snps[i][-1] + 1, ps_ids[i + 1])
                         for i in range(n_gaps)],
                # with alternating flips every adjacent block pair disagrees
                "expected_decisions": [1 if trans else 0] * n_gaps,
            })
            self.regions.append(sr)

    def read_cost(self, ci: int) -> float:
        """Chromosome ci's bases drawn: its reads times their length."""
        _, read_stagger, per_chrom, _ = self.chrom_args
        kw = dict(ref_len=self.ref_len, read_stagger=read_stagger)
        if per_chrom is not None:
            kw.update(per_chrom[ci])
        c = SynthConfig(**kw)
        return 2 * max(c.ref_len - c.read_len, 0) / c.read_stagger * c.read_len

    def writer(self) -> BamWriter:
        if self.w is None:
            self.w = BamWriter(self.bam, [sr.cfg.chrom for sr in self.regions],
                               [sr.cfg.ref_len for sr in self.regions],
                               header_text="@HD\tVN:1.6\tSO:coordinate\n",
                               threads=self.bam_threads,
                               keep_index_info=True)
        return self.w

    def write_serial(self, ci: int) -> None:
        """Chromosome ci's reads made here and written."""
        w = self.writer()
        for r in self.regions[ci].make_reads(
                tagged=True, hp_label_fn=_hp_labeller(self.blocks,
                                                      self.trans_alternate)):
            r.refID = ci
            r.qname = f"c{ci}_" + r.qname
            w.write(r)

    def write_part(self, ci: int, meta, chunk_bytes: int = 64 << 20) -> None:
        """Chromosome ci's records from the part a worker made
        (_make_chrom_part), in make_reads' order, then the part removed."""
        import mmap
        import zlib
        w = self.writer()
        part = os.path.join(self.parts, f"chr{ci}.part")
        if meta:
            with open(part, "rb") as f, mmap.mmap(
                    f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
                buf, metas = bytearray(), []
                for pos, endpos, off, n_z, n, unmapped in meta:
                    metas.append((ci, pos, endpos, len(buf), n, unmapped))
                    buf += zlib.decompress(mm[off:off + n_z])
                    if len(buf) >= chunk_bytes:
                        w.write_raw_records(buf, metas)
                        buf, metas = bytearray(), []
                if metas:
                    w.write_raw_records(buf, metas)
        os.remove(part)

    def finish(self):
        """The BAM closed and indexed, then the VCF: (bam, vcf, truths)."""
        w = self.writer()
        w.close()
        w.build_index(n_ref=self.n_chroms)
        lines = [
            "##fileformat=VCFv4.2",
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample",
        ]
        for sr, t in zip(self.regions, self.truths):
            for pos, ref, alt, hap_alt in sr.snps:
                ps = None
                flip = False
                for bi, ((lo, hi), pid) in enumerate(zip(t["blocks"],
                                                         t["ps_ids"])):
                    if lo <= pos < hi:
                        ps = pid
                        flip = self.trans_alternate and bool(bi % 2)
                        break
                if ps is None:
                    continue
                a0, a1 = (1, 0) if hap_alt == 0 else (0, 1)
                if flip:
                    a0, a1 = a1, a0
                lines.append(f"{sr.cfg.chrom}\t{pos + 1}\t.\t{ref}\t{alt}\t60"
                             f"\tPASS\t.\tGT:PS\t{a0}|{a1}:{ps}")
        with gzip.open(self.vcf, "wt") as f:
            f.write("\n".join(lines) + "\n")
        return self.bam, self.vcf, self.truths


def _make_chrom_part(part: str, ci: int, layout, read_stagger: int,
                     per_chrom, trans_alternate: bool):
    """Chromosome ci's records, made in a worker as the serial maker makes
    them (the same region, seed, SNPs and labels; make_read's draws
    untouched): each encoded and deflated (zlib, level 1) into the file
    `part` as it is drawn. Returns its records' (pos, endpos, offset in
    part, deflated length, length, unmapped) in make_reads' order (a
    stable sort by position), the seconds taken and the worker's peak RSS
    (peak_rss_mib)."""
    import zlib
    from .io.bam import bam_endpos
    from .io.bam_writer import encode_record
    t0 = time.perf_counter()
    ref_len, blocks = _block_layout(*layout)
    sr, _ = _scenario_region(ci, ref_len, blocks, read_stagger, per_chrom)
    meta = []
    off = 0
    with open(part, "wb") as f:
        for r in sr.iter_reads(tagged=True, hp_label_fn=_hp_labeller(
                blocks, trans_alternate)):
            r.refID = ci
            r.qname = f"c{ci}_" + r.qname
            raw = encode_record(r)
            z = zlib.compress(raw, 1)
            f.write(z)
            meta.append((r.pos, bam_endpos(r), off, len(z), len(raw),
                         bool(r.flag & 4)))
            off += len(z)
    meta.sort(key=lambda m: m[0])
    return dict(meta=meta, seconds=time.perf_counter() - t0,
                peak_mib=peak_rss_mib())


class _RssSampler:
    """This process's resident set (VmRSS) read every `every` seconds on a
    thread of its own while the `with` block runs; start_mib: the first
    read, peak_mib: the largest. It sees a transient that lasts longer
    than `every`, and works where /proc/self/status has no VmHWM."""

    def __init__(self, every: float = 0.1):
        import threading
        self.every, self.peak_mib = every, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> None:
        self.peak_mib = max(self.peak_mib, proc_status_mib("VmRSS"))

    def _run(self) -> None:
        while not self._stop.wait(self.every):
            self._sample()

    def __enter__(self):
        self._sample()
        self.start_mib = self.peak_mib
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()


def _make_scenarios(kws, procs: int):
    """make_multichrom_multigap_scenario(**kw) for every kw of kws at once.
    Every chromosome of every set goes to a worker of its own
    (_make_chrom_part in a spawned process), at most procs at once, the
    most bases first. Each set's regions, truths and VCF are made here;
    its BAM is written here in chromosome order as the parts come in, so
    its bytes, index and VCF are the serial maker's. A worker that fails
    stops the others and raises here with its traceback. Returns for each
    set dict(scenario=(bam, vcf, truths), seconds, write_s, chroms,
    parent_start_mib, parent_peak_mib), chroms[ci] = dict(reads, seconds,
    peak_mib) of its worker; this process's VmRSS as it started and its
    largest while it made them all (_RssSampler), the same in every
    set."""
    import shutil
    from multiprocessing.connection import wait
    t0 = time.perf_counter()
    sets = [_Scenario(**kw) for kw in kws]
    todo = sorted(((si, ci) for si, s in enumerate(sets)
                   for ci in range(s.n_chroms)),
                  key=lambda t: -sets[t[0]].read_cost(t[1]))
    for s in sets:
        os.makedirs(s.parts, exist_ok=True)
    out = [dict(scenario=None, seconds=None, write_s=0.0,
                chroms=[None] * s.n_chroms) for s in sets]
    metas = [dict() for _ in sets]  # parts made and not yet written
    written = [0] * len(sets)
    running = {}

    def start():
        while todo and len(running) < procs:
            si, ci = todo.pop(0)
            s = sets[si]
            running[(si, ci)] = Spawned(
                _make_chrom_part, os.path.join(s.parts, f"chr{ci}.part"), ci,
                *s.chrom_args)

    try:
        with _RssSampler() as rss:
            start()
            for s in sets:  # while the first workers run
                s.build_regions()
            while running:
                done = wait([sp._conn for sp in running.values()])
                for key in [k for k, sp in running.items()
                            if sp._conn in done]:
                    si, ci = key
                    got = running.pop(key).result()
                    metas[si][ci] = got.pop("meta")
                    out[si]["chroms"][ci] = dict(got,
                                                 reads=len(metas[si][ci]))
                    start()
                    # each part whose predecessors are written, in order
                    s, t1 = sets[si], time.perf_counter()
                    while written[si] in metas[si]:
                        s.write_part(written[si], metas[si].pop(written[si]))
                        written[si] += 1
                    if written[si] == s.n_chroms:
                        out[si]["scenario"] = s.finish()
                        out[si]["seconds"] = time.perf_counter() - t0
                    out[si]["write_s"] += time.perf_counter() - t1
    finally:
        for sp in running.values():
            sp.stop()
        for s in sets:
            shutil.rmtree(s.parts, ignore_errors=True)
    for o in out:
        o.update(parent_start_mib=rss.start_mib, parent_peak_mib=rss.peak_mib)
    return out


def make_multichrom_multigap_scenario(tmpdir: str, n_chroms: int = 2,
                                      n_blocks: int = 4,
                                      block_len: int = 60_000,
                                      gap_len: int = 30_000,
                                      read_stagger: int = 700,
                                      per_chrom=None,
                                      bam_threads: int = 1,
                                      bam_name: str = "multichrom.bam",
                                      trans_alternate: bool = False):
    """n_chroms chromosomes x (n_blocks-1) joinable gaps each, ONE BAM/VCF.

    The multi-host e2e fixture (VERDICT r1 item 6b): under round-robin gap
    assignment every process decides gaps on every chromosome, so the
    decision/tag merge interleaving is exercised at n>1 gaps per host and
    >1 chromosomes (the round-1 fixture had a single gap, leaving host 1
    idle). Returns (bam, vcf, truths per chrom).

    per_chrom: optional list of SynthConfig-kwarg dicts (one per
    chromosome) to vary coverage / CpG density / read length across
    chromosomes — the heterogeneity knob for the scale benchmark.

    trans_alternate: odd-index blocks get hap-swapped GT labels and the
    reads in their phase domain get swapped HP tags (the generalization of
    make_two_block_scenario's trans=True to many blocks) — EVERY gap's
    truth is then a trans join (simulated switch error at each gap,
    blockjoin.c:5044-5084's 'swapped' verdict path). A block's phase
    domain starts at the previous block's end, so reads starting inside a
    gap carry the next block's labels, matching the two-block fixture's
    `start >= gap[0]` rule. Truths gain "expected_decisions".

    make_datasets makes the same bytes and truths with the chromosomes in
    parallel."""
    s = _Scenario(tmpdir, n_chroms=n_chroms, n_blocks=n_blocks,
                  block_len=block_len, gap_len=gap_len,
                  read_stagger=read_stagger, per_chrom=per_chrom,
                  bam_threads=bam_threads, bam_name=bam_name,
                  trans_alternate=trans_alternate)
    s.build_regions()
    for ci in range(s.n_chroms):
        s.write_serial(ci)
    return s.finish()


# The accuracy and scale datasets, as the JAX package's bench.py
# (build_scale_dataset) and tools/accuracy_scale.py define them: the same
# parameter dicts, so the same .bench_data/<key>/ cache serves both.
_SCALE_CHROMS = [
    {"read_stagger": 700, "cpg_every": 100, "read_len": 20_000},
    {"read_stagger": 1000, "cpg_every": 120, "read_len": 20_000,
     "noise": 0.02, "nocall": 0.02},
    {"read_stagger": 1400, "cpg_every": 160, "read_len": 20_000},
    {"read_stagger": 2000, "cpg_every": 200, "read_len": 20_000,
     "noise": 0.03, "nocall": 0.03},
]
# ~220x: a gap window holds ~1.6k reads, the R=1792 bucket
_DENSE_CHROM = {"read_stagger": 180, "cpg_every": 120, "read_len": 20_000,
                "noise": 0.02}
NOISE_LEVELS = (0.05, 0.10, 0.15, 0.20, 0.25)


def scale_params(scale: int) -> dict:
    """The BENCH_SCALE=scale dataset (bench.py build_scale_dataset): four
    chromosomes at 19-56x, and for scale > 1 a dense ~220x fifth; 50 *
    scale gaps a chromosome."""
    per_chrom = [dict(c) for c in _SCALE_CHROMS]
    if scale > 1:
        per_chrom.append(dict(_DENSE_CHROM))
    return dict(n_blocks=50 * scale + 1, block_len=60_000, gap_len=30_000,
                per_chrom=per_chrom)


def trans_params(scale: int) -> dict:
    """The trans-truth set at BENCH_SCALE=scale (tools/accuracy_scale.py
    main_trans): scale_params(scale) marked trans; every gap's truth is a
    trans join (make_multichrom_multigap_scenario trans_alternate)."""
    return dict(scale_params(scale), trans=True)


def dense_params(noise: float) -> dict:
    """One dense ~220x chromosome of 36 blocks at the given noise
    (tools/accuracy_scale.py main_noise)."""
    return dict(n_blocks=36, block_len=60_000, gap_len=30_000,
                per_chrom=[{"read_stagger": 180, "cpg_every": 120,
                            "read_len": 20_000, "noise": noise,
                            "nocall": 0.05}])


def dataset_key(params: dict) -> str:
    """The cache key of a dataset: sha1 of its sorted JSON, 12 hex digits."""
    import hashlib
    return hashlib.sha1(json.dumps(params, sort_keys=True)
                        .encode()).hexdigest()[:12]


def make_datasets(root: str, specs):
    """Every dataset of `specs`, each a (params, bam name, trans_alternate)
    triple, under <root>/.bench_data/<dataset_key(params)>/: those whose
    BAM, index or VCF is missing are made at once, every chromosome of
    every set dealt to one pool of spawned workers, as many at once as
    this host has cores, the most bases first; each set's BAM is written
    in this process, in chromosome order, as its chromosomes come in. The
    pool's workers are processes of this one, which must not be a daemon
    (a testing.Spawned child is one). For each spec a dict: bam, vcf,
    n_gaps, seconds (from the start of this call to the set's VCF; 0 when
    cached), write_s (this process's writing of the BAM, index and VCF),
    chroms (for each chromosome of a made set: its reads, its worker's
    seconds and peak RSS in MiB), parent_start_mib and parent_peak_mib
    (this process's resident set as it started making and its largest
    while it made the sets, MiB; 0 when cached)."""
    made, todo, kws = [], {}, []
    for params, bam_name, trans_alternate in specs:
        d = os.path.join(root, ".bench_data", dataset_key(params))
        bam = os.path.join(d, bam_name)
        vcf = os.path.join(d, "multichrom.vcf.gz")
        made.append(dict(bam=bam, vcf=vcf, seconds=0.0, write_s=0.0,
                         chroms=[], parent_start_mib=0.0,
                         parent_peak_mib=0.0, n_gaps=len(params["per_chrom"])
                         * (params["n_blocks"] - 1)))
        if bam in todo or all(os.path.exists(p)
                              for p in (bam, vcf, bam + ".bai")):
            continue
        os.makedirs(d, exist_ok=True)
        todo[bam] = len(kws)
        kws.append(dict(
            tmpdir=d, n_blocks=params["n_blocks"],
            block_len=params["block_len"], gap_len=params["gap_len"],
            per_chrom=params["per_chrom"],
            bam_threads=max(2, os.cpu_count() or 2), bam_name=bam_name,
            trans_alternate=trans_alternate))
    if kws:
        sets = _make_scenarios(kws, os.cpu_count() or 1)
        for m in made:
            if m["bam"] in todo:
                got = sets[todo[m["bam"]]]
                m.update((k, got[k]) for k in (
                    "seconds", "write_s", "chroms", "parent_start_mib",
                    "parent_peak_mib"))
    return made


def cached_dataset(root: str, params: dict, bam_name: str,
                   trans_alternate: bool = False):
    """(bam, vcf, n_gaps, seconds spent making it) of the dataset `params`
    under <root>/.bench_data/<dataset_key(params)>/, made there first
    (make_datasets) if the BAM, its index or the VCF is missing (0 seconds
    when cached)."""
    m, = make_datasets(root, [(params, bam_name, trans_alternate)])
    return m["bam"], m["vcf"], m["n_gaps"], m["seconds"]


def proc_status_mib(field: str, status: str = "/proc/self/status") -> float:
    """A memory field of this process's `status` file (VmRSS: the resident
    set now; VmHWM: its peak), in MiB. Raises where the file or the field
    is missing."""
    with open(status) as f:
        for line in f:
            if line.startswith(field + ":"):
                return int(line.split()[1]) / 1024
    raise RuntimeError(f"{status} has no {field}")


def _inherited_peak_mib() -> float:
    """ru_maxrss at this module's import where it stands above the
    resident set then, else 0 (MiB): the peak that a process started by
    fork and exec carries from its parent."""
    import resource
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    try:
        rss = proc_status_mib("VmRSS")
    except (OSError, RuntimeError):
        return peak
    return peak if peak > rss + 64 else 0.0


_INHERITED_PEAK_MIB = _inherited_peak_mib()


def peak_rss_mib(status: str = "/proc/self/status") -> float:
    """This process's own peak resident set, MiB: VmHWM, where `status`
    has it. Where it has none (the card host's kernel reports VmSize,
    VmRSS and VmData only), ru_maxrss, but only where it stands above the
    peak this process inherited: a process started by fork and exec from
    a large one (multiprocessing's spawn) starts there at its parent's
    peak, one forked from a small one (Spawned's forkserver) at that
    one's ~20 MiB. Raises otherwise."""
    import resource
    try:
        return proc_status_mib("VmHWM", status)
    except (OSError, RuntimeError):
        pass
    peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    if peak <= _INHERITED_PEAK_MIB:
        raise RuntimeError(
            f"{status} has no VmHWM, and ru_maxrss ({peak:.0f} MiB) is no "
            f"more than the peak this process inherited "
            f"({_INHERITED_PEAK_MIB:.0f} MiB)")
    return peak


def _spawned_main(conn, fn, args, env):
    os.environ.clear()
    os.environ.update(env)
    try:
        out = ("ok", fn(*args))
    except BaseException:
        import traceback
        out = ("err", traceback.format_exc())
    conn.send(out)
    conn.close()


class Spawned:
    """fn(*args) in a process of its own, started at once, with this
    process's environment as it is now (or `environ`, a copy taken where
    no thread was changing it) and `env` (pairs) on top: one
    chromosome's worker of make_datasets' pool, or a run whose peak RSS
    must be its own. The child is forked from multiprocessing's
    forkserver, a small process that imports nothing heavy and touches no
    device, so the child's ru_maxrss starts at that server's ~20 MiB, not
    at this process's peak (peak_rss_mib), and it may use a GPU. The
    server keeps the environment it started with, so the child's is sent
    with it. result() waits for what fn
    returned (a RuntimeError with the child's traceback where it raised
    or died); stop() kills the child if it still runs. The child is a
    daemon: it can start no process of its own, and it is stopped when
    its parent exits."""

    def __init__(self, fn, *args, env=(), environ=None):
        import multiprocessing
        ctx = multiprocessing.get_context("forkserver")
        self._conn, child = ctx.Pipe(duplex=False)
        self.proc = ctx.Process(
            target=_spawned_main,
            args=(child, fn, args,
                  {**(os.environ if environ is None else environ),
                   **dict(env)}), daemon=True)
        self.proc.start()
        child.close()
        self._out = None

    def result(self, timeout=None):
        if self._out is None:
            if not self._conn.poll(timeout):
                self.stop()
                raise RuntimeError(f"{self.proc.name} ran over {timeout} s")
            try:
                self._out = self._conn.recv()
            except EOFError:
                self._out = ("err", f"{self.proc.name} died")
            self.proc.join()
        kind, out = self._out
        if kind == "err":
            raise RuntimeError(f"{out} (exit code {self.proc.exitcode})")
        return out

    def stop(self):
        if self.proc.is_alive():
            self.proc.kill()
        self.proc.join()


def make_multi_block_scenario(tmpdir: str, n_blocks: int = 6,
                              block_len: int = 60_000, gap_len: int = 30_000,
                              cfg: Optional[SynthConfig] = None):
    """n_blocks phase blocks separated by variant-free gaps; methylation is
    informative everywhere, so every gap should join cis.
    Returns (bam_path, vcf_path, truth dict with gaps list)."""
    import os
    margin = 5_000
    ref_len = margin * 2 + n_blocks * block_len + (n_blocks - 1) * gap_len
    cfg = cfg or SynthConfig(ref_len=ref_len)
    cfg.ref_len = ref_len
    sr = SynthRegion(cfg)
    blocks = []
    p = margin
    for _ in range(n_blocks):
        blocks.append((p, p + block_len))
        p += block_len + gap_len
    snp_pos = []
    for lo, hi in blocks:
        q = lo
        while q < hi:
            for r in range(q, min(q + 200, cfg.ref_len)):
                if sr.ref[r] == "A":
                    snp_pos.append(r)
                    break
            q += 2_000
    sr.add_snps(snp_pos, [i % 2 for i in range(len(snp_pos))])

    block_snps = [[s for s in snp_pos if lo <= s < hi] for lo, hi in blocks]
    ps_ids = [bs[0] + 1 for bs in block_snps]

    def ps_of_pos(pos):
        for (lo, hi), ps in zip(blocks, ps_ids):
            if lo <= pos < hi:
                return ps
        return None

    recs = sr.make_reads(tagged=True)
    bam = os.path.join(tmpdir, "multi.bam")
    vcf = os.path.join(tmpdir, "multi.vcf.gz")
    sr.write_bam(bam, recs)
    sr.write_vcf(vcf, ps_of_pos)
    gaps = [(block_snps[i][-1] + 1, ps_ids[i + 1]) for i in range(n_blocks - 1)]
    truth = {"gaps": gaps, "ps_ids": ps_ids, "blocks": blocks, "region": sr,
             "n_reads": len(recs)}
    return bam, vcf, truth


def make_two_block_scenario(tmpdir: str, trans: bool = False,
                            tagged: bool = True,
                            cfg: Optional[SynthConfig] = None,
                            uninformative: Optional[Tuple[int, int]] = None,
                            frac_clipped: float = 0.0,
                            frac_indel: float = 0.0):
    """Standard fixture: two phase blocks separated by a variant-free gap.

    Block1 variants in [5k, 80k), gap (no SNPs) in [80k, 120k), block2 in
    [120k, 195k). CpG methylation is informative everywhere, so the joiner
    should bridge the gap. With trans=True, block2's GT/HP labels are swapped
    (simulated switch error) -> expected decision 'trans'.
    Returns (bam_path, vcf_path, region, truth dict).
    """
    import os
    cfg = cfg or SynthConfig()
    sr = SynthRegion(cfg)
    if uninformative is not None:
        # wipe haplotype-specific methylation in this range (both haps
        # unmethylated) -> no usable methmer sites -> the joiner must bail
        sr.set_uninformative(*uninformative)
    b1 = (5_000, 80_000)
    gap = (80_000, 120_000)
    b2 = (120_000, 195_000)
    # SNPs on 'A' bases every ~2kb inside blocks
    snp_pos = []
    for lo, hi in (b1, b2):
        p = lo
        while p < hi:
            for q in range(p, min(p + 200, cfg.ref_len)):
                if sr.ref[q] == "A":
                    snp_pos.append(q)
                    break
            p += 2_000
    hap_with_alt = [i % 2 for i in range(len(snp_pos))]
    sr.add_snps(snp_pos, hap_with_alt)

    block1_snps = [p for p in snp_pos if b1[0] <= p < b1[1]]
    block2_snps = [p for p in snp_pos if b2[0] <= p < b2[1]]
    ps1 = block1_snps[0] + 1
    ps2 = block2_snps[0] + 1

    def ps_of_pos(pos):
        if b1[0] <= pos < b1[1]:
            return ps1
        if b2[0] <= pos < b2[1]:
            return ps2
        return None

    def flip(pos):
        return trans and pos >= b2[0]

    def hp_label_fn(start, hap):
        # reads are HP-tagged consistently with the VCF phase of their block;
        # for the trans scenario every read right of block1 (i.e. in block2's
        # phase domain, incl. right-boundary reads spanning the gap end) gets
        # swapped labels
        if trans and start >= gap[0]:
            return (1 - hap) + 1
        return hap + 1

    recs = sr.make_reads(tagged=tagged,
                         hp_label_fn=hp_label_fn if tagged else None,
                         frac_clipped=frac_clipped, frac_indel=frac_indel)
    bam = os.path.join(tmpdir, "synth.bam")
    vcf = os.path.join(tmpdir, "synth.vcf.gz")
    sr.write_bam(bam, recs)
    sr.write_vcf(vcf, ps_of_pos, flip_gt_in_block=flip)
    truth = {
        "gap": (block1_snps[-1] + 1, ps2),  # (last var of block1, PS of block2), 1-based
        "ps1": ps1, "ps2": ps2,
        "expected_decision": 1 if trans else 0,
        "region": sr,
        "blocks": (b1, b2),
    }
    return bam, vcf, truth


N_FUZZ = 8        # trials of the sweep that tests/test_engine_fused3.py runs
N_FUZZ_CARD = 11  # plus the three shapes below, run on the card only


def fuzz_args(trial: int):
    """One trial of a randomized loop batch. Trials 0-7 are the sweep of
    tests/test_engine_fused3.py: 8 lanes with a dead lane (n_reads = 0)
    and a full one, odd D, tiny R/S, and every fourth trial with
    nc_cap == n_cand. Trial 8 has the shape of the dense windows of
    bench.py's BENCH_SCALE=5 set (R=1792, D=8, NC=64); trial 9 a
    dictionary wider than int8 (D=256, int32 ids), whose count table is
    too large for shared memory; trial 10 rows of S=100 int8 ids, not a
    multiple of 16 bytes, so the loop kernel copies them with loads.
    Returns (numpy args in the engines' order, D, nc_cap)."""
    rng = np.random.default_rng(1000 + trial)
    G = 8
    if trial == 8:
        R, S, D, n_cand = 1792, 1536, 8, 50
    elif trial == 9:
        R, S, D, n_cand = 96, 128, 256, 12
    elif trial == 10:
        R, S, D, n_cand = 80, 100, 4, 14
    else:
        R = int(rng.integers(2, 7)) * 16
        S = int(rng.integers(1, 5)) * 32
        D = int(rng.choice([4, 8, 16]))
        n_cand = 16 if trial % 4 == 3 else int(rng.integers(2, 17))
    nc_cap = ((n_cand + 15) // 16) * 16
    ids = rng.integers(-1, D, size=(G, R, S)).astype(
        np.int8 if D <= 127 else np.int32)
    has_mmr = rng.random((G, R)) < 0.9
    ids[~has_mmr] = -1
    hp_init = np.full((G, R), 2, np.int32)
    n_seed = int(rng.integers(4, 12))
    hp_init[:, :n_seed] = rng.integers(0, 2, size=(G, n_seed))
    seed_ok = hp_init <= 1
    n_reads = rng.integers(0, R + 1, size=G).astype(np.int32)
    n_reads[0] = 0                       # dead lane
    n_reads[1] = R                       # full lane
    n_sites = rng.integers(1, S + 1, size=G).astype(np.int32)
    q_break = n_reads.copy()
    min0 = np.minimum(rng.integers(0, 4, size=G), n_sites - 1).astype(np.int32)
    max0 = np.minimum(min0 + rng.integers(0, 8, size=G),
                      n_sites - 1).astype(np.int32)
    cov = rng.integers(1, 6, size=G).astype(np.int32)
    args = (ids, has_mmr, hp_init, seed_ok, n_reads, n_sites, q_break,
            min0, max0, cov, np.full(G, n_cand, np.int32),
            np.full(G, 2 * R + 16, np.int32))
    return args, D, nc_cap


def wide_args(n_cand: int, G: int = 4, S: int = 64, D: int = 4,
              max_iters: int = 24):
    """A batch whose candidate set is wider than any fuzz trial's: nc_cap =
    round_up(n_cand, 16) slots (`methphase -n 600` packs 608), R = nc_cap +
    96 rows of random ids in [-1, D) (has_mmr 0.9), the first 8 rows seeds;
    lane 0 dead, the others hold every row, so each iteration scores n_cand
    candidates; max_iters caps the loop. Returns (numpy args in the
    engines' order, D, nc_cap)."""
    rng = np.random.default_rng(2000 + n_cand)
    nc_cap = ((n_cand + 15) // 16) * 16
    R = nc_cap + 96
    ids = rng.integers(-1, D, size=(G, R, S)).astype(np.int8)
    has_mmr = rng.random((G, R)) < 0.9
    ids[~has_mmr] = -1
    hp_init = np.full((G, R), 2, np.int32)
    hp_init[:, :8] = rng.integers(0, 2, size=(G, 8))
    n_reads = np.full(G, R, np.int32)
    n_reads[0] = 0                       # dead lane
    n_sites = rng.integers(S // 2, S + 1, size=G).astype(np.int32)
    min0 = rng.integers(0, 4, size=G).astype(np.int32)
    max0 = (min0 + rng.integers(0, 8, size=G)).astype(np.int32)
    args = (ids, has_mmr, hp_init, hp_init <= 1, n_reads, n_sites,
            n_reads.copy(), min0, max0,
            rng.integers(1, 6, size=G).astype(np.int32),
            np.full(G, n_cand, np.int32), np.full(G, max_iters, np.int32))
    return args, D, nc_cap


# Crafted lanes whose first pick hinges on how the f32 ratios cnt/sum are
# summed. Each site is (c, s, h): c hap-0 seed reads carry mer id 0 there,
# s - c carry id 1, h hap-1 seed reads carry id 2; every candidate carries
# id 0 on its run of sites.
#  - "gate": ratios 3/6, 5/6, 5/6, 5/6 sum to 3.0 exactly, but to
#    2.9999998 added one by one in f32; score1 is 0 with l1 = 0, so the
#    `diff < 3.0 and l < 3` gate decides whether the read is tagged.
#  - "tie": two candidates hold the same ratios 8/9, 4/9, 3/6 in opposite
#    site order: equal exact sums (a tie, to the higher read), but
#    1.8333334 and 1.8333333 added one by one in f32.
NEAR_TIE_LANES = {
    "gate": dict(sites=[(3, 6, 0), (5, 6, 0), (5, 6, 0), (5, 6, 0)],
                 cands=[[0, 1, 2, 3]]),
    "tie": dict(sites=[(8, 9, 1), (4, 9, 1), (3, 6, 1), (3, 6, 1),
                       (4, 9, 1), (8, 9, 1)],
                cands=[[0, 1, 2], [3, 4, 5]]),
}


def near_tie_args(G: int = 8, R: int = 64, S: int = 32):
    """The NEAR_TIE_LANES as one batch of G lanes (the rest dead), D = 4,
    max_iters = 1, so hp holds each lane's first pick. Each lane's seeds
    are one-site reads (site, id, hap) in rows [0, n_seed), then its
    candidates; one more site with an id-3 seed closes the valid range
    (cov = 1). Returns (numpy args in the engines' order, D, nc_cap,
    {name: (lane, seeds, first candidate row)})."""
    ids = np.full((G, R, S), -1, np.int8)
    hp_init = np.full((G, R), 2, np.int32)
    n_reads = np.zeros(G, np.int32)
    n_sites = np.ones(G, np.int32)
    layout = {}
    for g, (name, spec) in enumerate(NEAR_TIE_LANES.items()):
        k = len(spec["sites"])
        seeds = []
        for i, (c, s, h) in enumerate(spec["sites"]):
            seeds += [(i, 0, 0)] * c + [(i, 1, 0)] * (s - c) + [(i, 2, 1)] * h
        seeds.append((k, 3, 0))
        for r, (i, d, hap) in enumerate(seeds):
            ids[g, r, i] = d
            hp_init[g, r] = hap
        for j, run in enumerate(spec["cands"]):
            ids[g, len(seeds) + j, run] = 0
        n_reads[g] = len(seeds) + len(spec["cands"])
        n_sites[g] = k + 1
        layout[name] = (g, seeds, len(seeds))
    z = np.zeros(G, np.int32)
    args = (ids, ids.max(axis=2) >= 0, hp_init, hp_init <= 1, n_reads,
            n_sites, n_reads.copy(), z, z, np.ones(G, np.int32),
            np.full(G, 14, np.int32), np.ones(G, np.int32))
    return args, 4, 16, layout


# Crafted lanes that drive the loop kernel's candidate-set upkeep. Rows are
# listed in order: "empty" candidates carry no mer (never tagged: a failed
# iteration), "good" ones carry mer id 0 on sites 0-7, where three hap-0
# seed reads carry id 0 and three hap-1 seed reads id 1 (committed to hap
# 0), "tie" ones are the two candidates of NEAR_TIE_LANES["tie"] on sites
# 8-13 (equal exact scores, a tie to the higher read).
#  - "refill": n_cand 4; the first iteration fails on four empty rows,
#    q_last passes them all and the set is empty: the prefetched row and
#    refill rounds fill it again.
#  - "miss": n_cand 20 > nc_cap 16, so a failure moves q_last past the
#    prefetched row (the speculation miss): it is dropped and the set is
#    refilled beyond q_last.
#  - "reuse_tie": n_cand 2 and max_iters 3; two good rows commit first
#    (iterations 1 and 2), so the tied pair sits in slots that were reused,
#    the higher read in the lower slot; it wins the third iteration.
CRAFTED_LANES = {
    "refill": dict(rows=["empty"] * 4 + ["seeds"] + ["good"] * 10, n_cand=4,
                   max_iters=None),
    "miss": dict(rows=["empty"] * 18 + ["seeds"] + ["good"] * 10, n_cand=20,
                 max_iters=None),
    "reuse_tie": dict(rows=["seeds", "good", "good", "tie0", "tie1"],
                      n_cand=2, max_iters=3),
}


def crafted_args(G: int = 8, R: int = 96, S: int = 32):
    """The CRAFTED_LANES as one batch of G lanes (the rest dead), D = 4,
    nc_cap = 16, cov = 1, the valid range sites 0-14 (site 14 closes it
    with an id-3 seed). Returns (numpy args in the engines' order, D,
    nc_cap, {name: (lane, {row kind: [rows]})})."""
    ids = np.full((G, R, S), -1, np.int8)
    hp_init = np.full((G, R), 2, np.int32)
    n_reads = np.zeros(G, np.int32)
    n_cand = np.full(G, 14, np.int32)
    max_iters = np.zeros(G, np.int32)
    tie = NEAR_TIE_LANES["tie"]
    seeds = [([0] * 8, 0)] * 3 + [([1] * 8, 1)] * 3   # (ids on 0-7, hap)
    tie_seeds = []
    for i, (c, n, h) in enumerate(tie["sites"]):
        tie_seeds += [(8 + i, 0, 0)] * c + [(8 + i, 1, 0)] * (n - c) \
            + [(8 + i, 2, 1)] * h
    layout = {}
    for g, (name, spec) in enumerate(CRAFTED_LANES.items()):
        r = 0
        kinds = {}
        for kind in spec["rows"]:
            if kind == "seeds":
                for mers, hap in seeds:
                    ids[g, r, :8] = mers
                    hp_init[g, r] = hap
                    r += 1
                for site, mer, hap in tie_seeds + [(14, 3, 0)]:
                    ids[g, r, site] = mer
                    hp_init[g, r] = hap
                    r += 1
                continue
            kinds.setdefault(kind, []).append(r)
            if kind == "good":
                ids[g, r, :8] = 0
            elif kind.startswith("tie"):
                ids[g, r, [8 + k for k in tie["cands"][int(kind[3])]]] = 0
            r += 1
        n_reads[g] = r
        n_cand[g] = spec["n_cand"]
        max_iters[g] = spec["max_iters"] or 2 * R + 16
        layout[name] = (g, kinds)
    z = np.zeros(G, np.int32)
    args = (ids, ids.max(axis=2) >= 0, hp_init, hp_init <= 1, n_reads,
            np.where(n_reads > 0, 15, 1).astype(np.int32), n_reads.copy(),
            z, z, np.ones(G, np.int32), n_cand, max_iters)
    return args, 4, 16, layout


def checked_step(kernel, plain, in_place=()):
    """A loop step that runs `kernel` and then `plain` on the same inputs
    and raises unless every output is equal (exact). `in_place` holds the
    positions of the arguments both update in place: `plain` gets copies
    of them taken before the kernel runs. The step returns the kernel's
    outputs and keeps .calls, .max_abs_err and .first (the first call's
    arguments, copied)."""
    import torch

    def step(*args, **kw):
        copies = [a.clone() if i in in_place else a
                  for i, a in enumerate(args)]
        if step.first is None:
            step.first = ([a.clone() for a in args], kw)
        got = kernel(*args, **kw)
        want = plain(*copies, **kw)
        pairs = zip(*((got, want) if isinstance(got, tuple)
                      else ((got,), (want,))))
        for i, (k, p) in enumerate(pairs):
            err = float((k.double() - p.double()).abs().max()) \
                if k.numel() else 0.0
            step.max_abs_err = max(step.max_abs_err, err)
            if not torch.equal(k, p):
                raise RuntimeError(
                    f"{kernel.__name__} != {plain.__name__} at call "
                    f"{step.calls}, output {i}: max |diff| {err}")
        step.calls += 1
        return got

    step.calls, step.max_abs_err, step.first = 0, 0.0, None
    return step


def bench_gap_batch(G: int = 256, n_cand: int = 14):
    """The bench-shape batch (bench.py build_real_gap_batch): the gap window
    of make_two_block_scenario, both directions, repeated over G lanes
    (D = 4, R and S rounded up to 128). Returns (GapBatch, window reads)."""
    from .core.methmer import (get_methmer_sites_and_ranges,
                               store_mmr_of_reads, wipe_mmr_of_reads)
    from .core.readset import READBACK, MmrConfig, load_reads_given_interval
    from .io.bam import BamReader
    from .kernels.engine_torch import _round_up, build_gap_device_data
    from .parallel.batch import pack_gap_batch

    with tempfile.TemporaryDirectory() as d:
        bam, vcf, truth = make_two_block_scenario(d)
        cfg = MmrConfig(cov_for_selection=5, cov_for_runtime=10)
        gs, ge = truth["gap"]
        rs = load_reads_given_interval(BamReader(bam), "chr1", gs, ge,
                                       READBACK, cfg)
        lanes = []
        for direction in (0, 1):
            ms = get_methmer_sites_and_ranges(rs, cfg, direction)
            store_mmr_of_reads(rs, ms)
            lanes.append(build_gap_device_data(
                rs, ms, direction, _round_up(rs.n, 128),
                _round_up(ms.n, 128)))
            wipe_mmr_of_reads(rs)
    return pack_gap_batch(lanes * (G // 2), [10] * G, n_cand=n_cand,
                          pad_g=G), rs.n


def args_batch(args, D: int, nc_cap: int):
    """A loop batch in the engines' argument order (fuzz_args, wide_args)
    as a dense GapBatch and its max_iters (the same for every lane)."""
    from .parallel.batch import GapBatch
    (ids, has_mmr, hp_init, seed_ok, n_reads, n_sites, q_break, min0, max0,
     cov, n_cand, max_iters) = args
    G, R = has_mmr.shape
    batch = GapBatch(ids=ids, has_mmr=has_mmr, hp_init=hp_init,
                     seed_ok=seed_ok, perm=np.tile(np.arange(R, dtype=np.int32),
                                                   (G, 1)),
                     n_reads=n_reads, n_sites=n_sites, q_break=q_break,
                     min0=min0, max0=max0, cov=cov, n_cand=n_cand, D=D,
                     nc_cap=nc_cap)
    return batch, int(max_iters[0])


# Inputs of the probe kernels' edge cases (kernels/probes.py): the ratio
# sum's ranges by batch row b (an rng draws the rest) at probe_stile's
# width S=1536, and two row copies in flight at once on two streams.
STILE_S = 1536
STILE_EDGE_RANGES = {
    "lo_below_zero": lambda b, r: (-int(r.integers(1, 400)),
                                   int(r.integers(0, 700))),
    "hi_past_s": lambda b, r: (int(r.integers(0, 1400)),
                               STILE_S + int(r.integers(1, 300))),
    "empty_lo_ge_hi": lambda b, r: ((int(r.integers(300, 900)),) * 2
                                    if b % 2 else
                                    (700, int(r.integers(0, 700)))),
    "tiles_differ_by_row": lambda b, r: (
        256 * (b % 6) + int(r.integers(0, 40)),
        256 * (b % 6) + int(r.integers(41, 300))),
    "whole_batch_empty": lambda b, r: (900, 100),
    "all_sites": lambda b, r: (-5, STILE_S + 5),
}


def stile_edge_inputs(case: str, seed: int, B: int = 32, NC: int = 16,
                      D: int = 4, S: int = STILE_S):
    """numpy inputs of the ratio sum (cnt, cids, ranges) with the ranges of
    STILE_EDGE_RANGES[case] and ids from -2 to D + 1 (outside [0, D) too)."""
    r = np.random.default_rng(seed)
    return dict(
        cnt=r.integers(0, 5, size=(B, 2 * D, S)).astype(np.float32),
        cids=r.integers(-2, D + 2, size=(B, NC, S)).astype(np.int32),
        ranges=np.array([STILE_EDGE_RANGES[case](b, r) for b in range(B)],
                        np.int32))


def _two_streams(device, calls, wants, trials: int, spin_cycles: int):
    """Run each of `calls` (no-argument functions launching one kernel and
    returning its outputs) on a stream of its own, each queued behind a
    spin kernel of its own so that both start together, `trials` times;
    returns the trials in which some output differs from its CPU tensor
    in `wants`."""
    import torch
    streams = [torch.cuda.Stream(device) for _ in calls]
    for st in streams:
        st.wait_stream(torch.cuda.current_stream(device))
    bad = []
    for trial in range(trials):
        got = []
        for st, call in zip(streams, calls):
            with torch.cuda.stream(st):
                torch.cuda._sleep(spin_cycles)
                got.append(call())
        torch.cuda.synchronize(device)
        if not all(torch.equal(g.cpu(), w) for outs, ws in zip(got, wants)
                   for g, w in zip(outs, ws)):
            bad.append(trial)
    return bad


def row_copy_two_streams(device, trials: int, spin_cycles: int = 200_000):
    """Two row_copy launches in flight at once, on two streams (each
    queued behind a spin kernel of its own so that both start together);
    returns the trials whose lane sums or totals differ from the plain
    version's (an empty list when each launch kept its own total)."""
    from .kernels import probes as kp
    W, NB = 8, 8
    src = [torch_from((np.arange(8 * 64 * 256, dtype=np.int64)
                       .reshape(8, 64, 256) % (7 + k) - k).astype(np.int32))
           for k in (1, 2)]
    rows = [torch_from(np.asarray(v, np.int32))
            for v in ([0, 5, 9, 13, 17, 21, 25, 56], [56, -1, 3, 7, 11, 40,
                                                      44, 48])]
    slots = torch_from(np.asarray([0, 1, -1, 0, 0, 0, 0, 0], np.int32))
    wants = [kp.row_copy_plain(s, r, slots, W=W, NB=NB)[:2]
             for s, r in zip(src, rows)]
    dev = [(s.to(device), r.to(device), slots.to(device))
           for s, r in zip(src, rows)]
    calls = [lambda a=a: kp.row_copy(*a, W=W, NB=NB)[:2] for a in dev]
    return _two_streams(device, calls, wants, trials, spin_cycles)


def v3_inputs(L: int, R: int, S: int, seed: int, *, none_eligible=()):
    """numpy inputs of the v3 loop (ids (L,R,S), hp (L,R), int32): ids over
    the whole int32 range, so that the sums wrap; hp in {0, 1, 2}, with the
    lanes in `none_eligible` holding no eligible read (hp == 2)."""
    r = np.random.default_rng(seed)
    ids = r.integers(-2 ** 31, 2 ** 31, size=(L, R, S), dtype=np.int64)
    hp = r.integers(0, 3, size=(L, R))
    hp[list(none_eligible)] = np.where(hp[list(none_eligible)] == 2, 1,
                                       hp[list(none_eligible)])
    return dict(ids=ids.astype(np.int32), hp=hp.astype(np.int32))


def v3_loop_two_streams(device, trials: int, spin_cycles: int = 200_000):
    """Two v3_loop launches in flight at once, on two streams, with slots
    reused (n_iter 9 > NC 4) and sums that wrap; returns the trials whose
    outputs differ from the plain version's (an empty list when each launch
    kept its own slots and sums)."""
    from .kernels import probes as kp
    ins = [v3_inputs(8, 64, 256, seed) for seed in (1, 2)]
    wants = [(kp.v3_loop_plain(torch_from(i["ids"]), torch_from(i["hp"]),
                               NC=4, n_iter=9),) for i in ins]
    dev = [(torch_from(i["ids"]).to(device), torch_from(i["hp"]).to(device))
           for i in ins]
    calls = [lambda a=a: (kp.v3_loop(*a, NC=4, n_iter=9),) for a in dev]
    return _two_streams(device, calls, wants, trials, spin_cycles)


def v3_loop_bookkeeping(ids, hp, NC: int, n_iter: int):
    """v3_loop_kernel's bookkeeping in numpy: a lane's eligible reads (hp
    == 2) as 32-bit ballot words; each iteration's pick the first set bit
    at or after read 2 it (else R - 1); a sum kept per slot, and the total
    as total += new - slot_sum[it % NC] in uint32 arithmetic; acc += total.
    Returns the (L,) int32 that the kernel writes."""
    M = 0xFFFFFFFF
    L, R, _ = ids.shape
    nw = -(-R // 32)
    elig = np.zeros((L, nw * 32), np.uint64)
    elig[:, :R] = hp == 2
    words = (elig.reshape(L, nw, 32) << np.arange(32, dtype=np.uint64)).sum(
        axis=2)
    out = np.zeros(L, np.int64)
    for l in range(L):
        slot_sum, total, acc = [0] * NC, 0, 0
        for it in range(n_iter):
            t = min(2 * it, R)
            r = R - 1
            for c in range(t >> 5, nw):
                m = int(words[l, c])
                if c == t >> 5:
                    m &= (M << (t & 31)) & M
                if m:
                    r = 32 * c + (m & -m).bit_length() - 1
                    break
            new = int(ids[l, r].astype(np.int64).sum()) & M
            total = (total + new - slot_sum[it % NC]) & M
            slot_sum[it % NC] = new
            acc = (acc + total) & M
        out[l] = acc
    return out.astype(np.uint32).view(np.int32)


def torch_from(a):
    import torch
    return torch.from_numpy(np.ascontiguousarray(a))


# The body of each process of run_processes: the CLI, then one line with
# what the process did.
_PROC_MAIN = r"""
import json, sys, time
t0 = time.perf_counter()
from pomfret_tpu_torch.parallel import batch, distributed
from pomfret_tpu_torch.utils.stats import stage_report
argv, mesh = json.loads(sys.argv[1]), json.loads(sys.argv[2])
if mesh:
    batch.production_mesh = lambda device: batch.make_gap_mesh(mesh)
from pomfret_tpu_torch.cli import main
t1 = time.perf_counter()
rc = main(argv)
st = batch.DISPATCH_STATS
print("RESULT " + json.dumps({
    "rc": rc, "import_s": t1 - t0, "wall_s": time.perf_counter() - t1,
    "stages": stage_report(3),
    "kernel_launches": st["kernel_launches"],
    "gaps_decided": st["gaps_decided"], "n_dispatches": st["n_dispatches"],
    "n_devices_last": st["n_devices_last"], "lanes_last": st["lanes_last"],
    "dist": distributed.DIST_STATS,
    "loaded": sorted(m for m in sys.modules if m.split(".")[0] in
                     ("jax", "pomfret_tpu"))}), flush=True)
sys.exit(rc)
"""


def free_port() -> int:
    """A free TCP port on the loopback interface."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(argv: Sequence[str], n_procs: int, *, env=None,
                  mesh: Optional[Sequence[str]] = None,
                  timeout: float = 600) -> List[dict]:
    """Run `pomfret-tpu-torch <argv>` in n_procs processes of one gloo
    process group on this host (POMFRET_COORDINATOR on a free loopback
    port, POMFRET_NUM_PROCS, POMFRET_PROC_ID), with `env` over this
    process's environment; OMP_NUM_THREADS defaults to the host's cores
    shared out. `mesh` (device names) replaces each process's
    production_mesh. Returns, in rank order, what each process did: rc,
    import_s (the port's and torch's imports), wall_s (the command),
    stages (utils.stats seconds), kernel_launches, gaps_decided,
    n_dispatches, n_devices_last, lanes_last, dist (DIST_STATS) and loaded
    (the jax and pomfret_tpu* modules it loaded). Raises unless every process exits 0 within
    `timeout` seconds; the others are killed then."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = dict(os.environ)
    base.setdefault("OMP_NUM_THREADS",
                    str(max(1, (os.cpu_count() or 1) // n_procs)))
    base.update(env or {})
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, base.get("PYTHONPATH")) if p)
    base.update(POMFRET_COORDINATOR=f"127.0.0.1:{free_port()}",
                POMFRET_NUM_PROCS=str(n_procs))
    # output to files, not pipes: a process blocked on a full pipe would
    # stall the others in their collectives
    logs = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
            for _ in range(n_procs)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _PROC_MAIN, json.dumps(list(argv)),
         json.dumps(list(mesh or []))],
        env=dict(base, POMFRET_PROC_ID=str(rank)), stdout=out, stderr=err,
        text=True) for rank, (out, err) in enumerate(logs)]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for rank, (p, (out, err)) in enumerate(zip(procs, logs)):
            p.wait(timeout=max(0.0, deadline - time.monotonic()))
            out.seek(0)
            err.seek(0)
            if p.returncode != 0:
                raise RuntimeError(f"process {rank} of {n_procs} exited "
                                   f"{p.returncode}: {err.read()[-3000:]}")
            line = [x for x in out.read().splitlines()
                    if x.startswith("RESULT ")]
            outs.append(json.loads(line[-1][len("RESULT "):]))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for out, err in logs:
            out.close()
            err.close()
    return outs


# ---------------------------------------------------------------------------
# The parity runs: the CLI behaviours that the JAX package's tests check on
# its own CLI (tests/test_manifest.py, test_flags.py, test_cli_extra.py,
# test_native_retag.py, test_permutation.py, test_review_regressions.py,
# test_realistic_reads.py, test_multiblock.py, test_two_chrom.py,
# test_cram.py), each a scenario and the methphase flags that reach it.
# tests/test_torch_parity_*.py run each through pomfret_tpu.cli and this
# package's CLI on the CPU, chip_smoke.py with --engine cuda, torch and
# host on the card; the outputs are compared byte for byte.

def _two_block_files(tmpdir: str, name: str, cfg: SynthConfig, **read_kw):
    """The two-block region of tests/test_realistic_reads.py and
    test_review_regressions.py, built as they build it: SNPs on 'A' bases
    every ~2 kb in [5k, 80k) and [120k, 195k), tagged reads (make_reads'
    keywords); written as <name>.bam and a phased <name>.vcf.gz (a block's
    PS its first SNP). Returns (bam, vcf, region)."""
    sr = SynthRegion(cfg)
    blocks = ((5_000, 80_000), (120_000, 195_000))
    snp = []
    for lo, hi in blocks:
        p = lo
        while p < hi:
            for q in range(p, min(p + 200, cfg.ref_len)):
                if sr.ref[q] == "A":
                    snp.append(q)
                    break
            p += 2_000
    sr.add_snps(snp, [i % 2 for i in range(len(snp))])
    recs = sr.make_reads(tagged=True, **read_kw)
    bam = os.path.join(tmpdir, f"{name}.bam")
    vcf = os.path.join(tmpdir, f"{name}.vcf.gz")
    sr.write_bam(bam, recs)
    sr.write_vcf(vcf, lambda pos: next(
        (min(q for q in snp if lo <= q < hi) + 1 for lo, hi in blocks
         if lo <= pos < hi), None))
    return bam, vcf, sr


def make_messy_scenario(tmpdir: str):
    """tests/test_realistic_reads.py's reads: 3% noise and no-calls, a 50 bp
    soft clip on 40% of the reads and a CpG-neutral indel on half of them,
    both strands. Returns (bam, vcf, region)."""
    return _two_block_files(tmpdir, "messy",
                            SynthConfig(noise=0.03, nocall=0.03, seed=5),
                            frac_clipped=0.4, frac_indel=0.5)


def make_weird_hp_scenario(tmpdir: str):
    """tests/test_review_regressions.py's reads: every read starting in
    one 700 bp step out of 7 carries the absurd HP:i:5, the others their
    haplotype's tag. Returns (bam, vcf, region)."""
    return _two_block_files(
        tmpdir, "weird", SynthConfig(seed=13),
        hp_label_fn=lambda start, hap: 5 if (start // 700) % 7 == 0
        else hap + 1)


def _write_blocks_gtf(path: str, sr: SynthRegion, blocks) -> None:
    """The phase blocks of tests/test_cli_extra.py's GTF input: one exon
    from each block's first to its last SNP."""
    with open(path, "w") as f:
        for lo, hi in blocks:
            pos = [p for (p, *_) in sr.snps if lo <= p < hi]
            s, e = pos[0] + 1, pos[-1] + 1
            f.write(f'{sr.cfg.chrom}\tPhasing\texon\t{s}\t{e}\t.\t+\t.\t'
                    f'gene_id "{s}"; transcript_id "{s}.1"\n')


def _cis_files(d: str, cram: bool = False) -> dict:
    bam, vcf, truth = make_two_block_scenario(d)
    gtf = os.path.join(d, "blocks.gtf")
    _write_blocks_gtf(gtf, truth["region"], truth["blocks"])
    out = dict(bam=bam, vcf=vcf, gtf=gtf)
    if cram:  # tests/test_cram.py's methphase input
        from .io.cram_writer import bam_to_cram
        out["cram"] = os.path.join(d, "synth.cram")
        bam_to_cram(bam, out["cram"], embed_ref=True, records_per_slice=200)
    return out


def _files(made) -> dict:
    return dict(bam=made[0], vcf=made[1])


# name -> maker(dir) -> {"bam", "vcf"[, "gtf"][, "cram"]}
PARITY_SCENARIOS = {
    "cis": _cis_files,
    "cram": lambda d: _cis_files(d, cram=True),
    "untagged": lambda d: _files(make_two_block_scenario(d, tagged=False)),
    "two_chrom": lambda d: _files(make_two_chrom_scenario(d)),
    "multi_block": lambda d: _files(make_multi_block_scenario(d, n_blocks=3)),
    "trans_alternate": lambda d: _files(make_multichrom_multigap_scenario(
        d, n_chroms=1, n_blocks=3, trans_alternate=True)),
    # tests/test_permutation.py:163's trans two-block scenario, with the
    # gap's methylation wiped from 84 kb to its end: on that weak bridge
    # the permutation runs disagree, so the vote decides (one run leaves
    # the gap unjoined, 3 join it, 7 and 11 do not), where on the JAX
    # tests' own permutation scenarios every n writes what one run writes
    "perm_bridge": lambda d: _files(make_two_block_scenario(
        d, trans=True, cfg=SynthConfig(noise=0.05, nocall=0.05, seed=13),
        uninformative=(84_000, 120_000))),
    "weird_hp": lambda d: _files(make_weird_hp_scenario(d)),
    "messy": lambda d: _files(make_messy_scenario(d)),
}


@dataclass(frozen=True)
class ParityRun:
    """One methphase run of a parity scenario: `args` besides -o,
    --engine, the phase blocks' file (`intervals`: --vcf or --gtf) and the
    alignments (`alignments`: the scenario's BAM or CRAM); `exts` are the
    outputs compared byte for byte (the manifest is compared as records).
    `resume_drop`: then a --resume run into <prefix>_resumed from this
    run's manifest without those chromosomes' lines, its last line then
    torn by `resume_tear`: "copy" appends the first half of a copy of it
    (a write cut short after the line was written whole), "cut" keeps
    only its first half (the run killed while it wrote its last gap,
    which the resume recomputes and appends to the fragment: both
    packages glue the two into one line, ROADMAP queue 3 item 14).
    `varhaptag`: also varhaptag on the alignments into <prefix>.vh.bam."""
    scenario: str
    args: Tuple[str, ...]
    exts: Tuple[str, ...] = (".mp.vcf", ".mp.gtf", ".mp.tsv")
    intervals: str = "vcf"
    alignments: str = "bam"
    resume_drop: Optional[Tuple[str, ...]] = None
    resume_tear: str = ""
    varhaptag: bool = False


_BAM_EXTS = (".mp.bam", ".mp.bam.bai")
_TSV = ("-c", "50", "--output-tsv")

PARITY_RUNS = {
    # --output-tsv --dbg --write-bam, then --resume on the whole manifest
    # with a torn copy of its last line after it: nothing is recomputed
    "flags": ParityRun("cis", ("-c", "50", "--output-tsv", "--dbg",
                               "--write-bam"),
                       (".mp.vcf", ".mp.gtf", ".mp.tsv", ".mp.dbg.read2tag",
                        *_BAM_EXTS), resume_drop=(), resume_tear="copy"),
    "untagged": ParityRun("untagged", ("-c", "50", "-u", "-U", "--write-bam"),
                          (".mp.vcf", ".mp.gtf", ".mp.input_haptag.tsv",
                           *_BAM_EXTS)),
    "gtf": ParityRun("cis", _TSV, (".mp.gtf", ".mp.tsv"), intervals="gtf"),
    "coverage": ParityRun("cis", ("--output-tsv",)),  # no -c: estimated
    "cram": ParityRun("cram", _TSV, alignments="cram", varhaptag=True),
    **{f"perm{n}_bridge": ParityRun("perm_bridge", ("-c", "50",
                                                    "--n-permutations",
                                                    str(n)),
                                    (".mp.vcf", ".mp.gtf"))
       for n in (11, 7, 3)},
    "weird_hp": ParityRun("weird_hp", _TSV),
    "messy": ParityRun("messy", _TSV, varhaptag=True),
    # then --resume with only the first half of the last gap's line
    "multi_block": ParityRun("multi_block", _TSV, resume_drop=(),
                             resume_tear="cut"),
    "trans_alternate": ParityRun("trans_alternate", _TSV),
    # -t 2 --write-bam, then --resume without chr2's line
    "two_chrom": ParityRun("two_chrom", ("-c", "50", "-t", "2",
                                         "--write-bam"),
                           (".mp.vcf", ".mp.gtf", *_BAM_EXTS),
                           resume_drop=("chr2",)),
}

VARHAPTAG_EXTS = (".vh.bam", ".vh.bam.bai", ".vh.bam.varhaptag.tsv")


def _set_environ(kv) -> None:
    for k, v in kv.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v


@contextlib.contextmanager
def _environ(**kv):
    """These variables set (None: unset) for a with-block. A thread that
    copies os.environ meanwhile may see them half set: give what it
    starts a copy taken before (Spawned's `environ`)."""
    old = {k: os.environ.get(k) for k in kv}
    _set_environ(kv)
    try:
        yield
    finally:
        _set_environ(old)


def parity_run(main, name: str, files: dict, prefix: str, engine: str,
               device: Optional[str] = None,
               native_retag: bool = True) -> dict:
    """PARITY_RUNS[name] on a scenario's files through `main` (a CLI's
    main(argv)) with --engine `engine` (and --device `device`) into
    `prefix`: the run, its resume step and its varhaptag. Each run reads
    and writes its coverage cache and CRAM spool in a directory of its own
    (<prefix>.spool); native_retag=False retags BAMs in Python
    (POMFRET_NO_NATIVE_RETAG=1). Raises on a non-zero exit. Returns the
    prefixes written, in order, the lines the resume run added to the
    manifest (None without one) and the seconds of each step."""
    run = PARITY_RUNS[name]
    spool = prefix + ".spool"
    os.makedirs(spool, exist_ok=True)
    argv = ["--engine", engine, *(["--device", device] if device else []),
            *run.args, f"--{run.intervals}", files[run.intervals],
            files[run.alignments]]
    out = {"prefixes": [prefix], "resume_added": None, "seconds": {}}

    def call(step, args):
        t0 = time.perf_counter()
        with _environ(POMFRET_SPOOL_DIR=spool,
                      POMFRET_NO_NATIVE_RETAG=None if native_retag else "1"):
            rc = main(args)
        if rc != 0:
            raise RuntimeError(f"{name} ({engine}): {' '.join(args)} exited "
                               f"{rc}")
        out["seconds"][step] = time.perf_counter() - t0

    call("methphase", ["methphase", "-o", prefix, *argv])
    if run.resume_drop is not None:
        resumed = prefix + "_resumed"
        with open(prefix + ".mp.manifest.jsonl") as f:
            lines = [ln for ln in f.read().splitlines()
                     if json.loads(ln)["ref"] not in run.resume_drop]
        torn = lines[-1][:len(lines[-1]) // 2]
        if run.resume_tear == "cut":
            lines[-1:] = []
        text = "".join(ln + "\n" for ln in lines)
        if run.resume_tear:
            text += torn
        with open(resumed + ".mp.manifest.jsonl", "w") as f:
            f.write(text)
        call("resume", ["methphase", "-o", resumed, "--resume", *argv])
        with open(resumed + ".mp.manifest.jsonl") as f:
            out["resume_added"] = f.read()[len(text):].count("\n")
        out["prefixes"].append(resumed)
    if run.varhaptag:
        call("varhaptag", ["varhaptag", "-o", prefix + ".vh.bam",
                           files["vcf"], files[run.alignments]])
    return out


def parity_scenario(name: str, tmpdir: str) -> dict:
    """PARITY_SCENARIOS[name] made in tmpdir (created), with the seconds
    it took."""
    t0 = time.perf_counter()
    os.makedirs(tmpdir, exist_ok=True)
    return dict(PARITY_SCENARIOS[name](tmpdir),
                seconds=time.perf_counter() - t0)


def parity_outputs(prefix: str, name: str) -> dict:
    """What a parity run wrote under `prefix`, to compare: each output's
    bytes by extension (None where it is missing), the manifest's records
    ({(ref, gap_i): record}, load_manifest's) and each written BAM's
    (qname, HP) by record."""
    from .io.bam import BamReader
    from .utils.manifest import load_manifest
    run = PARITY_RUNS[name]
    exts = run.exts + (VARHAPTAG_EXTS if run.varhaptag else ())
    out = {}
    for ext in exts:
        if not os.path.exists(prefix + ext):
            out[ext] = None
            continue
        if ext.endswith(".bam"):
            out["hp" + ext] = [(r.qname, r.get_tag("HP"))
                               for r in BamReader(prefix + ext).fetch_all()]
        with open(prefix + ext, "rb") as f:
            out[ext] = f.read()
    out["manifest"] = load_manifest(prefix + ".mp.manifest.jsonl")
    return out


def parity_diffs(a: dict, b: dict) -> List[str]:
    """The keys of two parity_outputs that differ: missing on one side,
    unequal, or empty on both."""
    return [k for k in sorted(set(a) | set(b))
            if k not in a or k not in b or a[k] != b[k] or not a[k]]
