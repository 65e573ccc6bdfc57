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
- The parity runs (PARITY_SCENARIOS, PARITY_RUNS, parity_run): the CLI
  behaviours of the JAX package's tests; NATIVE_CHECKS: the native IO
  library's routes, each against the Python route.
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


class RssTimeline:
    """A resident set (VmRSS of `status`: this process's, or another's
    /proc/<pid>/status) read every `every` seconds on a thread of its own
    while the `with` block runs; start_mib: the first read, peak_mib: the
    largest. It sees a transient that lasts longer than `every`, and works
    where /proc/self/status has no VmHWM. samples: (time.perf_counter(),
    MiB, *gauges) of every read, each gauge (a callable of `gauges`, by
    name) read with it; the clock is utils.stats' stage events' clock
    (memory_by_stage). Reads stop where the process has gone."""

    def __init__(self, every: float = 0.1, status: str = "/proc/self/status",
                 gauges=None):
        import threading
        self.every, self.peak_mib, self.status = every, 0.0, status
        self.gauges = dict(gauges or {})
        self.samples = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _sample(self) -> bool:
        try:
            mib = proc_status_mib("VmRSS", self.status)
        except (OSError, RuntimeError):
            return False
        self.peak_mib = max(self.peak_mib, mib)
        self.samples.append((time.perf_counter(), mib,
                             *(g() for g in self.gauges.values())))
        return True

    def _run(self) -> None:
        while not self._stop.wait(self.every):
            if not self._sample():
                return

    def __enter__(self):
        self._sample()
        self.start_mib = self.peak_mib
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._sample()

    def record(self, events=(), t0: Optional[float] = None) -> dict:
        """The timeline as JSON: seconds from t0 (the first read where
        None), MiB and gauges by read, `events` (utils.stats.STAGE_EVENTS)
        the same way, and memory_by_stage's summary of them."""
        t0 = self.samples[0][0] if t0 is None else t0
        return dict(
            fields=["s", "rss_mib", *self.gauges],
            samples=[[round(t - t0, 3), round(m, 1), *g]
                     for t, m, *g in self.samples],
            events=[[n, tag, round(a - t0, 3), round(b - t0, 3)]
                    for n, tag, a, b in events],
            **memory_by_stage(self.samples, events, t0))


def memory_by_stage(samples, events, t0: float) -> dict:
    """A run's resident set by stage and by chromosome, from its timeline
    (samples: (time, MiB, ...) in time order) and its stage events ((name,
    tag, entry, exit) on the same clock; tag the chromosome or None):
    peak_mib and peak_s (seconds from t0); open_at_peak, the stages (name
    or name:tag) open at the peak's read; by_stage[name], the largest read
    while a stage of that name was open, [MiB, s]; by_chrom[tag] the same
    over the stages tagged with it, and by_chrom_stage[tag][name] by stage
    within it; outside_mib, the largest read while no stage was open. A
    stage that no read fell in is absent."""
    ts = [t for t, *_ in samples]
    inside = [False] * len(samples)
    by_stage, by_chrom, by_chrom_stage = {}, {}, {}

    def top(d, key, k):
        if key not in d or samples[k][1] > d[key][0]:
            d[key] = [round(samples[k][1], 1), round(samples[k][0] - t0, 3)]

    for name, tag, a, b in events:
        lo, hi = bisect.bisect_left(ts, a), bisect.bisect_right(ts, b)
        if lo >= hi:
            continue
        k = max(range(lo, hi), key=lambda j: samples[j][1])
        inside[lo:hi] = [True] * (hi - lo)
        top(by_stage, name, k)
        if tag is not None:
            top(by_chrom, tag, k)
            top(by_chrom_stage.setdefault(tag, {}), name, k)
    if not samples:
        return dict(peak_mib=None)
    kp = max(range(len(samples)), key=lambda j: samples[j][1])
    tp = samples[kp][0]
    out = [m for (_, m, *_), i in zip(samples, inside) if not i]
    return dict(
        peak_mib=round(samples[kp][1], 1), peak_s=round(tp - t0, 3),
        open_at_peak=sorted({n if tag is None else f"{n}:{tag}"
                             for n, tag, a, b in events if a <= tp <= b}),
        by_stage=by_stage,
        by_chrom={t: v[0] for t, v in by_chrom.items()},
        by_chrom_stage={t: {n: v[0] for n, v in d.items()}
                        for t, d in by_chrom_stage.items()},
        outside_mib=round(max(out), 1) if out else None)


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
    largest while it made them all (RssTimeline), the same in every
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
        with RssTimeline() as rss:
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
from pomfret_tpu_torch.utils.stats import counter_report, stage_report
argv, mesh = json.loads(sys.argv[1]), json.loads(sys.argv[2])
if mesh:
    batch.production_mesh = lambda device: batch.make_gap_mesh(mesh)
from pomfret_tpu_torch.cli import main
t1 = time.perf_counter()
rc = main(argv)
st = batch.DISPATCH_STATS
print("RESULT " + json.dumps({
    "rc": rc, "import_s": t1 - t0, "wall_s": time.perf_counter() - t1,
    "stages": stage_report(3), "counters": counter_report(),
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
    stages (utils.stats seconds), counters (utils.stats.COUNTERS),
    kernel_launches, gaps_decided,
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


def make_binned_bam(path: str, ref_len: int = 2_400_000,
                    last: int = 2_230_000, step: int = 1_500,
                    span: int = 20_000, seq_len: int = 4_000, seed: int = 0,
                    pad: Optional[dict] = None) -> List[str]:
    """A sorted, indexed BAM (and `path`.bai) of one chromosome `c1` of
    `ref_len` bases, a read starting every `step` bases from 0 to `last`,
    each over `span` bases of the reference: its `seq_len` bases of
    sequence split by one deletion, so that 20 kb reads land in the BAI's
    128 kb, 1 Mb and 8 Mb bins as ONT reads do, in little room. Haplotypes
    1 and 2 alternate (HP), every third read is reverse, and every C of a
    read's own orientation carries an MM/ML call (`seed` draws the bases
    and the probabilities). pad {qname: n}: that read takes an n-byte
    (n >= 4) XP:Z tag, which moves every later record n plain bytes on.
    Returns the reads' names in file order."""
    rng = np.random.default_rng(seed)
    half = seq_len // 2
    cigar = [("M", half), ("D", span - seq_len), ("M", seq_len - half)]
    names, recs = [], []
    for i, pos in enumerate(range(0, last + 1, step)):
        qn = f"r{i:05d}"
        bases = np.frombuffer(b"ATG", dtype=np.uint8)[
            rng.integers(0, 3, seq_len)].copy()
        bases[rng.integers(0, seq_len - 1, seq_len // 25)] = ord("C")
        seq = bases.tobytes().decode()
        rev = i % 3 == 2
        n_c = (revcomp(seq) if rev else seq).count("C")
        tags = [("HP", "C", i % 2 + 1),
                ("MM", "Z", "C+m?" + ",0" * n_c + ";"),
                ("ML", "B:C", rng.integers(0, 256, n_c).tolist())]
        if pad and qn in pad:
            tags.append(("XP", "Z", "x" * (pad[qn] - 4)))
        recs.append(make_record(qn, 0, pos, seq, cigar,
                                flag=16 if rev else 0, tags=tags))
        names.append(qn)
    with BamWriter(path, ["c1"], [ref_len], keep_index_info=True) as w:
        for r in recs:
            w.write(r)
    w.build_index(n_ref=1)
    return names


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
    out = dict(bam=bam, vcf=vcf, gtf=gtf, gap=list(truth["gap"]))
    if cram:  # tests/test_cram.py's methphase input
        from .io.cram_writer import bam_to_cram
        out["cram"] = os.path.join(d, "synth.cram")
        bam_to_cram(bam, out["cram"], embed_ref=True, records_per_slice=200)
    return out


def _files(made) -> dict:
    return dict(bam=made[0], vcf=made[1])


def _untagged_files(d: str) -> dict:
    """The untagged two-block scenario, with its phase blocks also as the
    GTF (columns 1, 4 and 5) and 3-column TSV files of
    tests/test_differential.py's _write_block_files: 1-based, inclusive,
    from each block's start to its end."""
    bam, vcf, truth = make_two_block_scenario(d, tagged=False)
    out = dict(bam=bam, vcf=vcf, gtf=os.path.join(d, "blocks.gtf"),
               tsv=os.path.join(d, "blocks.tsv"), gap=list(truth["gap"]))
    chrom = truth["region"].cfg.chrom
    with open(out["gtf"], "w") as fg, open(out["tsv"], "w") as ft:
        for lo, hi in truth["blocks"]:
            fg.write(f"{chrom}\tPhasing\texon\t{lo + 1}\t{hi}\t.\t+\t.\t"
                     f'gene_id "{lo + 1}"; transcript_id "{lo + 1}.1";\n')
            ft.write(f"{chrom}\t{lo + 1}\t{hi}\n")
    return out


# name -> maker(dir) -> {"bam", "vcf"[, "gtf"][, "cram"]}
PARITY_SCENARIOS = {
    "cis": _cis_files,
    "cram": lambda d: _cis_files(d, cram=True),
    "untagged": _untagged_files,
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
    # tests/test_differential.py:122: 4 blocks of 32 kb, shorter than
    # READBACK, 20 kb apart: the gaps merge into one and the two middle
    # blocks become dropped slivers, whose variants core/recovery.py
    # re-phases
    "recovery": lambda d: _files(make_multi_block_scenario(
        d, n_blocks=4, block_len=32_000, gap_len=20_000)),
    # tests/test_differential.py:98: noisy calls, the coverage estimated
    "noisy": lambda d: _files(make_two_block_scenario(
        d, cfg=SynthConfig(noise=0.06, nocall=0.06, seed=11))),
}


@dataclass(frozen=True)
class ParityRun:
    """One methphase run of a parity scenario: `args` besides -o,
    --engine, the phase blocks' files (`intervals`: the flags among --tsv,
    --gtf and --vcf, each given the scenario's file of that name, in this
    order) and the alignments (`alignments`: the scenario's BAM or CRAM);
    `exts` are the
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
    intervals: Tuple[str, ...] = ("vcf",)
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
    "gtf": ParityRun("cis", _TSV, (".mp.gtf", ".mp.tsv"),
                     intervals=("gtf",)),
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
    # the scenarios of tests/test_differential.py that no other run
    # reaches: the dropped-sliver recovery (:122), the block sources' order
    # --tsv > --gtf > --vcf with -u (:215), the coverage estimated under
    # noise (:98) and -u -U --dbg on an untagged BAM (:229); --dbg dumps
    # the read names in insertion order in both packages
    "recovery": ParityRun("recovery", ("-c", "50", "--write-bam"),
                          (".mp.vcf", ".mp.gtf", *_BAM_EXTS)),
    "tsv_override": ParityRun("untagged", ("-c", "50", "-u"),
                              (".mp.vcf", ".mp.gtf"),
                              intervals=("tsv", "gtf", "vcf")),
    "noisy_estimator": ParityRun("noisy", (), (".mp.vcf", ".mp.gtf")),
    "untagged_dbg": ParityRun("untagged", ("-c", "50", "-u", "-U", "--dbg"),
                              (".mp.vcf", ".mp.gtf", ".mp.input_haptag.tsv",
                               ".mp.dbg.read2tag")),
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
    (POMFRET_NO_NATIVE_RETAG=1), else the environment decides. Raises on
    a non-zero exit. Returns the
    prefixes written, in order, the lines the resume run added to the
    manifest (None without one) and the seconds of each step."""
    run = PARITY_RUNS[name]
    spool = prefix + ".spool"
    os.makedirs(spool, exist_ok=True)
    argv = ["--engine", engine, *(["--device", device] if device else []),
            *run.args,
            *(a for flag in run.intervals for a in (f"--{flag}", files[flag])),
            files[run.alignments]]
    out = {"prefixes": [prefix], "resume_added": None, "seconds": {}}

    def call(step, args):
        t0 = time.perf_counter()
        with _environ(POMFRET_SPOOL_DIR=spool,
                      **({} if native_retag else
                         {"POMFRET_NO_NATIVE_RETAG": "1"})):
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


def _makers_digest() -> str:
    """The digest of this file, which holds every scenario's maker."""
    import hashlib
    with open(__file__, "rb") as f:
        return hashlib.sha1(f.read()).hexdigest()


def scenario_files(name: str, tmpdir: str) -> dict:
    """PARITY_SCENARIOS[name]'s files in tmpdir: made there (created) the
    first time, with their names in tmpdir/files.json, which later calls
    read while it names this scenario and the makers as they are now
    (_makers_digest); else the scenario is made again."""
    done = os.path.join(tmpdir, "files.json")
    key = {"scenario": name, "makers": _makers_digest()}
    if os.path.exists(done):
        with open(done) as f:
            got = json.load(f)
        if {k: got.get(k) for k in key} == key:
            return got["files"]
    os.makedirs(tmpdir, exist_ok=True)
    files = PARITY_SCENARIOS[name](tmpdir)
    with open(done + ".tmp", "w") as f:
        json.dump(dict(key, files=files), f)
    os.replace(done + ".tmp", done)
    return files


def parity_scenario(name: str, tmpdir: str) -> dict:
    """scenario_files(name, tmpdir), with the seconds it took."""
    t0 = time.perf_counter()
    return dict(scenario_files(name, tmpdir),
                seconds=time.perf_counter() - t0)


def dropped_sliver_rewrites(vcf: bytes) -> int:
    """The records of a written .mp.vcf that the dropped-sliver branch
    re-phased: GT unphased ("x/y") and PS "." (tests/test_differential.py
    :137-146's count)."""
    n = 0
    for line in vcf.decode().splitlines():
        if line.startswith("#"):
            continue
        sample = line.split("\t")[9]
        n += "/" in sample.split(":")[0] and sample.endswith(":.")
    return n


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


# ---------------------------------------------------------------------------
# The native checks: each of the native library's routes held against the
# port's Python route on the same inputs (the checks of the JAX package's
# tests/test_native.py, test_window_native.py, test_coverage.py and the
# spool and rANS cases of test_cram.py). NATIVE_CHECKS[name](work) makes
# its inputs under `work` (a scenario of PARITY_SCENARIOS in
# work/<scenario>, made once and reused), runs both routes through the
# switches the pipeline itself reads, raises on the first difference and
# returns the Python route's result. NATIVE_CHECKS[name](work, mods) runs
# only the Python route, through `mods` (port_modules()'s names bound to
# another package's modules): tests/test_torch_units_native.py holds it
# against the JAX package's. chip_smoke.py phase 5e runs every entry on the
# card host's build of the library.

def port_modules():
    """The modules that the native checks drive, by short name, and the
    methphase engine of their CLI runs: cuda where a card is present, else
    the plain loop on the CPU."""
    import types

    import torch

    from . import pipeline
    from .cli import main as cli_main
    from .core import methmer, readset, varhaptag, variants
    from .core.intervals import Storage
    from .io import (bam, bam_writer, basemod, bgzf, cram, cram_writer,
                     intervals_loader, native, rans4x8, records)
    from .kernels.engine_torch import _grid_from_arrays
    return types.SimpleNamespace(
        bam=bam, bam_writer=bam_writer, basemod=basemod, bgzf=bgzf,
        cram=cram, cram_writer=cram_writer,
        intervals_loader=intervals_loader, native=native, rans4x8=rans4x8,
        records=records, methmer=methmer, readset=readset,
        varhaptag=varhaptag, variants=variants, Storage=Storage,
        pipeline=pipeline, grid_from_arrays=_grid_from_arrays,
        cli_main=cli_main,
        engine="cuda" if torch.cuda.is_available() else "torch")


def first_difference(a, b, path="") -> str:
    """Where two results first differ, and the two values there."""
    if isinstance(a, dict) and isinstance(b, dict):
        for k in sorted(set(a) | set(b), key=repr):
            if a.get(k, KeyError) != b.get(k, KeyError):
                return first_difference(a.get(k), b.get(k), f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            if x != y:
                return first_difference(x, y, f"{path}[{i}]")
        if len(a) != len(b):
            return f"{path}: {len(a)} against {len(b)} items"
    return f"{path}: {repr(a)[:200]} against {repr(b)[:200]}"


def _same(name: str, python, native) -> None:
    if python != native:
        raise AssertionError(f"{name}: the native route differs from the "
                             "Python route at "
                             + first_difference(python, native))


def _need(ok, msg: str) -> None:
    if not ok:
        raise AssertionError(msg)


def _fresh(work: str, name: str) -> str:
    os.makedirs(work, exist_ok=True)
    return tempfile.mkdtemp(prefix=name + "_", dir=work)


def _raised(fn):
    """fn()'s result, or (type name, message) of what it raised."""
    try:
        return fn()
    except (ValueError, RuntimeError) as e:
        return (type(e).__name__, str(e))


def _payload(n: int) -> bytes:
    return np.random.default_rng(n).bytes(n) + b"tail"


def _py_inflate(m, raw: bytes) -> bytes:
    """Every BGZF block of `raw` inflated by Python's zlib."""
    out, off = [], 0
    while off < len(raw):
        payload, off = m.bgzf._inflate_block(raw, off)
        out.append(payload)
    return b"".join(out)


def _check_bgzf_inflate(work, mods=None):
    """test_native.py:17: a BGZF file's blocks inflated."""
    m = mods or port_modules()
    payload = _payload(500_000)
    p = os.path.join(_fresh(work, "bgzf"), "x.bgzf")
    with m.bgzf.BgzfWriter(p, threads=2) as w:
        w.write(payload)
    with open(p, "rb") as f:
        comp = f.read()
    py = _py_inflate(m, comp)
    _need(py == payload, "bgzf_inflate: Python's inflate lost the payload")
    if mods is None:
        _same("bgzf_inflate", py, m.native.bgzf_inflate_all(comp, n_threads=4))
        _same("bgzf_inflate", py, m.bgzf.BgzfReader(p, threads=2).read_all())
    return len(py)


def _check_bgzf_deflate(work, mods=None):
    """test_native.py:27: a payload deflated into BGZF blocks, inflated
    back."""
    m = mods or port_modules()
    payload = _payload(300_000)
    B = m.bgzf.BgzfWriter.BLOCK
    comp = b"".join(m.bgzf._deflate_block(payload[i:i + B], 6)
                    for i in range(0, len(payload), B))
    py = _py_inflate(m, comp)
    _need(py == payload, "bgzf_deflate: Python's deflate lost the payload")
    if mods is None:
        nat = m.native.bgzf_deflate_all(payload, n_threads=4)
        _need(nat is not None, "bgzf_deflate: the native deflate failed")
        _same("bgzf_deflate", py, _py_inflate(m, nat))
        p = os.path.join(_fresh(work, "bgzf"), "y.bgzf")
        with open(p, "wb") as f:
            f.write(nat + m.bgzf.BGZF_EOF)
        _same("bgzf_deflate", py, m.bgzf.BgzfReader(p).read_all())
    return len(py)


def _check_bam_scan(work, mods=None):
    """test_native.py:36: the columnar whole-BAM scan against each record
    decoded in Python."""
    m = mods or port_modules()
    p = os.path.join(_fresh(work, "scan"), "t.bam")
    recs = [m.records.make_record(
        f"r{i}", i % 2, 100 + i * 37, "ACGTACGTAC",
        [("M", 5), ("D", 3), ("M", 5)] if i % 2 else [("M", 10)],
        flag=16 if i % 3 == 0 else 0, mapq=10 + i % 50,
        tags=[("HP", "i", (i % 2) + 1), ("de", "f", 0.01 * (i % 5)),
              ("MD", "Z", "10"), ("xx", "Z", "junk")]) for i in range(40)]
    with m.bam_writer.BamWriter(p, ["c1", "c2"], [100000, 100000],
                                keep_index_info=True) as w:
        for r in recs:
            w.write(r)
    py = [(r.refID, r.pos, r.flag, r.mapq, r.l_seq, m.bam.bam_endpos(r),
           r.get_tag("HP"), float(np.float32(r.get_tag("de"))))
          for r in m.bam.BamReader(p).fetch_all()]
    _need(len(py) == len(recs), f"bam_scan: {len(py)} records read back")
    if mods is None:
        cols, _ = m.bam.BamReader(p).scan_columns()
        _need(cols is not None, "bam_scan: the native scan failed")
        _same("bam_scan", py, [
            tuple(int(cols[k][i]) for k in ("refID", "pos", "flag", "mapq",
                                            "l_seq", "endpos", "hp"))
            + (float(cols["de"][i]),) for i in range(len(cols["pos"]))])
    return py


_METH_EDGES = (  # test_native.py:112's crafted reads
    ("ACGTACGTAC", [("S", 2), ("M", 8)], "C+m?,0,0;", [200, 50], 0),
    ("CCGGACGTAC", [("S", 1), ("M", 6), ("D", 5), ("M", 3)], "C+m.,0;",
     [200], 0),
    ("ACGTACGTAC", [("M", 4), ("I", 2), ("M", 4)], "C+m,0,0;", [255, 255], 0),
    ("AACGTTACGT", [("M", 10)], "C+m?,0,0;", [220, 10], 16),
    ("ACGCGCGTAC", [("M", 3), ("D", 2), ("M", 7)], "C+m.,0;", None, 0),
    ("ACGTACGTAC", [("M", 10)], "C+m;", [], 0),
    ("ACGTACGTAC", [("M", 2), ("N", 3), ("M", 8)], "C+m?,0,0;", [200, 50], 0),
    ("CGCGCGCGCG", [("M", 10)], "C+m.,1;", [140], 16),
)


def _check_meth_decode(work, mods=None):
    """test_native.py:68: each read's 5mC calls lifted to the reference,
    on every read of the cis scenario and on crafted reads; the shapes the
    native decoder leaves to Python come back as None."""
    m = mods or port_modules()
    lo, hi = 100, 156
    recs = [r for r in m.bam.BamReader(
        scenario_files("cis", os.path.join(work, "cis"))["bam"]).fetch_all()
        if r.get_tag("MM")]
    _need(len(recs) > 100, f"meth_decode: {len(recs)} reads with MM")
    for i, (seq, cig, mm, ml, flag) in enumerate(_METH_EDGES):
        tags = [("MM", "Z", mm)] + ([("ML", "B:C", ml)] if ml is not None
                                    else [])
        recs.append(m.records.make_record(f"e{i}", 0, 1000, seq, cig,
                                          flag=flag, tags=tags))

    def python(rec):
        poss, quals, imp = m.basemod.extract_cpg_5mc_calls(rec, lo, hi)
        if not poss:
            return [], [], imp
        calls, cq = m.basemod.lift_mod_positions_to_ref(
            rec.cigar, rec.pos, 1 if rec.is_reverse else 0, list(poss),
            list(quals), rec.seq() if imp else None, rec.l_seq)
        return [c & 0xFFFFFFFF for c in calls], list(cq), imp

    def native(rec):
        mm = rec.get_tag("MM") or rec.get_tag("Mm")
        ml = rec.get_tag("ML") or rec.get_tag("Ml")
        got = m.native.meth_decode_read(
            rec.seq_packed, rec.l_seq, 1 if rec.is_reverse else 0, mm,
            ml[1] if ml else None, rec.cigar, rec.pos, lo, hi)
        # the result's arrays are reused by the next call
        return None if got is None else (got[0].tolist(), got[1].tolist(),
                                         got[2])

    py = [(r.qname, *python(r)) for r in recs]
    if mods is None:
        _same("meth_decode", py, [(r.qname, *(native(r) or (None,) * 3))
                                  for r in recs])
        for mm, ml in (("C+m,0;A+a,0;", [1, 2]), ("C+27551,0;", [9])):
            rec = m.records.make_record("fb", 0, 10, "ACGTACGTAC",
                                        [("M", 10)],
                                        tags=[("MM", "Z", mm),
                                              ("ML", "B:C", ml)])
            _need(native(rec) is None,
                  f"meth_decode: the native decoder took MM {mm}")
    return py


def _check_site_select(work, mods=None):
    """test_native.py:150: the methmer sites (both classes at least `cov`
    times) of fuzzed calls; then the sites of the cis scenario's gap window
    in both directions (POMFRET_NO_NATIVE_SITES)."""
    m = mods or port_modules()
    rng = np.random.default_rng(7)
    trials = []
    for _ in range(25):
        n = int(rng.integers(0, 5000))
        pos = rng.integers(0, 2000, size=n).astype(np.uint32)
        q = rng.integers(0, 3, size=n).astype(np.uint8)
        trials.append((pos, q, int(rng.integers(1, 8))))

    def oracle(pos, q, cov):
        uniq, cnts = np.unique(pos.astype(np.uint64) * 4 + q,
                               return_counts=True)
        positions, inv = np.unique(uniq // 4, return_inverse=True)
        cmat = np.zeros((len(positions), 3), dtype=np.int64)
        np.add.at(cmat, (inv, np.minimum(uniq % 4, 2).astype(np.int64)),
                  cnts)
        return positions[(cmat[:, 0] >= cov) & (cmat[:, 1] >= cov)].tolist()

    files = scenario_files("cis", os.path.join(work, "cis"))
    cfg = m.readset.MmrConfig(cov_for_selection=5, cov_for_runtime=10)

    def sites():
        rs = m.readset.load_reads_given_interval(
            m.bam.BamReader(files["bam"]), "chr1", *files["gap"],
            m.readset.READBACK, cfg)
        return [m.methmer.get_methmer_sites_and_ranges(
            rs, cfg, d).sites_real_poss.tolist() for d in (0, 1)]

    with _environ(POMFRET_NO_NATIVE_SITES="1"):
        py = dict(fuzz=[oracle(*t) for t in trials], window=sites())
    _need(len(py["window"][0]) > 10, "site_select: no sites in the window")
    if mods is None:
        got = []
        for t in trials:
            r = m.native.site_select(*t)
            _need(r is not None, "site_select: the native selection failed")
            got.append(r.astype(np.uint64).tolist())
        with _environ(POMFRET_NO_NATIVE_SITES=None):
            _same("site_select", py, dict(fuzz=got, window=sites()))
    return py


def _snap(rs) -> dict:
    """A ReadSet as plain values (tests/test_window_native.py's _snap)."""
    return {
        "reads": [(r.qname, r.hp, r.strand, r.length, r.start_pos,
                   r.end_pos, r.calls.tolist(), r.quals.tolist())
                  for r in rs.reads],
        "ids_left": list(rs.ids_left),
        "ids_left_strict": list(rs.ids_left_strict),
        "ids_right": list(rs.ids_right),
        "ids_right_strict": list(rs.ids_right_strict),
        "rev_order": list(rs.rev_order),
        "ref_start": rs.ref_start, "ref_end": rs.ref_end}


def _windows(m, bam, windows, cfg, raw=None, native=False):
    """The ReadSets of per-window loads, by the Python loader
    (POMFRET_NO_NATIVE_WINDOW=1) or the native one; a load that raises
    gives what it raised."""
    rd = m.bam.BamReader(bam)
    with _environ(POMFRET_NO_NATIVE_WINDOW=None if native else "1"):
        return [_raised(lambda: _snap(m.readset.load_reads_given_interval(
            rd, chrom, s, e, m.readset.READBACK, cfg, raw)))
            for chrom, s, e in windows]


def _window_check(name, m, mods, bam, windows, cfg, raw=None):
    py = _windows(m, bam, windows, cfg, raw)
    if mods is None:
        _need(m.native.native_available(), f"{name}: no native library")
        _same(name, py, _windows(m, bam, windows, cfg, raw, native=True))
    return py


def _cis_gap(work, m):
    files = scenario_files("cis", os.path.join(work, "cis"))
    return (files["bam"], *files["gap"],
            m.readset.MmrConfig(cov_for_selection=5, cov_for_runtime=10))


def _check_window_realistic(work, mods=None):
    """test_window_native.py:46: the cis scenario's gap window, one wider
    and offset, and an unknown chromosome."""
    m = mods or port_modules()
    bam, gs, ge, cfg = _cis_gap(work, m)
    py = _window_check("window_realistic", m, mods, bam,
                       [("chr1", gs, ge), ("chr1", gs - 7000, ge + 9000),
                        ("chrMissing", gs, ge)], cfg)
    _need(len(py[0]["reads"]) > 100 and py[2]["reads"] == [],
          "window_realistic: the windows' reads")
    return py


def _check_window_raw_tag(work, mods=None):
    """test_window_native.py:63: the haplotags given by read name (-u)."""
    m = mods or port_modules()
    bam, gs, ge, cfg = _cis_gap(work, m)
    names = [r.qname for r in m.bam.BamReader(bam).fetch_all()]
    raw = {qn: i % 2 for i, qn in enumerate(names[:50])}
    return _window_check("window_raw_tag", m, mods, bam, [("chr1", gs, ge)],
                         cfg, raw)


def _write_bam(m, path, ref_lens, recs, index=True):
    with m.bam_writer.BamWriter(path, [f"c{i + 1}" for i in
                                       range(len(ref_lens))],
                                ref_lens, keep_index_info=index) as w:
        for r in recs:
            w.write(r)
    if index:
        w.build_index(n_ref=len(ref_lens))
    return path


def _edge_records(m):
    """tests/test_window_native.py:73's crafted reads: filters, the MM
    shapes the native decoder leaves to Python, tag type variants."""
    mk_rec = m.records.make_record
    recs = []
    seq40 = "ACGCGTACGCGTACGCGTACGCGTACGCGTACGCGTACGC"
    for i in range(32):
        recs.append(mk_rec(
            f"fill{i}", 0, 500 + i, seq40, [("M", 40)],
            flag=16 if i % 4 == 0 else 0, mapq=60,
            tags=[("HP", "C", (i % 2) + 1), ("MM", "Z", "C+m.,0,0;"),
                  ("ML", "B:C", [250, 250])]))
    pos = 600

    def mk(qn, mm="C+m,1;", ml=(200,), tags=(), **kw):
        t = list(tags)
        if mm is not None:
            t.append(("MM", "Z", mm))
        if ml is not None:
            t.append(("ML", "B:C", list(ml)))
        recs.append(mk_rec(qn, 0, pos, seq40, [("M", 40)],
                           **{"mapq": 60, **kw}, tags=t))

    mk("hp_s", tags=[("HP", "s", 2)])
    mk("hp_zero", tags=[("HP", "C", 0)])
    mk("hp_absent")
    mk("de_ok", tags=[("de", "f", 0.05), ("HP", "C", 1)])
    mk("de_bad", tags=[("de", "f", 0.5), ("HP", "C", 1)])
    mk("fb_multi", mm="C+m,1;A+a,0;", ml=(200, 9))
    mk("fb_chebi", mm="C+27551,1;")
    mk("fb_minus", mm="C-m,1;")
    mk("fb_multicode", mm="C+mh,1;", ml=(200, 100))
    recs.append(mk_rec("mm_lower", 0, pos, seq40, [("M", 40)], mapq=60,
                       tags=[("Mm", "Z", "C+m,1;"), ("Ml", "B:C", [200])]))
    mk("ml_missing", mm="C+m,1,0;", ml=None)
    mk("mm_empty", mm="", ml=None)
    mk("mm_none", mm=None, ml=None, tags=[("HP", "C", 1)])
    mk("mapq_low", mapq=3)
    mk("secondary", flag=256)
    mk("supp", flag=2048)
    recs.append(mk_rec("rev1", 0, pos + 1, seq40, [("M", 40)], flag=16,
                       mapq=60, tags=[("MM", "Z", "C+m.,0,1;"),
                                      ("ML", "B:C", [250, 10])]))
    recs.append(mk_rec("implicit1", 0, pos + 2, "ACTTTTTTCGTTTTTTTTTT",
                       [("M", 20)], mapq=60,
                       tags=[("MM", "Z", "C+m,0,0;"),
                             ("ML", "B:C", [250, 250])]))
    recs.append(mk_rec("clip1", 0, pos + 3, seq40,
                       [("S", 4), ("M", 20), ("I", 3), ("M", 8), ("D", 6),
                        ("M", 5)], mapq=60,
                       tags=[("MM", "Z", "C+m.,0,0,0;"),
                             ("ML", "B:C", [250, 10, 200])]))
    recs.append(mk_rec("span_end", 0, 2000, seq40, [("M", 40)], mapq=60,
                       tags=[("MM", "Z", "C+m,0;"), ("ML", "B:C", [250])]))
    recs.sort(key=lambda r: r.pos)
    return recs


def _check_window_edges(work, mods=None):
    """test_window_native.py:149: the crafted reads' window: filters,
    Python-decoded MM shapes, HP tag types."""
    m = mods or port_modules()
    bam = _write_bam(m, os.path.join(_fresh(work, "edge"), "edge.bam"),
                     [100000], _edge_records(m))
    cfg = m.readset.MmrConfig(readlen_threshold=10, min_mapq=10,
                              cov_for_selection=1, cov_for_runtime=2)
    py = _window_check("window_edges", m, mods, bam, [("c1", 620, 640)], cfg)
    by = {r[0]: r for r in py[0]["reads"]}
    _need("fb_minus" in by and "fb_multi" in by
          and not {"de_bad", "mapq_low", "secondary", "supp", "mm_none",
                   "mm_empty"} & set(by)
          and (by["hp_s"][1], by["hp_zero"][1], by["hp_absent"][1])
          == (1, 254, 254), f"window_edges: reads {sorted(by)}")
    return py


def _check_window_coverage_gate(work, mods=None):
    """test_window_native.py:171: fewer than 15 reads a haplotype on the
    left wipe the window."""
    m = mods or port_modules()
    seq = "ACGCGTACGCGTACGCGTAC"
    recs = [m.records.make_record(
        f"r{i}", 0, 100 + i, seq, [("M", 20)], mapq=60,
        tags=[("HP", "C", (i % 2) + 1), ("MM", "Z", "C+m,0;"),
              ("ML", "B:C", [250])]) for i in range(8)]
    bam = _write_bam(m, os.path.join(_fresh(work, "thin"), "thin.bam"),
                     [10000], recs)
    cfg = m.readset.MmrConfig(readlen_threshold=10, min_mapq=10)
    py = _window_check("window_coverage_gate", m, mods, bam,
                       [("c1", 150, 160)], cfg)
    _need(py[0]["reads"] == [], "window_coverage_gate: reads kept")
    return py


def _check_window_duplicate_qname(work, mods=None):
    """test_window_native.py:188: a read name twice in a window raises."""
    m = mods or port_modules()
    seq = "ACGCGTACGCGTACGCGTAC"
    recs = [m.records.make_record(
        "same", 0, 100 + i, seq, [("M", 20)], mapq=60,
        tags=[("MM", "Z", "C+m,0;"), ("ML", "B:C", [250])])
        for i in range(2)]
    bam = _write_bam(m, os.path.join(_fresh(work, "dup"), "dup.bam"),
                     [10000], recs)
    cfg = m.readset.MmrConfig(readlen_threshold=10, min_mapq=10)
    py = _window_check("window_duplicate_qname", m, mods, bam,
                       [("c1", 105, 110)], cfg)
    _need(py[0][0] == "ValueError" and "duplicated read name" in py[0][1],
          f"window_duplicate_qname: {py}")
    return py


def _mmr_fuzz(m, rng, trial, with_grid):
    """One trial of test_window_native.py:205's fuzz: a site grid (a
    backward one, with runs of equal starts, on odd trials) and 1-5 reads
    with calls on it and off it."""
    n_sites = int(rng.integers(2, 40))
    pos = np.sort(rng.choice(np.arange(100, 100000, 7), size=n_sites,
                             replace=False)).astype(np.uint32)
    starts = pos.copy()
    for i in range(1, n_sites):
        if rng.random() < 0.3:
            starts[i] = starts[i - 1]
    starts = np.maximum.accumulate(starts)
    if trial % 2 == 0:
        starts = pos
    lens = rng.integers(1, 6, size=n_sites).astype(np.uint8)
    ms = m.methmer.Methmers(config=m.readset.MmrConfig(), n=n_sites,
                            sites_real_poss=pos, sites_starts=starts,
                            mmr_lens=lens)
    reads = []
    for i in range(int(rng.integers(1, 6))):
        grid = np.unique(starts)
        k = rng.integers(2, max(3, len(grid)))
        sel = np.sort(rng.choice(grid, size=min(k, len(grid)),
                                 replace=False))
        extra = rng.choice(np.arange(50, 110000, 13), size=3, replace=False)
        calls = np.unique(np.concatenate([sel, extra])).astype(np.uint32)
        quals = rng.integers(0, 3, size=len(calls)).astype(np.uint8)
        reads.append(m.readset.Read(
            i=i, qname=f"r{i}", hp=0, strand=0, length=20000,
            start_pos=int(calls[0]), end_pos=int(calls[-1]) + 1,
            calls=calls, quals=quals))
    return ms, reads


def _check_mmr_extract(work, mods=None):
    """test_window_native.py:205: each read's methmers on fuzzed site
    grids, the batch walk against the Python walk (with the store's clamp
    to the site array)."""
    m = mods or port_modules()
    U = m.readset.UINT32_MAX
    rng = np.random.default_rng(1234)
    py, nat = [], []
    for trial in range(300):
        ms, reads = _mmr_fuzz(m, rng, trial, True)
        for r in reads:
            mers, start = m.methmer._get_mmr_of_read_walk(r, ms)
            if start != U and start + len(mers) > ms.n:
                mers = mers[:ms.n - start]
                start = start if mers else U
            py.append((list(mers), start) if start != U else ([], U))
        if mods is None:
            calls = np.concatenate([r.calls for r in reads])
            quals = np.concatenate([r.quals for r in reads])
            call_n = np.asarray([len(r.calls) for r in reads],
                                dtype=np.int32)
            call_off = np.zeros(len(reads), dtype=np.int64)
            np.cumsum(call_n[:-1], out=call_off[1:])
            res = m.native.mmr_extract_reads(ms.sites_starts, ms.mmr_lens,
                                             calls, quals, call_off, call_n)
            _need(res is not None, "mmr_extract: the native walk failed")
            for j in range(len(reads)):
                o, n = int(res["off"][j]), int(res["n"][j])
                nat.append((res["mers"][o:o + n].tolist(),
                            int(res["start_i"][j])) if n else ([], U))
    if mods is None:
        _same("mmr_extract", py, nat)
    return py


def _check_store_mmr(work, mods=None):
    """test_window_native.py:255: the methmers stored on the cis gap
    window's reads, both directions (POMFRET_NO_NATIVE_MMR)."""
    m = mods or port_modules()
    bam, gs, ge, cfg = _cis_gap(work, m)
    rs = m.readset.load_reads_given_interval(
        m.bam.BamReader(bam), "chr1", gs, ge, m.readset.READBACK, cfg)

    def stored(native):
        out = []
        for d in (0, 1):
            ms = m.methmer.get_methmer_sites_and_ranges(rs, cfg, d)
            with _environ(POMFRET_NO_NATIVE_MMR=None if native else "1"):
                m.methmer.store_mmr_of_reads(rs, ms)
            out.append([(r.mmr_n, r.mmr_start_i, None if r.mmr is None
                         else r.mmr.tolist()) for r in rs.reads])
            m.methmer.wipe_mmr_of_reads(rs)
        return out

    py = stored(False)
    _need(sum(t[0] > 0 for t in py[0]) > 100, "store_mmr: no methmers")
    if mods is None:
        _same("store_mmr", py, stored(True))
    return py


def _haptags(m, bam, chrom, variants, native):
    """pre_haplotagging_read_in_one_ref's tags by read name
    (POMFRET_NO_NATIVE_VARHAPTAG), or what it raised."""
    out = {}
    with _environ(POMFRET_NO_NATIVE_VARHAPTAG=None if native else "1"):
        return _raised(lambda: m.varhaptag.pre_haplotagging_read_in_one_ref(
            m.bam.BamReader(bam), chrom, variants, out) or out)


def _varhaptag_check(name, m, mods, bam, chrom, variants):
    py = _haptags(m, bam, chrom, variants, False)
    if mods is None:
        _need(m.native.native_available(), f"{name}: no native library")
        _same(name, py, _haptags(m, bam, chrom, variants, True))
    return py


def _check_varhaptag(work, mods=None):
    """test_window_native.py:290: every read of the untagged scenario
    tagged from the VCF's phased variants."""
    m = mods or port_modules()
    files = scenario_files("untagged", os.path.join(work, "untagged"))
    vbc = {}
    m.intervals_loader.load_intervals_from_file(
        files["vcf"], m.intervals_loader.IS_VCF, m.Storage(),
        load_vcf_variants_too=True,
        haptag_callback=lambda c, v: vbc.__setitem__(c, v))
    py = _varhaptag_check("varhaptag", m, mods, files["bam"], "chr1",
                          vbc["chr1"])
    _need(len(py) > 400 and sum(v in (0, 1) for v in py.values()) > 300,
          "varhaptag: too few reads tagged")
    return py


def _check_varhaptag_edges(work, mods=None):
    """test_window_native.py:305: an invalid MD raises on both routes;
    without it, SNPs, indels, clips, a secondary read skipped."""
    m = mods or port_modules()
    X = m.variants.VAR_OP_X
    seq = "ACGTACGTACGTACGTACGT"
    mk = m.records.make_record
    recs = [
        mk("r_snp", 0, 100, seq, [("M", 20)], mapq=60,
           tags=[("MD", "Z", "5A14")]),
        mk("r_del", 0, 130, seq, [("M", 10), ("D", 3), ("M", 10)], mapq=60,
           tags=[("MD", "Z", "10^GCA10")]),
        mk("r_ins", 0, 160, seq, [("M", 8), ("I", 4), ("M", 8)], mapq=60,
           tags=[("MD", "Z", "16")]),
        mk("r_badmd", 0, 190, seq, [("M", 20)], mapq=60,
           tags=[("MD", "Z", "5?14")]),
        mk("r_sec", 0, 200, seq, [("M", 20)], flag=256, mapq=60,
           tags=[("MD", "Z", "20")]),
        mk("r_clip", 0, 220, seq, [("S", 3), ("M", 14), ("S", 3)], mapq=60,
           tags=[("MD", "Z", "2C11")]),
    ]
    kv = [m.variants.Variant(105, X, 1, (0,), 0),
          m.variants.Variant(133, X, 1, (2,), 1),
          m.variants.Variant(222, X, 1, (1,), 0)]
    d = _fresh(work, "vh")
    bad = _write_bam(m, os.path.join(d, "vh.bam"), [10000], recs)
    good = _write_bam(m, os.path.join(d, "vh2.bam"), [10000],
                      [r for r in recs if r.qname != "r_badmd"])
    py = [_varhaptag_check("varhaptag_edges", m, mods, p, "c1", kv)
          for p in (bad, good)]
    _need(py[0][0] == "ValueError" and set(py[1]) == {
        "r_snp", "r_del", "r_ins", "r_clip"}, f"varhaptag_edges: {py}")
    return py


def _check_varhaptag_missing_md(work, mods=None):
    """test_window_native.py:352: a read without MD raises on both
    routes."""
    m = mods or port_modules()
    bam = _write_bam(m, os.path.join(_fresh(work, "vh3"), "vh3.bam"),
                     [10000], [m.records.make_record(
                         "no_md", 0, 100, "ACGTACGTAC", [("M", 10)],
                         mapq=60, tags=[("HP", "C", 1)])])
    py = _varhaptag_check("varhaptag_missing_md", m, mods, bam, "c1",
                          [m.variants.Variant(105, m.variants.VAR_OP_X, 1,
                                              (0,), 0)])
    _need(py[0] == "ValueError" and "lacks MD tag" in py[1],
          f"varhaptag_missing_md: {py}")
    return py


def _chrom_source_check(name, m, mods, bam, windows, cfg, raw=None,
                        **src_kw):
    """Windows sliced from one whole-chromosome decode (ChromReadSource)
    against the Python loader's per-window loads."""
    py = _windows(m, bam, windows, cfg, raw)
    if mods is None:
        rd = m.bam.BamReader(bam)
        srcs = {}
        got = []
        for chrom, s, e in windows:
            if chrom not in srcs:
                srcs[chrom] = m.readset.ChromReadSource(rd, chrom, cfg,
                                                        **src_kw)
                _need(srcs[chrom].ok, f"{name}: no source for {chrom}")
            got.append(_snap(srcs[chrom].window(s, e, m.readset.READBACK,
                                                raw)))
        _same(name, py, got)
    return py


def _check_chrom_source(work, mods=None):
    """test_window_native.py:375: segments of 13 kb, five windows, the
    haplotags given by read name, an unknown chromosome."""
    m = mods or port_modules()
    bam, gs, ge, cfg = _cis_gap(work, m)
    windows = [("chr1", s, e) for s, e in (
        (gs, ge), (gs - 7000, ge + 9000), (100, 9000), (180_000, 199_000),
        (0, 200_000))] + [("chrMissing", gs, ge)]
    py = _chrom_source_check("chrom_source", m, mods, bam, windows, cfg,
                             seg_len=13_000)
    raw = {r[0]: i % 3 for i, r in enumerate(py[0]["reads"])}
    py.append(_chrom_source_check("chrom_source", m, mods, bam,
                                  [("chr1", gs, ge)], cfg, raw,
                                  seg_len=13_000))
    return py


def _check_chrom_source_regions(work, mods=None):
    """test_window_native.py:481: a source over the union of three
    windows' halos; no record decoded twice."""
    m = mods or port_modules()
    bam, gs, ge, cfg = _cis_gap(work, m)
    R = m.readset.READBACK
    windows = [(gs, ge), (10_000, 15_000), (170_000, 176_000)]
    regions = []
    for lo, hi in sorted((max(s - R - 1, 0), e + R) for s, e in windows):
        if regions and lo <= regions[-1][1]:
            regions[-1][1] = max(regions[-1][1], hi)
        else:
            regions.append([lo, hi])
    if mods is None:
        src = m.readset.ChromReadSource(m.bam.BamReader(bam), "chr1", cfg,
                                        seg_len=13_000, regions=regions)
        _need(src.ok and len(set(zip(src.pos.tolist(), src.qnames)))
              == len(src.pos) and bool(np.all(np.diff(src.pos) >= 0)),
              "chrom_source_regions: records decoded twice or unsorted")
    return _chrom_source_check("chrom_source_regions", m, mods, bam,
                               [("chr1", s, e) for s, e in windows], cfg,
                               seg_len=13_000, regions=regions)


def _cli_outputs(m, argv, prefix, exts, **env):
    """m's CLI run with these variables set (None: unset), and the bytes of
    each output. Modules given no native library (m.native None: the JAX
    package's, in tests/test_torch_units_native.py) take every Python
    route that has a switch (PYTHON_ROUTES)."""
    if m.native is None:
        env = {**PYTHON_ROUTES, **env}
    with _environ(**env):
        rc = m.cli_main([argv[0], "-o", prefix, *argv[1:]])
    _need(rc == 0, f"{' '.join(argv)} exited {rc}")
    out = {}
    for ext in exts:
        with open(prefix + ext, "rb") as f:
            out[ext] = f.read()
    return out


def _check_chrom_scan(work, mods=None):
    """test_window_native.py:409: methphase on the cis scenario, its windows
    sliced from whole-chromosome decodes (the batched engines' default)
    against per-window loads (POMFRET_NO_CHROM_SCAN)."""
    m = mods or port_modules()
    files = scenario_files("cis", os.path.join(work, "cis"))
    d = _fresh(work, "scan")
    argv = ["methphase", "--engine", m.engine, "-c", "50", "--vcf",
            files["vcf"], files["bam"]]
    exts = (".mp.gtf", ".mp.vcf")
    py = _cli_outputs(m, argv, os.path.join(d, "win"), exts,
                      POMFRET_NO_CHROM_SCAN="1")
    if mods is None:
        _same("chrom_scan", py, _cli_outputs(
            m, argv, os.path.join(d, "scan"), exts,
            POMFRET_NO_CHROM_SCAN=None))
    return py


def _check_mer_grid(work, mods=None):
    """test_window_native.py:446: the dense methmer-id grid, native against
    numpy, on fuzzed rows with repeated (row, site) writes."""
    import random
    m = mods or port_modules()
    rng = random.Random(99)
    py, nat = [], []
    for _ in range(40):
        n_reads = rng.randint(1, 40)
        S = rng.randint(1, 60)
        R = n_reads + rng.randint(0, 8)
        SP = S + rng.randint(0, 16)
        perm = list(range(n_reads))
        rng.shuffle(perm)
        inv_perm = np.empty(n_reads, dtype=np.int64)
        for dev_row, orig in enumerate(perm):
            inv_perm[orig] = dev_row
        rows, lens, starts, mers = [], [], [], []
        for r in range(n_reads):
            if rng.random() < 0.3:
                continue
            ln = rng.randint(1, min(S, 12))
            rows.append(r)
            lens.append(ln)
            starts.append(rng.randint(0, S - ln))
            mers.extend(rng.randint(0, 6) for _ in range(ln))
        rows, lens, starts = (np.asarray(a, dtype=np.int64)
                              for a in (rows, lens, starts))
        mers_a = np.asarray(mers, dtype=np.uint32)
        offs = np.zeros(len(rows), dtype=np.int64)
        if len(rows) > 1:
            np.cumsum(lens[:-1], out=offs[1:])
        ids, has, dmax = m.grid_from_arrays(rows, lens, starts, mers_a,
                                            inv_perm, R, SP)
        py.append((ids.astype(np.int32).tolist(), has.tolist(), dmax))
        if mods is None:
            res = m.native.mer_grid_fill(rows, lens, starts, offs, mers_a,
                                         inv_perm, R, SP)
            _need(res is not None, "mer_grid: the native fill failed")
            nat.append((res[0].astype(np.int32).tolist(), res[1].tolist(),
                        res[2]))
    if mods is None:
        _same("mer_grid", py, nat)
    return py


def _check_coverage(work, mods=None):
    """test_coverage.py: the whole-BAM coverage estimate from the columnar
    scan against the record loop."""
    m = mods or port_modules()
    bam = scenario_files("cis", os.path.join(work, "cis"))["bam"]
    rd = m.bam.BamReader(bam)
    rd.scan_columns = lambda: (None, None)
    py = m.pipeline.estimate_read_coverage_dirtyfast(rd)
    _need(py[0] > 10, f"coverage: {py}")
    if mods is None:
        _need(m.bam.BamReader(bam).scan_columns()[0] is not None,
              "coverage: the native scan failed")
        _same("coverage", py, m.pipeline.estimate_read_coverage_dirtyfast(
            m.bam.BamReader(bam)))
    return py


def _check_rans4x8(work, mods=None):
    """test_cram.py:560: rANS 4x8 streams of orders 0 and 1 decoded."""
    import random
    m = mods or port_modules()
    rng = random.Random(99)
    py, nat = [], []
    for data in (bytes(rng.choices(b"ACGT", k=70001)),
                 bytes(rng.choices(range(256), k=4096)),
                 b"\x00" * 513, b"Q" * 3):
        for order in (0, 1):
            c = m.rans4x8.compress(data, order)
            got = m.rans4x8.uncompress(c)
            _need(got == data, f"rans4x8: order {order} lost the data")
            py.append(got)
            if mods is None:
                nat.append(m.native.rans4x8_uncompress(c, len(data)))
    if mods is None:
        _same("rans4x8", py, nat)
        c = m.rans4x8.compress(b"hello world" * 10, 0)
        # a corrupt stream fails cleanly, without a crash
        m.native.rans4x8_uncompress(c[:9] + bytes([255]) * (len(c) - 9),
                                    110)
    return py


def _spool_bytes(m, cram, d, native):
    """The BAM spool of a CRAM and its index, transcoded by the native
    slice decoder or the Python record loop (POMFRET_NO_NATIVE_CRAM)."""
    m.cram._SPOOL_CACHE.clear()
    os.makedirs(d, exist_ok=True)
    try:
        with _environ(POMFRET_SPOOL_DIR=d,
                      POMFRET_NO_NATIVE_CRAM=None if native else "1"):
            p = m.cram.spool_path(cram)
        with open(p, "rb") as f, open(p + ".bai", "rb") as g:
            return f.read(), g.read()
    finally:
        m.cram._SPOOL_CACHE.clear()


def _spool_check(name, m, mods, crams, d):
    py = [_spool_bytes(m, c, os.path.join(d, f"py{i}"), False)
          for i, c in enumerate(crams)]
    if mods is None:
        _need(m.native.native_available(), f"{name}: no native library")
        _same(name, py, [_spool_bytes(m, c, os.path.join(d, f"nat{i}"),
                                      True) for i, c in enumerate(crams)])
    return py


def _check_cram_spool(work, mods=None):
    """test_cram.py:455: the cram scenario's CRAM (reference embedded, 200
    records a slice) transcoded to a BAM spool, index included."""
    m = mods or port_modules()
    cram = scenario_files("cram", os.path.join(work, "cram"))["cram"]
    return _spool_check("cram_spool", m, mods, [cram],
                        _fresh(work, "spool"))


def fuzz_bam(m, path: str, seed: int, n: int, tail_clip: bool) -> list:
    """tests/test_cram.py's fuzzed records, n on each of two chromosomes
    (cA, cB), written as a BAM at `path` with m's writer: mixed CIGARs
    (S/I/D/N/H; with `tail_clip`, as test_cram.py:368 draws them, also a
    trailing S and P), IUPAC bases, every aux type, paired, detached and
    unmapped reads. Returns the records."""
    import random
    rng = random.Random(seed)
    recs = []
    for tid in (0, 1):
        pos = 100
        for k in range(n):
            L = rng.randint(30, 300)
            cig = []
            left = L
            if rng.random() < 0.3:
                s = rng.randint(1, min(10, left - 1))
                cig.append(("S", s))
                left -= s
            m1 = rng.randint(1, left)
            cig.append(("M", m1))
            left -= m1
            while left > 0:
                op = rng.choice(["M", "I", "D", "N", "M", "M"])
                if op in ("M", "I"):
                    n_op = rng.randint(1, left)
                    left -= n_op
                else:
                    n_op = rng.randint(1, 50)
                if cig and cig[-1][0] == op:  # decode canonicalizes runs
                    cig[-1] = (op, cig[-1][1] + n_op)
                else:
                    cig.append((op, n_op))
            if tail_clip and rng.random() < 0.2 and cig[-1][0] != "S":
                cig.append(("S", 3))
            if rng.random() < 0.15:
                cig.insert(0, ("H", rng.randint(1, 5)))
            if tail_clip and rng.random() < 0.1:
                cig.append(("P", 2))
            L = sum(n_op for op, n_op in cig if op in ("M", "I", "S", "=",
                                                       "X"))
            seq = "".join(rng.choices("ACGTNRYKM",
                                      weights=[8, 8, 8, 8, 1, 1, 1, 1, 1],
                                      k=L))
            flag = rng.choice([0, 16, 1 | 32, 1 | 16 | 8, 4])
            if flag & 4:
                cig = []
            tags = [("HP", "i", rng.randint(1, 2)),
                    ("de", "f", rng.random() / 10),
                    ("XA", "A", rng.choice("xyz")),
                    ("XB", "B:S", [rng.randint(0, 65535) for _ in range(3)]),
                    ("XZ", "Z", "s" * rng.randint(0, 5))]
            r = m.records.make_record(f"{'fz' if tail_clip else 'nf'}"
                                      f"{tid}_{k}", tid, pos, seq, cig,
                                      flag=flag, mapq=rng.randint(0, 60),
                                      tags=tags)
            if flag & 1:
                r.next_refID = tid
                r.next_pos = pos + 500
                r.tlen = rng.randint(-1000, 1000)
            recs.append(r)
            pos += rng.randint(10, 120)
    with m.bam_writer.BamWriter(path, ["cA", "cB"], [50_000, 30_000]) as w:
        for r in recs:
            w.write(r)
    return recs


def _check_cram_spool_fuzz(work, mods=None):
    """test_cram.py:480: fuzzed records in three CRAM modes (reference
    embedded, no reference, 'B' features), 37 records a slice."""
    m = mods or port_modules()
    d = _fresh(work, "spoolfuzz")
    bam = os.path.join(d, "nf.bam")
    fuzz_bam(m, bam, 777, 80, tail_clip=False)
    crams = []
    for i, mode in enumerate(({"embed_ref": True}, {"no_ref": True},
                              {"embed_ref": True, "feature_style": "B"})):
        crams.append(os.path.join(d, f"nf{i}.cram"))
        m.cram_writer.bam_to_cram(bam, crams[-1], records_per_slice=37,
                                  **mode)
    return _spool_check("cram_spool_fuzz", m, mods, crams, d)


def _check_cram_spool_paths(work, mods=None):
    """test_cram.py:264: methphase --write-bam on the cram scenario's CRAM,
    the coverage estimated: window loads, the coverage scan and the retag
    on the BAM spool against the Python CRAM paths (POMFRET_NO_CRAM_SPOOL,
    POMFRET_NO_NATIVE_RETAG); one spool made."""
    m = mods or port_modules()
    files = scenario_files("cram", os.path.join(work, "cram"))
    argv = ["methphase", "--engine", m.engine, "--vcf", files["vcf"],
            "--write-bam", files["cram"]]
    exts = (".mp.gtf", ".mp.vcf", ".mp.bam", ".mp.bam.bai")
    m.cram._SPOOL_CACHE.clear()
    d = _fresh(work, "paths")
    py = _cli_outputs(m, argv, os.path.join(d, "python"), exts,
                      POMFRET_SPOOL_DIR=d, POMFRET_NO_CRAM_SPOOL="1",
                      POMFRET_NO_NATIVE_RETAG="1")
    if mods is None:
        sd = os.path.join(d, "spool")
        os.makedirs(sd)
        _same("cram_spool_paths", py, _cli_outputs(
            m, argv, os.path.join(d, "native"), exts, POMFRET_SPOOL_DIR=sd,
            POMFRET_NO_CRAM_SPOOL=None, POMFRET_NO_NATIVE_RETAG=None))
        spools = [f for f in os.listdir(sd)
                  if f.startswith("pomfret_spool_") and f.endswith(".bam")]
        _need(len(spools) == 1, f"cram_spool_paths: spools {spools}")
        m.cram._SPOOL_CACHE.clear()
    return py


def _check_cram_varhaptag_spool(work, mods=None):
    """test_cram.py:300: varhaptag on the cram scenario's CRAM, the native
    retag on its BAM spool against the Python record loop
    (POMFRET_NO_CRAM_SPOOL)."""
    m = mods or port_modules()
    files = scenario_files("cram", os.path.join(work, "cram"))
    argv = ["varhaptag", files["vcf"], files["cram"]]
    exts = ("", ".bai", ".varhaptag.tsv")
    m.cram._SPOOL_CACHE.clear()
    d = _fresh(work, "vhspool")
    py = _cli_outputs(m, argv, os.path.join(d, "py.bam"), exts,
                      POMFRET_SPOOL_DIR=d, POMFRET_NO_CRAM_SPOOL="1")
    if mods is None:
        _same("cram_varhaptag_spool", py, _cli_outputs(
            m, argv, os.path.join(d, "nat.bam"), exts, POMFRET_SPOOL_DIR=d,
            POMFRET_NO_CRAM_SPOOL=None))
        m.cram._SPOOL_CACHE.clear()
    return py


# name -> check(work, mods=None), in the order of the JAX package's tests
NATIVE_CHECKS = {
    "bgzf_inflate": _check_bgzf_inflate,
    "bgzf_deflate": _check_bgzf_deflate,
    "bam_scan": _check_bam_scan,
    "meth_decode": _check_meth_decode,
    "site_select": _check_site_select,
    "window_realistic": _check_window_realistic,
    "window_raw_tag": _check_window_raw_tag,
    "window_edges": _check_window_edges,
    "window_coverage_gate": _check_window_coverage_gate,
    "window_duplicate_qname": _check_window_duplicate_qname,
    "mmr_extract": _check_mmr_extract,
    "store_mmr": _check_store_mmr,
    "varhaptag": _check_varhaptag,
    "varhaptag_edges": _check_varhaptag_edges,
    "varhaptag_missing_md": _check_varhaptag_missing_md,
    "chrom_source": _check_chrom_source,
    "chrom_scan": _check_chrom_scan,
    "mer_grid": _check_mer_grid,
    "chrom_source_regions": _check_chrom_source_regions,
    "coverage": _check_coverage,
    "rans4x8": _check_rans4x8,
    "cram_spool": _check_cram_spool,
    "cram_spool_fuzz": _check_cram_spool_fuzz,
    "cram_spool_paths": _check_cram_spool_paths,
    "cram_varhaptag_spool": _check_cram_varhaptag_spool,
}


def run_native_checks(work: str) -> dict:
    """Every NATIVE_CHECKS entry on this process's native library, in
    work: {name: seconds}. Raises on the first that fails, or where the
    library did not load."""
    from .io import native
    _need(native.native_available(), "the native library did not load")
    secs = {}
    for name in NATIVE_CHECKS:
        t0 = time.perf_counter()
        NATIVE_CHECKS[name](work)
        secs[name] = time.perf_counter() - t0
    return secs


# every switch that sends a host route with a native counterpart to its
# Python route (window loads, methmers, site selection, the CRAM slice
# decoder and spool, varhaptag, the retag, whole-chromosome scans);
# BGZF inflate and deflate have none
PYTHON_ROUTES = {k: "1" for k in (
    "POMFRET_NO_NATIVE_WINDOW", "POMFRET_NO_NATIVE_MMR",
    "POMFRET_NO_NATIVE_SITES", "POMFRET_NO_NATIVE_CRAM",
    "POMFRET_NO_NATIVE_VARHAPTAG", "POMFRET_NO_NATIVE_RETAG",
    "POMFRET_NO_CHROM_SCAN", "POMFRET_NO_CRAM_SPOOL")}

