"""The benchmark's data maker: a configuration's synthetic set (a sorted,
indexed, haplotagged BAM with 5mC MM/ML tags and a phased VCF) made from a
seed.

A frozen copy of the port's maker (pomfret_tpu_torch/testing.py:
SynthConfig :45, SynthRegion :59, _block_layout :392, _scenario_region
:405, _Scenario :444, _make_chrom_part :567, _make_scenarios :703), cut
to what the benchmark's sets use (tagged reads, no clips, no indels, no
trans labels) and with two changes:

- chromosome ci draws from np.random.SeedSequence([seed, ci]) where the
  original draws from ci, so every seed gives another set of the same
  sizes (`chrom_seeds` takes the original's seeds, for the test that
  holds this copy to it record for record);
- make_read builds the MM/ML and MD tags with numpy where the original
  walks the read base by base in Python: the same bytes, ~10x sooner;
- each worker compresses its own chromosome's BGZF blocks, which this
  process puts together after the header: the original's records and
  header byte for byte once inflated, in other blocks (each chromosome
  starts one), so the index's offsets are others too.

Run as a script, it makes one set:
`python benchmark/pbench/maker.py CONFIG.json SEED OUTDIR`.
"""
from __future__ import annotations

import gzip
import json
import os
import struct
import sys
import time
from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
if os.path.dirname(_HERE) not in sys.path:
    sys.path.insert(0, os.path.dirname(_HERE))

from pomref.io.bam import bam_endpos  # noqa: E402
from pomref.io.bam_writer import (build_bai_from_meta,  # noqa: E402
                                  encode_record)
from pomref.io.bgzf import BGZF_EOF, BLOCK, _deflate_block  # noqa: E402
from pomref.io.records import make_record  # noqa: E402

MARGIN = 5_000
BAM_NAME = "set.bam"
VCF_NAME = "set.vcf.gz"
TRUTH_NAME = "truth.npz"


_COMPL = bytes.maketrans(b"ACGT", b"TGCA")


def revcomp(s: str) -> str:
    return s.encode().translate(_COMPL)[::-1].decode()


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
    seed: object = 0              # an int or a np.random.SeedSequence
    chrom: str = "chr1"


class SynthRegion:
    def __init__(self, cfg: SynthConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        self.rng = rng
        # genome over {A,T,G}, then CG dinucleotides placed: every C is a
        # CpG C
        base = rng.choice(list("ATG"), size=cfg.ref_len)
        self.cpg_sites: List[int] = []
        p = cfg.cpg_every // 2
        while p + 1 < cfg.ref_len - 2:
            base[p] = "C"
            base[p + 1] = "G"
            self.cpg_sites.append(p)
            p += cfg.cpg_every
        self.ref = "".join(base)
        self.ref_b = np.frombuffer(self.ref.encode(), dtype=np.uint8)
        self.cpg_arr = np.array(self.cpg_sites, dtype=np.int64)
        # methylation truth: hap0 methylated, hap1 unmethylated
        self.meth_state = np.zeros((2, len(self.cpg_sites)), dtype=np.int8)
        self.meth_state[0, :] = 1
        self.snps: List[Tuple[int, str, str, int]] = []
        self.snp_pos = np.zeros(0, dtype=np.int64)
        self.snp_hap = np.zeros(0, dtype=np.int64)

    def add_snps(self, positions: Sequence[int],
                 hap_with_alt: Sequence[int]) -> None:
        """SNPs at reference 'A' positions, ALT='T' (never a CpG)."""
        for pos, hap in zip(positions, hap_with_alt):
            if self.ref[pos] != "A":
                raise ValueError(f"SNP host base at {pos} is {self.ref[pos]}")
            self.snps.append((pos, "A", "T", hap))
        self.snps.sort()
        self.snp_pos = np.array([s[0] for s in self.snps], dtype=np.int64)
        self.snp_hap = np.array([s[3] for s in self.snps], dtype=np.int64)

    def hap_seq(self, start: int, end: int, hap: int) -> np.ndarray:
        """The haplotype's bases over [start, end), as ASCII codes."""
        s = self.ref_b[start:end].copy()
        lo, hi = np.searchsorted(self.snp_pos, [start, end])
        pos = self.snp_pos[lo:hi][self.snp_hap[lo:hi] == hap]
        s[pos - start] = ord("T")
        return s

    def make_read(self, qname: str, start: int, hap: int, reverse: bool):
        """One tagged read of cfg.read_len from `hap` starting at `start`,
        all of it aligned (one M op)."""
        cfg = self.cfg
        end = min(start + cfg.read_len, cfg.ref_len)
        seq_b = self.hap_seq(start, end, hap)
        L = end - start

        # per-site meth state from the haplotype profile
        m = (self.cpg_arr >= start) & (self.cpg_arr + 1 < end)
        sites = self.cpg_arr[m]
        states = self.meth_state[hap, np.flatnonzero(m)].astype(np.int8)
        if cfg.noise > 0:
            flip = self.rng.random(len(states)) < cfg.noise
            states = np.where(flip, 1 - states, states)
        quals = np.where(states == 1, cfg.meth_qual, cfg.unmeth_qual)
        if cfg.nocall > 0:
            nc = self.rng.random(len(states)) < cfg.nocall
            quals = np.where(nc, 128, quals)

        # MM/ML over the original read orientation: each C of the origin
        # strand in order, a call where it is a CpG C on a site with a
        # state, else skipped
        seq = seq_b.tobytes().decode()
        origin = revcomp(seq) if reverse else seq
        o = np.frombuffer(origin.encode(), dtype=np.uint8)
        c_at = np.flatnonzero(o == ord("C"))
        nxt = np.minimum(c_at + 1, L - 1)
        cpg = (c_at + 1 < L) & (o[nxt] == ord("G"))
        sp = (L - 2 - c_at) if reverse else c_at  # stored CpG-C position
        site = start + sp
        k = np.searchsorted(sites, site)
        k = np.minimum(k, max(len(sites) - 1, 0))
        hit = (cpg & (sites[k] == site) if len(sites)
               else np.zeros(len(c_at), dtype=bool))
        at = np.flatnonzero(hit)
        deltas = np.diff(np.concatenate(([-1], at))) - 1
        mlvals = quals[k[at]].tolist()
        mm = ("C+m?," + ",".join(map(str, deltas.tolist())) + ";"
              if len(at) else "C+m?;")

        # MD against the reference
        ref_b = self.ref_b[start:end]
        diff = np.flatnonzero(seq_b != ref_b)
        runs = np.diff(np.concatenate(([-1], diff))) - 1
        md = "".join(f"{r}{chr(b)}" for r, b in zip(runs.tolist(),
                                                     ref_b[diff].tolist()))
        md += str(L - (int(diff[-1]) + 1 if len(diff) else 0))

        tags = [("MM", "Z", mm)]
        if mlvals:
            tags.append(("ML", "B:C", mlvals))
        tags.append(("MD", "Z", md))
        tags.append(("de", "f", 0.01))
        tags.append(("HP", "i", hap + 1))
        rec = make_record(qname, 0, start, seq, [("M", L)],
                          flag=16 if reverse else 0, mapq=60, tags=tags)
        # beside the record, what the read was made to say, for the
        # reference: its ML value at each CpG site it covers, in site order
        return rec, quals.astype(np.uint8)

    def iter_reads(self):
        """(haplotype, record, ML values) of every hap-0 read, then every
        hap-1 read, in the order drawn
        (each read draws its strand, then a clip and an indel that these
        sets never take, as the original does)."""
        cfg = self.cfg
        k = 0
        for hap in (0, 1):
            start = (cfg.read_stagger // 2) * hap
            while start + cfg.read_len <= cfg.ref_len:
                reverse = bool(self.rng.random() < cfg.frac_reverse)
                self.rng.random()  # clip: frac_clipped 0
                self.rng.random()  # indel: frac_indel 0
                yield (hap, *self.make_read(f"read_{hap}_{k}", start,
                                            hap, reverse))
                k += 1
                start += cfg.read_stagger


def block_layout(n_blocks: int, block_len: int, gap_len: int):
    """(ref_len, blocks): a 5 kb margin at each end and n_blocks blocks of
    block_len between gaps of gap_len, the same on every chromosome."""
    ref_len = MARGIN * 2 + n_blocks * block_len + (n_blocks - 1) * gap_len
    blocks, p = [], MARGIN
    for _ in range(n_blocks):
        blocks.append((p, p + block_len))
        p += block_len + gap_len
    return ref_len, blocks


def chrom_seed(seed: int, ci: int):
    return np.random.SeedSequence([int(seed), ci])


def scenario_region(ci: int, ref_len: int, blocks, read_stagger: int,
                    chrom_kw: dict, seed) -> SynthRegion:
    """Chromosome ci's region and SNPs: one on the first 'A' of each 2 kb
    step inside each block, alternating haplotypes."""
    kw = dict(ref_len=ref_len, chrom=f"chr{ci + 1}", seed=seed,
              read_stagger=read_stagger)
    kw.update(chrom_kw)
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
    return sr


def make_chrom_part(part: str, ci: int, params: dict, seed) -> dict:
    """Chromosome ci's records, encoded, put in position order (a stable
    sort of the drawing order) and written to the file `part` as BGZF
    blocks of the BAM (level 6, BLOCK bytes of records each, no EOF
    block). Returns each record's (pos, endpos, haplotype, start, end),
    start and end its (block, offset in the block) in the part, the
    part's block sizes, the chromosome's SNPs and the seconds taken."""
    t0 = time.perf_counter()
    ref_len, blocks = block_layout(params["n_blocks"], params["block_len"],
                                   params["gap_len"])
    sr = scenario_region(ci, ref_len, blocks, params["read_stagger"],
                         params["per_chrom"][ci], seed)
    recs = []
    for k, (hap, r, ml) in enumerate(sr.iter_reads()):
        r.refID = ci
        r.qname = f"c{ci}_" + r.qname
        recs.append((r.pos, bam_endpos(r), hap, encode_record(r),
                     (1 if r.flag & 16 else 0, k, ml)))
    recs.sort(key=lambda m: m[0])
    raw = b"".join(m[3] for m in recs)
    meta, off = [], 0
    for pos, endpos, hap, rec, _ in recs:
        meta.append((pos, endpos, hap, divmod(off, BLOCK),
                     divmod(off + len(rec), BLOCK)))
        off += len(rec)
    truth = dict(
        strand=np.array([m[4][0] for m in recs], dtype=np.int8),
        draw=np.array([m[4][1] for m in recs], dtype=np.int64),
        call_n=np.array([len(m[4][2]) for m in recs], dtype=np.int64),
        ml=(np.concatenate([m[4][2] for m in recs]) if recs
            else np.zeros(0, dtype=np.uint8)),
        sites=sr.cpg_arr)
    sizes = []
    with open(part, "wb") as f:
        for i in range(0, len(raw), BLOCK):
            blk = _deflate_block(raw[i:i + BLOCK], 6)
            sizes.append(len(blk))
            f.write(blk)
    return dict(meta=meta, sizes=sizes, snps=sr.snps, truth=truth,
                seconds=time.perf_counter() - t0)


def _worker(conn, part, ci, params, seed):
    try:
        conn.send(("ok", make_chrom_part(part, ci, params, seed)))
    except BaseException:
        import traceback
        conn.send(("err", traceback.format_exc()))
    conn.close()


def write_vcf(path: str, snps, blocks) -> None:
    """The phased VCF of each chromosome's SNPs (snps[ci]: its (pos, ref,
    alt, haplotype) in order): every SNP inside a block, PS the position
    (1-based) of the block's first SNP."""
    lines = ["##fileformat=VCFv4.2",
             "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tsample"]
    for ci, chrom_snps in enumerate(snps):
        firsts = {}
        for pos, ref, alt, hap_alt in chrom_snps:
            bi = next((i for i, (lo, hi) in enumerate(blocks)
                       if lo <= pos < hi), None)
            if bi is None:
                continue
            ps = firsts.setdefault(bi, pos + 1)
            a0, a1 = (1, 0) if hap_alt == 0 else (0, 1)
            lines.append(f"chr{ci + 1}\t{pos + 1}\t.\t{ref}\t{alt}\t60"
                         f"\tPASS\t.\tGT:PS\t{a0}|{a1}:{ps}")
    with gzip.open(path, "wt") as f:
        f.write("\n".join(lines) + "\n")


def make_set(params: dict, seed: int, out_dir: str, procs: int = 0,
             chrom_seeds=None) -> dict:
    """The set of `params` (n_chroms, n_blocks, block_len, gap_len,
    read_stagger, per_chrom) from `seed`, into out_dir/set.bam (+ .bai)
    and out_dir/set.vcf.gz, every chromosome in a spawned worker, at most
    `procs` at once (0: one a core). chrom_seeds: each chromosome's seed
    in place of chrom_seed(seed, ci). Returns the reads of each
    chromosome as (pos, endpos, haplotype) rows and the seconds taken."""
    import multiprocessing
    from multiprocessing.connection import wait
    t0 = time.perf_counter()
    n = params["n_chroms"]
    seeds = (list(chrom_seeds) if chrom_seeds is not None
             else [chrom_seed(seed, ci) for ci in range(n)])
    ref_len, blocks = block_layout(params["n_blocks"], params["block_len"],
                                   params["gap_len"])
    os.makedirs(out_dir, exist_ok=True)
    parts = os.path.join(out_dir, ".parts")
    os.makedirs(parts, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    todo = list(range(n))
    running, got = {}, [None] * n
    procs = procs or os.cpu_count() or 1
    try:
        while todo or running:
            while todo and len(running) < procs:
                ci = todo.pop(0)
                a, b = ctx.Pipe(duplex=False)
                p = ctx.Process(target=_worker, args=(
                    b, os.path.join(parts, f"{ci}.part"), ci, params,
                    seeds[ci]))
                p.start()
                b.close()
                running[a] = (ci, p)
            for conn in wait(list(running)):
                ci, p = running.pop(conn)
                try:
                    kind, out = conn.recv()
                except EOFError:
                    kind, out = "err", f"the worker of chr{ci + 1} died"
                p.join()
                if kind != "ok":
                    raise RuntimeError(out)
                got[ci] = out
    finally:
        for _, p in running.values():
            p.kill()
            p.join()
    bam = os.path.join(out_dir, BAM_NAME)
    index = []  # (refID, pos, endpos, virtual start, virtual end, unmapped)
    with open(bam, "wb") as f:
        f.write(_deflate_block(bam_header(n, ref_len), 6))
        for ci in range(n):
            base = f.tell()
            starts = np.concatenate(([0], np.cumsum(got[ci]["sizes"])))
            for pos, endpos, _, (b0, o0), (b1, o1) in got[ci]["meta"]:
                index.append((ci, pos, endpos,
                              (base + int(starts[b0])) << 16 | o0,
                              (base + int(starts[b1])) << 16 | o1, False))
            part = os.path.join(parts, f"{ci}.part")
            with open(part, "rb") as g:
                f.write(g.read())
            os.remove(part)
        f.write(BGZF_EOF)
    build_bai_from_meta(bam + ".bai", index, n)
    write_vcf(os.path.join(out_dir, VCF_NAME), [g["snps"] for g in got],
              blocks)
    os.rmdir(parts)
    reads = [np.array([(m[0], m[1], m[2]) for m in g["meta"]],
                      dtype=np.int64).reshape(-1, 3) for g in got]
    return dict(reads=reads, truth=[g["truth"] for g in got],
                seconds=time.perf_counter() - t0)


def save_truth(path: str, reads, truth) -> None:
    """Every read as it was made, chromosome ci's arrays under `ci.<key>`:
    pos, end, hap (its rows of `reads`), strand (1 reverse), draw (k of
    its name c{ci}_read_{hap}_{k}), call_n and ml (the ML value it carries
    at each CpG site it covers, in site order, concatenated), and sites
    (the chromosome's CpG C positions)."""
    arrays = {}
    for ci, (r, t) in enumerate(zip(reads, truth)):
        arrays.update({f"{ci}.pos": r[:, 0], f"{ci}.end": r[:, 1],
                       f"{ci}.hap": r[:, 2]})
        arrays.update({f"{ci}.{k}": v for k, v in t.items()})
    np.savez(path, **arrays)


def load_truth(path: str) -> dict:
    """save_truth's arrays: {chromosome name: {key: array}}."""
    out: dict = {}
    with np.load(path) as z:
        for key in z.files:
            ci, k = key.split(".", 1)
            out.setdefault(f"chr{int(ci) + 1}", {})[k] = z[key]
    return out


def bam_header(n: int, ref_len: int) -> bytes:
    """The BAM header of n chromosomes chr1..chrN of ref_len each (the
    port's BamWriter's, with its @HD line)."""
    text = b"@HD\tVN:1.6\tSO:coordinate\n"
    hdr = b"BAM\x01" + struct.pack("<i", len(text)) + text
    hdr += struct.pack("<i", n)
    for ci in range(n):
        name = f"chr{ci + 1}".encode() + b"\x00"
        hdr += struct.pack("<i", len(name)) + name + struct.pack("<i",
                                                                  ref_len)
    return hdr


def main(argv) -> int:
    config, seed, out_dir = argv
    with open(config) as f:
        params = json.load(f)["set"]
    got = make_set(params, int(seed), out_dir)
    np.savez(os.path.join(out_dir, "reads.npz"),
             *[r for r in got["reads"]])
    save_truth(os.path.join(out_dir, TRUTH_NAME), got["reads"],
               got["truth"])
    with open(os.path.join(out_dir, "made.json"), "w") as f:
        json.dump(dict(seed=int(seed), seconds=got["seconds"],
                       n_reads=[len(r) for r in got["reads"]]), f)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
