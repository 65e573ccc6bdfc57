"""The pipelines of the port: methphase, report, warmup, varhaptag and
methstat.

Counterpart of pomfret_tpu/pipeline.py. The host parts are copies of it:
CliOpt, the coverage estimate, the host oracle's per-gap and
per-chromosome paths (haplotag_region_given_bam, _blockjoin_one_chrom),
_derive_chrom_params, main_varhaptag and main_methstat. The device parts
drive the port's engine (kernels/engine_torch.run_jobs_batched) where the
JAX package drives engine_jax: _blockjoin_all_chroms_torch,
blockjoin_parallel, main_blockjoin (with --profile on torch.profiler),
main_warmup and main_methreport. Several processes (POMFRET_COORDINATOR,
POMFRET_NUM_PROCS, POMFRET_PROC_ID; parallel/distributed.py) deal the gaps
and report windows round-robin, all-gather the decisions and tags, and
process 0 writes; each process splits its batches over the GPUs it sees
(parallel/batch.production_mesh).
"""
from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import os
import sys
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

from . import resolve_device
from .core.engine_host import haplotag_region
from .core.intervals import (Storage, generate_new_phase_blocks,
                             lift_decisions, make_decisions_flippings_onraw,
                             merge_close_intervals, store_raw_intervals)
from .core.methmer import get_methmer_sites_and_ranges
from .core.readset import READBACK, MmrConfig, load_reads_given_interval
from .core.recovery import recover_variant_phase_in_dropped_intervals
from .core.varhaptag import pre_haplotagging_read_in_one_ref
from .core.variants import HAPTAG_UNPHASED
from .io.bam import BamReader, bam_endpos
from .io.cram import open_alignment
from .io.intervals_loader import IS_GTF, IS_TSV, IS_VCF, load_intervals_from_file
from .io.writers import (output_gtf, output_modify_bam, output_modify_vcf,
                         output_tsv)
from .parallel import distributed
from .utils.log import Get_T, log_err, log_info, log_warn
from .utils.manifest import entry_line, open_manifest, write_merged
from .utils.stats import count, stage


@dataclass
class CliOpt:
    """cliopt_t (cli.h:19-48) with the defaults of init_cliopt_t (cli.c:48-74)."""
    threads: int = 1
    threads_bam: int = 1
    lo: int = 100
    hi: int = 156
    fn_gtf: Optional[str] = None
    fn_tsv: Optional[str] = None
    fn_vcf: Optional[str] = None
    fn_bam: Optional[str] = None
    bam_needs_haplotagging: bool = False
    write_bam_input_haplotagging: bool = False
    output_prefix: str = "pomfret"
    readlen_threshold: int = 15000
    mapq: int = 10
    k: int = 3
    k_span: int = 5000
    cov: int = -1
    cov_for_selection: int = -1
    n_candidates_per_iter: int = 15
    do_output_bam: bool = False
    do_output_tsv: bool = False
    write_debug_files: bool = False
    chunk_size: int = 50000
    chunk_stride: int = 1000000
    engine: str = "cuda"  # cuda|torch|host|auto
    resume: bool = False
    profile: bool = False
    # TPU-era extra: the reference compiles permutation voting
    # (blockjoin.c:4088-4214) but hardcodes n_permutation=1 at the call site
    # (blockjoin.c:4675); we expose it as --n-permutations.
    n_permutations: int = 1


def estimate_read_coverage_dirtyfast(bam: BamReader) -> List[int]:
    """Whole-BAM binned coverage estimate (blockjoin.c:951-1040):
    5 kb bins, filters mapq<5 / len<15000 / de>0.1, integer mean per chrom."""
    T = Get_T()
    mod = 5000
    log_info("estimate_read_coverage_dirtyfast", "estimate read depths...")
    covs = [0] * len(bam.ref_names)

    cols, _ = bam.scan_columns()
    if cols is not None:
        # vectorized equivalent of the C binning loop: each read increments
        # ceil((end-start)/mod) consecutive bins from start//mod; increments
        # landing beyond target_len//mod bins are dropped (matching the
        # reference's sum over exactly n bins)
        ok = ((cols["flag"] & (4 | 256 | 2048)) == 0)
        ok &= cols["mapq"] >= 5
        ok &= cols["l_seq"] >= 15000
        ok &= ~(cols["de"] > 0.1)
        ok &= cols["refID"] >= 0
        for tid in np.unique(cols["refID"][ok]):
            n_bins = bam.ref_lens[tid] // mod
            if n_bins <= 0:
                continue
            m = ok & (cols["refID"] == tid)
            s0 = cols["pos"][m] // mod
            kn = -(-(cols["endpos"][m] - cols["pos"][m]) // mod)
            diff = np.zeros(n_bins + 1, dtype=np.int64)
            np.add.at(diff, np.minimum(s0, n_bins), 1)
            np.add.at(diff, np.minimum(s0 + kn, n_bins), -1)
            bins_arr = np.cumsum(diff[:-1])
            covs[int(tid)] = int(bins_arr.sum() // n_bins)
        for name, c in zip(bam.ref_names, covs):
            log_info("estimate_read_coverage_dirtyfast", f"{name} est. coverage is {c}")
        log_info("estimate_read_coverage_dirtyfast", f"used {Get_T() - T:.1f}s")
        return covs

    bins: Dict[int, np.ndarray] = {}
    for rec in bam.fetch_all():
        tid = rec.refID
        if tid < 0 or tid >= len(bam.ref_names):
            continue
        if rec.flag & (4 | 256 | 2048):
            continue
        if rec.mapq < 5:
            continue
        if rec.l_seq < 15000:
            continue
        de = rec.get_tag("de")
        if de is not None and de > 0.1:
            continue
        if tid not in bins:
            bins[tid] = np.zeros(bam.ref_lens[tid] // mod, dtype=np.int64)
        b = bins[tid]
        i = rec.pos
        end = bam_endpos(rec)
        while i < end:
            idx = i // mod
            if idx < len(b):
                b[idx] += 1
            i += mod
    for tid, b in bins.items():
        if len(b) > 0:
            covs[tid] = int(b.sum() // len(b))
    for name, c in zip(bam.ref_names, covs):
        log_info("estimate_read_coverage_dirtyfast", f"{name} est. coverage is {c}")
    log_info("estimate_read_coverage_dirtyfast", f"used {Get_T() - T:.1f}s")
    return covs


def estimate_read_coverage_cached(fn_bam: str, threads: int = 1) -> Dict[str, int]:
    """Coverage estimates keyed on the BAM's identity (realpath, mtime,
    size), cached across runs the way the CRAM spool is (io/cram.py
    spool_path). The estimate is a pure function of the BAM (blockjoin.c:
    951-1040 reads nothing else), so reusing it is output-identical while
    skipping a whole-file scan that costs ~40% of a warm run's wall
    (VERDICT r2 next-round item 1a). POMFRET_NO_COV_CACHE=1 disables;
    the cache file lives under POMFRET_SPOOL_DIR (default tempdir).

    Returns {ref_name: coverage}."""
    import hashlib
    import json as _json
    import os
    import tempfile

    def scan() -> Dict[str, int]:
        count("coverage_scans", 1)
        bam = open_alignment(fn_bam, threads=threads)
        return dict(zip(bam.ref_names, estimate_read_coverage_dirtyfast(bam)))

    if os.environ.get("POMFRET_NO_COV_CACHE"):
        return scan()
    st_ = os.stat(fn_bam)
    key = (os.path.realpath(fn_bam), st_.st_mtime_ns, st_.st_size)
    h = hashlib.sha1(repr(key).encode()).hexdigest()[:16]
    d = os.environ.get("POMFRET_SPOOL_DIR") or tempfile.gettempdir()
    path = os.path.join(d, f"pomfret_cov_{h}.json")
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = _json.load(f)
            log_info("estimate_read_coverage_cached",
                     f"reusing cached coverage estimates ({path})")
            return {n: int(c) for n, c in data["covs"].items()}
        except (ValueError, KeyError, OSError):
            pass  # corrupt/partial cache: rescan and rewrite
    covs = scan()
    tmp = path + f".tmp{os.getpid()}"
    try:
        with open(tmp, "w") as f:
            _json.dump({"key": list(key), "covs": covs}, f)
        os.replace(tmp, path)
    except OSError:
        pass  # unwritable cache dir: still return the fresh scan
    return covs


def haplotag_region_given_bam(st: Storage, bam: BamReader, chrom: str,
                              ref_start: int, ref_end: int,
                              config: MmrConfig, n_candidates_per_iter: int,
                              engine: str = "host", n_permutations: int = 1,
                              perm_key: Optional[int] = None, device=None):
    """Load one gap window + run both directions (blockjoin.c:4217-4335).
    Returns (decision, readset|None). perm_key seeds a per-gap srand48
    stream for permutation voting so results are independent of which host
    scores which gap (PARITY.md X7); None keeps the process-global stream.
    engine: "host" (the oracle), or "torch" / "cuda" on `device`
    (kernels.engine_torch.run_gap, the JAX package's engine="jax")."""
    rs = load_reads_given_interval(
        bam, chrom, ref_start, ref_end, READBACK, config,
        st.qname2haptag_raw if st.stores_raw_tag else None)
    ms_fwd = get_methmer_sites_and_ranges(rs, config, 0)
    ms_bwd = get_methmer_sites_and_ranges(rs, config, 1)
    if ms_fwd.n == 0 or ms_bwd.n == 0:
        log_warn("haplotag_region_given_bam",
                 f"{chrom}:{ref_start}-{ref_end} does not have methmer in both directions. Skipping.")
        return -1, rs
    from .core.engine_host import evaluate_ref_sanity
    from .utils.log import get_verbose
    if get_verbose():
        rl, vl = evaluate_ref_sanity(rs, 0)
        rr_, vr = evaluate_ref_sanity(rs, 1)
        log_info("haplotag_region_given_bam",
                 f"left ref ratio: {rl:.2f} (valid={vl}); right ref ratio: {rr_:.2f} (valid={vr})")
    rng = None
    if n_permutations > 1 and perm_key is not None:
        from .core.engine_host import Drand48
        rng = Drand48.from_srand48(perm_key)
    if engine in ("torch", "cuda"):
        from .kernels.engine_torch import run_gap
        decision = run_gap(rs, ms_fwd, ms_bwd, n_candidates_per_iter,
                           config.cov_for_runtime, n_permutations, rng,
                           engine=engine, device=device)
    elif engine == "host":
        decision = haplotag_region(rs, ms_fwd, ms_bwd, n_candidates_per_iter,
                                   config.cov_for_runtime, n_permutations,
                                   rng)
    else:
        raise ValueError(f"engine {engine!r} is not host, torch or cuda")
    return decision, rs


def _derive_chrom_params(config: MmrConfig, n_cand: int, coverage: int,
                         ref_name: str) -> Tuple[MmrConfig, int]:
    """Per-chromosome parameter derivation (blockjoin.c:4358-4392)."""
    import dataclasses
    cfg = dataclasses.replace(config)
    if cfg.cov_for_selection <= 0:
        cfg.cov_for_selection = coverage // 10 + 1
        cfg.cov_for_runtime = cfg.cov_for_selection * 2
        n_cand = coverage // 4 + 1
    if cfg.cov_for_selection <= 0:
        log_warn("blockjoin_one_chrom", f"had to clamp cov_for_selection (ref: {ref_name})")
        cfg.cov_for_selection = 1
    if n_cand <= 1:
        log_warn("blockjoin_one_chrom", f"had to clamp n_candidates_per_iter (ref: {ref_name})")
        n_cand = 2
    return cfg, n_cand


def _blockjoin_one_chrom(st: Storage, fn_bam: str, job_i: int,
                         config: MmrConfig, n_cand_in: int, coverage: int,
                         gap_filter=None, manifest=None, done=None,
                         n_permutations: int = 1) -> Dict[str, int]:
    """One chromosome's gap-joining jobs on the host oracle
    (blockjoin_one_chrom_callback, blockjoin.c:4350-4426). Returns the
    per-chromosome qname->haptag map. gap_filter(i) -> bool restricts it
    to this process's gaps; manifest/done implement checkpoint-resume at
    gap granularity."""
    rg = st.ranges[job_i]
    ref_name = st.ref_names[job_i]
    cfg, n_cand = _derive_chrom_params(config, n_cand_in, coverage, ref_name)
    log_info("blockjoin_one_chrom",
             f"ref {ref_name} using: cov_for_selection={cfg.cov_for_selection}, n_cand_per_iter={n_cand}")
    bam = open_alignment(fn_bam)
    qname2haptag: Dict[str, int] = {}
    indices = []
    for i in range(len(rg.starts)):
        if gap_filter is not None and not gap_filter(i):
            continue
        if done is not None and (ref_name, i) in done:
            e = done[(ref_name, i)]
            rg.decisions[i] = e["decision"]
            if e["decision"] >= 0:
                for qn, hp in e["tags"].items():
                    qname2haptag.setdefault(qn, hp)
            continue
        indices.append(i)
    for i in indices:
        decision, rs = haplotag_region_given_bam(
            st, bam, ref_name, rg.starts[i], rg.ends[i], cfg, n_cand,
            n_permutations=n_permutations, perm_key=job_i * 1_000_003 + i)
        rg.decisions[i] = decision
        tags = {r.qname: r.hp for r in rs.reads} if (decision >= 0 and rs is not None) else None
        if manifest is not None:
            manifest.record(ref_name, i, rg.starts[i], rg.ends[i], decision, tags)
        if tags:
            for qn, hp in tags.items():
                qname2haptag.setdefault(qn, hp)
    return qname2haptag


def _blockjoin_all_chroms_torch(st: Storage, fn_bam: str, config: MmrConfig,
                                n_cand_in: int, ref_covs, make_filter,
                                manifest, done, n_permutations: int, *,
                                engine: str, device) -> List[Dict[str, int]]:
    """All chromosomes' gap jobs through ONE device pipeline
    (run_jobs_batched), so the in-flight groups span chromosome
    boundaries. Per-chromosome parameter derivation, the process's gap
    filter (make_filter(job_i)), resume handling and the first-wins tag
    merge order (done gaps first, then engine gaps, both in gap order) are
    those of the per-chromosome path. Returns the per-chromosome
    qname->haptag maps."""
    from .kernels.engine_torch import run_jobs_batched
    bam = open_alignment(fn_bam)
    qmaps: List[Dict[str, int]] = [dict() for _ in st.ranges]
    jobs = []
    for job_i, rg in enumerate(st.ranges):
        ref_name = st.ref_names[job_i]
        cfg, n_cand = _derive_chrom_params(config, n_cand_in,
                                           ref_covs[job_i], ref_name)
        log_info("blockjoin_one_chrom",
                 f"ref {ref_name} using: cov_for_selection={cfg.cov_for_selection}, n_cand_per_iter={n_cand}")
        gap_filter = make_filter(job_i)
        indices = []
        for i in range(len(rg.starts)):
            if gap_filter is not None and not gap_filter(i):
                continue
            if done is not None and (ref_name, i) in done:
                e = done[(ref_name, i)]
                rg.decisions[i] = e["decision"]
                if e["decision"] >= 0:
                    for qn, hp in e["tags"].items():
                        qmaps[job_i].setdefault(qn, hp)
                continue
            indices.append(i)
        if indices:
            jobs.append(dict(job_i=job_i, ref_name=ref_name, rg=rg, cfg=cfg,
                             n_cand=n_cand, indices=indices,
                             perm_key_base=job_i * 1_000_003))
    results = run_jobs_batched(st, bam, jobs, n_permutations=n_permutations,
                               engine=engine, device=device)
    for job, (decisions, tag_maps) in zip(jobs, results):
        rg, ref_name = job["rg"], job["ref_name"]
        for i in job["indices"]:
            d = decisions[i]
            tags = tag_maps[i]
            rg.decisions[i] = d
            if manifest is not None:
                manifest.record(ref_name, i, rg.starts[i], rg.ends[i], d,
                                tags if d >= 0 else None)
            if d >= 0:
                for qn, hp in tags.items():
                    qmaps[job["job_i"]].setdefault(qn, hp)
    return qmaps


def _merge_manifest(path: str, kept: Dict[Tuple[str, int], str], done,
                    st: Storage, gap_global: Dict[Tuple[int, int], int],
                    n_procs: int, proc_id: int) -> None:
    """With several processes: every process's manifest lines (those it
    wrote to its part, and a resumed run's records of its own gaps) are
    all-gathered, and process 0 writes the whole manifest at `path`, each
    gap once in global gap order, and removes the parts (write_merged)."""
    count("manifest_records", len(kept))
    mine: Dict[int, str] = {}
    for (i_ref, i), gidx in gap_global.items():
        if gidx % n_procs != proc_id:
            continue
        key = (st.ref_names[i_ref], i)
        if key in kept:
            mine[gidx] = kept[key]
        elif done and key in done:
            mine[gidx] = entry_line(done[key])
    lines = distributed.allgather_manifest(mine)
    if proc_id != 0:
        return
    with stage("manifest_merge"):
        n = write_merged(path, (lines[g] for g in sorted(lines)))
    count("manifest_records_merged", n)


def blockjoin_parallel(opt: CliOpt, config: MmrConfig,
                       device=None) -> Storage:
    """Load gaps (+ optional varhaptag), then join per chromosome
    (blockjoin.c:4428-4603). opt.engine is auto|host|torch|cuda; `device`
    is where the torch engine runs (see resolve_device). With several
    processes, each decides the gaps of the global gap list dealt to it
    round-robin, and the decisions and tags are all-gathered, so every
    process ends with the whole result; each writes its manifest records
    to a part of its own, and process 0 writes the whole manifest from the
    gathered records (_merge_manifest)."""
    engine, dev = resolve_device(opt.engine, device)
    T = Get_T()
    st = Storage()
    fn_interval = opt.fn_tsv or opt.fn_gtf or opt.fn_vcf
    fmt = IS_TSV if opt.fn_tsv else (IS_GTF if opt.fn_gtf else IS_VCF)

    if opt.bam_needs_haplotagging:
        assert opt.fn_vcf
        tag_bam = open_alignment(opt.fn_bam, threads=opt.threads_bam)

        def cb(chrom, variants):
            with stage("varhaptag"):
                pre_haplotagging_read_in_one_ref(tag_bam, chrom, variants,
                                                 st.qname2haptag_raw)

        with stage("intervals_load"):
            load_intervals_from_file(opt.fn_vcf, IS_VCF, st,
                                     load_vcf_variants_too=True,
                                     haptag_callback=cb)
        if sum(len(r.starts) for r in st.ranges) == 0:
            log_err("blockjoin_parallel",
                    f"Nothing loaded from vcf (ref_n={len(st.ref_names)}), cannot haptag the input bam. Terminating.")
            sys.exit(1)
        if fmt != IS_VCF:
            # gtf/tsv overrides vcf phase blocks
            st.ref_names = []
            st.ranges = []
            with stage("intervals_load"):
                load_intervals_from_file(fn_interval, fmt, st)
    else:
        with stage("intervals_load"):
            load_intervals_from_file(fn_interval, fmt, st)

    if sum(len(r.starts) for r in st.ranges) == 0:
        log_err("blockjoin_parallel", "No intervals loaded, terminating.")
        sys.exit(1)
    log_info("blockjoin_parallel", f"input has {len(st.ref_names)} references")

    if opt.bam_needs_haplotagging and opt.write_bam_input_haplotagging:
        bam = open_alignment(opt.fn_bam)
        with open(opt.output_prefix + ".mp.input_haptag.tsv", "w") as f:
            f.write("#qname\treal_hp\ttagged_hp\n")
            for rec in bam.fetch_all():
                hp = rec.get_tag("HP")
                hp_raw = HAPTAG_UNPHASED if hp is None or hp == 0 else hp - 1
                got = st.qname2haptag_raw.get(rec.qname)
                f.write(f"{rec.qname}\t{hp_raw + 1}\t{255 if got is None else got + 1}\n")

    for rg in st.ranges:
        store_raw_intervals(rg)
        merge_close_intervals(rg, READBACK)
    log_info("blockjoin_parallel", "loaded phase block gaps.")

    if config.cov_for_selection <= 0:
        with stage("coverage_scan"):
            name2cov = estimate_read_coverage_cached(opt.fn_bam,
                                                     opt.threads_bam)
        ref_covs = [name2cov.get(n, 0) for n in st.ref_names]
    else:
        ref_covs = [config.cov_known] * len(st.ref_names)

    n_jobs = len(st.ref_names)
    if engine != "host" and opt.threads > 1:
        # one pipeline feeds the devices; worker threads would only add
        # resident batches
        log_warn("blockjoin_parallel",
                 f"{engine} engine runs one device pipeline; clamping worker threads to 1")
        opt = dataclasses.replace(opt, threads=1)

    # several processes: deterministic round-robin over the GLOBAL gap list
    n_procs = distributed.process_count()
    proc_id = distributed.process_index()
    gap_global: Dict[Tuple[int, int], int] = {}
    for i_ref, rg in enumerate(st.ranges):
        for i in range(len(rg.starts)):
            gap_global[(i_ref, i)] = len(gap_global)

    def make_filter(i_ref):
        if n_procs == 1:
            return None
        return lambda i: gap_global[(i_ref, i)] % n_procs == proc_id

    # with several processes, each writes a part of its own and process 0
    # the whole manifest once the decisions are gathered (_merge_manifest)
    manifest_path = opt.output_prefix + ".mp.manifest.jsonl"
    done, manifest = open_manifest(manifest_path, bool(opt.resume), n_procs,
                                   proc_id)

    if engine != "host":
        maps = _blockjoin_all_chroms_torch(st, opt.fn_bam, config,
                                           opt.n_candidates_per_iter,
                                           ref_covs, make_filter, manifest,
                                           done, opt.n_permutations,
                                           engine=engine, device=dev)
    elif opt.threads > 1 and n_jobs > 1:
        with _fut.ThreadPoolExecutor(opt.threads) as ex:
            maps = list(ex.map(
                lambda i: _blockjoin_one_chrom(st, opt.fn_bam, i, config,
                                               opt.n_candidates_per_iter,
                                               ref_covs[i], make_filter(i),
                                               manifest, done,
                                               opt.n_permutations),
                range(n_jobs)))
    else:
        maps = [_blockjoin_one_chrom(st, opt.fn_bam, i, config,
                                     opt.n_candidates_per_iter, ref_covs[i],
                                     make_filter(i), manifest, done,
                                     opt.n_permutations)
                for i in range(n_jobs)]
    manifest.close()
    local_tags: Dict[str, int] = {}
    for m in maps:
        for qn, hp in m.items():
            local_tags.setdefault(qn, hp)

    # every process ends with every gap's decision and the merged tags
    # (with one process, its own)
    local_dec = {gidx: st.ranges[i_ref].decisions[i]
                 for (i_ref, i), gidx in gap_global.items()
                 if gidx % n_procs == proc_id}
    dec = distributed.allgather_decisions(local_dec, len(gap_global))
    for (i_ref, i), gidx in gap_global.items():
        st.ranges[i_ref].decisions[i] = int(dec[gidx])
    st.qname2haptag.update(distributed.allgather_tag_maps(local_tags))
    if n_procs > 1:
        _merge_manifest(manifest_path, manifest.kept, done, st, gap_global,
                        n_procs, proc_id)
        log_info("blockjoin_parallel", f"multi-process merge: {n_procs} "
                 f"processes, {len(gap_global)} gaps")
    log_info("blockjoin_parallel", f"done, used {Get_T() - T:.1f}s.")
    return st


def main_warmup(opt: CliOpt, device=None) -> int:
    """Build what the first methphase/report run on this dataset would
    build, and run the device engine once on every packed shape it gives
    (main_warmup, pomfret_tpu/pipeline.py:501-581). The CUDA kernel
    library (--engine cuda) and the native IO library are compiled into
    their hashed build directories, where later runs find them. Every gap
    group of every chromosome is loaded and packed through pack_group, as
    run_jobs_batched packs it, and the engine runs at max_iters=0 once per
    distinct (G, R, S, layout, D, nc_cap): the kernel launches and leaves
    before iteration 1. Groups and lanes are sized for the production mesh
    (POMFRET_GAP_GROUP gaps per device, lanes padded to a multiple of the
    device count), and each shape runs split over it. --engine host has
    nothing to warm."""
    engine, dev = resolve_device(opt.engine, device)
    if engine == "host":
        log_info("main_warmup", "host engine selected; nothing to warm")
        return 0
    from .io import native
    from .kernels import _build
    from .kernels.engine_torch import pack_group
    from .parallel.batch import production_mesh, run_gap_batch
    T = Get_T()
    if engine == "cuda":
        _build.get_lib()
    if not native.native_available():
        log_warn("main_warmup", "the native IO library did not build or "
                 "load; host IO runs on its Python fallbacks")
    log_info("main_warmup", f"{engine} engine: libraries built and loaded "
             f"in {Get_T() - T:.1f}s")
    config = MmrConfig(
        k=opt.k, k_span=opt.k_span, lo=opt.lo, hi=opt.hi,
        cov_known=opt.cov, cov_for_selection=opt.cov_for_selection,
        cov_for_runtime=opt.cov_for_selection * 2,
        readlen_threshold=opt.readlen_threshold, min_mapq=opt.mapq)
    st = Storage()
    fn_interval = opt.fn_tsv or opt.fn_gtf or opt.fn_vcf
    fmt = IS_TSV if opt.fn_tsv else (IS_GTF if opt.fn_gtf else IS_VCF)
    load_intervals_from_file(fn_interval, fmt, st)
    for rg in st.ranges:
        store_raw_intervals(rg)
        merge_close_intervals(rg, READBACK)
    bam = open_alignment(opt.fn_bam, threads=opt.threads_bam)
    if config.cov_for_selection <= 0:
        name2cov = estimate_read_coverage_cached(opt.fn_bam, opt.threads_bam)
        ref_covs = [name2cov.get(n, 0) for n in st.ref_names]
    else:
        ref_covs = [config.cov_known] * len(st.ref_names)

    mesh = production_mesh(dev)
    n_dev = 1 if mesh is None else len(mesh)
    group = int(os.environ.get("POMFRET_GAP_GROUP", "128")) * n_dev
    seen = set()
    T = Get_T()
    for i_ref, rg in enumerate(st.ranges):
        cfg, n_cand = _derive_chrom_params(config, opt.n_candidates_per_iter,
                                           ref_covs[i_ref], st.ref_names[i_ref])
        for c0 in range(0, len(rg.starts), group):
            loaded = []
            for i in range(c0, min(c0 + group, len(rg.starts))):
                rs = load_reads_given_interval(bam, st.ref_names[i_ref],
                                               rg.starts[i], rg.ends[i],
                                               READBACK, cfg)
                ms_f = get_methmer_sites_and_ranges(rs, cfg, 0)
                ms_b = get_methmer_sites_and_ranges(rs, cfg, 1)
                if rs.n == 0 or ms_f.n == 0 or ms_b.n == 0:
                    continue
                loaded.append((i, rs, ms_f, ms_b))
            if not loaded:
                continue
            _datas, parts, _errs = pack_group(loaded, cfg, n_cand,
                                              lane_multiple=n_dev)
            for _idx, batch in parts:
                key = (batch.shape3, batch.blk is None, batch.D,
                       batch.nc_cap)
                if key in seen:
                    continue
                seen.add(key)
                run_gap_batch(batch, max_iters=0, engine=engine, device=dev,
                              mesh=mesh)
                G, R, S = batch.shape3
                log_info("main_warmup",
                         f"{st.ref_names[i_ref]}: ran the {engine} engine on "
                         f"G={G} R={R} S={S} D={batch.D} nc={batch.nc_cap} "
                         f"({Get_T() - T:.1f}s cumulative)")
    log_info("main_warmup", f"{len(seen)} engine shape(s) run")
    return 0


def main_blockjoin(opt: CliOpt, device=None) -> int:
    """methphase (main_blockjoin, blockjoin.c:4643-4735). With --profile,
    torch.profiler traces the whole pass (CPU activity on every thread the
    pass starts, and CUDA activity on the cuda engine): the operators, the
    kernels and the port's stages (utils.stats spans, as CPU ranges), into
    <prefix>.profile/trace.json (trace.<rank>.json for a process other
    than 0); a profiler that fails to start raises. With several
    processes, process 0 alone writes the outputs."""
    config = MmrConfig(
        k=opt.k, k_span=opt.k_span, lo=opt.lo, hi=opt.hi,
        cov_known=opt.cov, cov_for_selection=opt.cov_for_selection,
        cov_for_runtime=opt.cov_for_selection * 2,
        readlen_threshold=opt.readlen_threshold, min_mapq=opt.mapq)
    if not opt.profile:
        return _blockjoin_pass(opt, config, device)
    import torch
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile
    engine, dev = resolve_device(opt.engine, device)
    opt = dataclasses.replace(opt, engine=engine)
    acts = [ProfilerActivity.CPU]
    if engine == "cuda":
        acts.append(ProfilerActivity.CUDA)
    # every thread: the loader thread's spans too (a private option of
    # torch's, held on torch 2.11 and 2.13 by tests/test_torch_tracing.py)
    with profile(activities=acts, experimental_config=_ExperimentalConfig(
            profile_all_threads=True)) as prof:
        rc = _blockjoin_pass(opt, config, device)
        if engine == "cuda":
            torch.cuda.synchronize(dev)
    out_dir = opt.output_prefix + ".profile"
    os.makedirs(out_dir, exist_ok=True)
    rank = distributed.process_index()
    name = f"trace.{rank}.json" if rank else "trace.json"
    prof.export_chrome_trace(os.path.join(out_dir, name))
    log_info("main_blockjoin", f"profiler trace -> {out_dir}/{name}")
    return rc


def _blockjoin_pass(opt: CliOpt, config: MmrConfig, device) -> int:
    """main_blockjoin's pass: join the gaps, decide, write."""
    st = blockjoin_parallel(opt, config, device)
    lift_decisions(st)
    make_decisions_flippings_onraw(st)
    generate_new_phase_blocks(st, use_raw=True)
    if distributed.process_index() != 0:
        # every process holds the same merged state; process 0 writes
        log_info("main_blockjoin", "non-zero process: skipping output writes")
        return 0
    if opt.write_debug_files:
        with open(opt.output_prefix + ".mp.dbg.read2tag", "w") as f:
            for qn, hap in st.qname2haptag.items():
                hap = HAPTAG_UNPHASED if hap < 0 else hap
                f.write(f"{qn}\t-1\t{hap + 1}\n")
    with stage("writers"):
        output_gtf(st, opt.output_prefix)
        log_info("main_blockjoin", "gtf written.")
        if opt.do_output_tsv:
            output_tsv(st, opt.output_prefix)
            log_info("main_blockjoin", "tsv written.")
    if opt.fn_vcf:
        log_info("main_blockjoin", "writing vcf...")
        with stage("recovery"):
            recover_variant_phase_in_dropped_intervals(
                st, open_alignment(opt.fn_bam), opt.fn_vcf)
        with stage("writers"):
            output_modify_vcf(opt.fn_vcf, st, opt.output_prefix)
        log_info("main_blockjoin", "vcf written.")
    if opt.do_output_bam:
        with stage("writers"):
            output_modify_bam(opt.fn_bam, st,
                              opt.output_prefix + ".mp.bam", opt.threads_bam)
        log_info("main_blockjoin", "bam + index written.")
    return 0


def main_varhaptag(fn_vcf: str, fn_bam: str, fn_out: str, n_thread: int,
                   verbose: bool, write_bam: bool) -> int:
    # blockjoin.c:4737-4836
    st = Storage()
    bam = open_alignment(fn_bam, threads=max(1, n_thread // 2))

    def cb(chrom, variants):
        pre_haplotagging_read_in_one_ref(bam, chrom, variants,
                                         st.qname2haptag_raw)

    load_intervals_from_file(fn_vcf, IS_VCF, st, load_vcf_variants_too=True,
                             haptag_callback=cb)

    from .io.bam_writer import BamWriter
    from .io.writers import stream_retag_native

    def build_maps():
        from .io import native as _nat
        return (_nat.qmap_arrays(st.qname2haptag_raw),
                _nat.qmap_arrays({}), False)

    with open(fn_out + ".varhaptag.tsv", "w") as tsv:
        tsv.write("#qname\thaptag_input\thaptag_new\n")
        # native whole-file pass (BAM input): bulk retag + TSV from the
        # per-record metadata; Python loop below is the fallback/oracle
        if stream_retag_native(fn_bam, fn_out, build_maps, mode=1,
                               threads=max(1, n_thread // 2), tsv=tsv,
                               write_bam=write_bam):
            return 0
        w = None
        if write_bam:
            w = BamWriter(fn_out, bam.ref_names, bam.ref_lens,
                          header_text=bam.header_text,
                          threads=max(1, n_thread // 2), keep_index_info=True)
        for rec in bam.fetch_all():
            hp = st.qname2haptag_raw.get(rec.qname, HAPTAG_UNPHASED)
            t = rec.get_tag("HP")
            hp_raw = HAPTAG_UNPHASED if t is None or t == 0 else t - 1
            if w is not None:
                rec.set_int_tag("HP", hp + 1)
                w.write(rec)
            tsv.write(f"{rec.qname}\t{hp_raw + 1}\t{hp + 1}\n")
        if w is not None:
            w.close()
            w.build_index(fn_out + ".bai", n_ref=len(bam.ref_names))
    return 0


def main_methstat(opt: CliOpt) -> int:
    """Dump usable methmer site positions per gap interval
    (main_methstat, blockjoin.c:4838-4899 — present in the reference but
    unreachable from its CLI; wired up here for completeness)."""
    st = Storage()
    fn_interval = opt.fn_tsv or opt.fn_gtf or opt.fn_vcf
    fmt = IS_TSV if opt.fn_tsv else (IS_GTF if opt.fn_gtf else IS_VCF)
    load_intervals_from_file(fn_interval, fmt, st)
    bam = open_alignment(opt.fn_bam, threads=opt.threads)
    if opt.cov_for_selection <= 0:
        raw = estimate_read_coverage_cached(opt.fn_bam, opt.threads)
        name2cov = {n: c // 10 + 1 for n, c in raw.items()}
    else:
        name2cov = {n: opt.cov_for_selection for n in bam.ref_names}
    config = MmrConfig(lo=opt.lo, hi=opt.hi,
                       readlen_threshold=opt.readlen_threshold,
                       min_mapq=0, k=1, k_span=5000, cov_for_runtime=1)
    import dataclasses
    with open(opt.output_prefix + ".methstat.tsv", "w") as f:
        for i_ref, rg in enumerate(st.ranges):
            chrom = st.ref_names[i_ref]
            cfg = dataclasses.replace(config)
            cfg.cov_for_selection = name2cov.get(chrom, 1)
            for s, e in zip(rg.starts, rg.ends):
                rs = load_reads_given_interval(bam, chrom, s, e, 0, cfg)
                ms = get_methmer_sites_and_ranges(rs, cfg, 0)
                for pos in ms.sites_real_poss:
                    f.write(f"{chrom}\t{int(pos)}\n")
    log_info("main_methstat", "wrote methstat tsv")
    return 0


def main_methreport(opt: CliOpt, device=None) -> int:
    """report (main_methreport, blockjoin.c:4908-5097): probe windows
    inside the phased blocks, each scored like a gap. The batched device
    engine takes every window of every chromosome through one
    run_jobs_batched; --engine host scores them one by one. With several
    processes the windows are dealt round-robin, the decisions
    all-gathered, and process 0 writes the report."""
    engine, dev = resolve_device(opt.engine, device)
    T = Get_T()
    st = Storage()
    bam = open_alignment(opt.fn_bam, threads=opt.threads)
    if opt.bam_needs_haplotagging:
        def cb(chrom, variants):
            pre_haplotagging_read_in_one_ref(bam, chrom, variants,
                                             st.qname2haptag_raw)
        load_intervals_from_file(opt.fn_vcf, IS_VCF, st,
                                 load_vcf_variants_too=True, haptag_callback=cb)
    else:
        load_intervals_from_file(opt.fn_vcf, IS_VCF, st)

    # synthesize probe windows inside phased regions (blockjoin.c:4962-4995)
    for i_ref, rg in enumerate(st.ranges):
        starts: List[int] = []
        ends: List[int] = []
        prev = rg.abs_start
        for s, e in zip(rg.starts, rg.ends):
            if s - prev > opt.chunk_size:
                i = prev
                while i + opt.chunk_stride < s:
                    starts.append(i)
                    ends.append(i + opt.chunk_size)
                    i += opt.chunk_stride
            prev = e
        rg.starts = starts
        rg.ends = ends
        rg.decisions = [-1] * len(starts)
        log_info("main_methreport", f"{st.ref_names[i_ref]} has {len(starts)} intervals")

    name2cov_rep: Dict[str, int] = {}
    if opt.cov <= 0:
        with stage("coverage_scan"):
            name2cov_rep = estimate_read_coverage_cached(opt.fn_bam,
                                                         opt.threads)

    config = MmrConfig(k=opt.k, k_span=opt.k_span, lo=opt.lo, hi=opt.hi,
                       readlen_threshold=opt.readlen_threshold,
                       min_mapq=opt.mapq)
    # windows round-robin over processes, decisions all-gathered
    n_procs = distributed.process_count()
    proc_id = distributed.process_index()
    win_global: Dict[Tuple[int, int], int] = {}
    for i_ref, rg in enumerate(st.ranges):
        for wi in range(len(rg.starts)):
            win_global[(i_ref, wi)] = len(win_global)
    n_windows = len(win_global)
    local_dec: Dict[int, int] = {}

    jobs = []
    for i_ref, rg in enumerate(st.ranges):
        # NOTE: the reference indexes its coverage array by the STORAGE
        # ref index (blockjoin.c:5046) — wrong when the VCF's chromosome
        # order differs from the BAM header's. We look up by name and
        # warn when a VCF contig is absent from the BAM.
        if opt.cov <= 0:
            if st.ref_names[i_ref] not in name2cov_rep:
                log_warn("main_methreport",
                         f"contig {st.ref_names[i_ref]} not in BAM header; assuming coverage 0")
            cov = name2cov_rep.get(st.ref_names[i_ref], 0)
        else:
            cov = opt.cov
        cfg = dataclasses.replace(config)
        cfg.cov_for_selection = cov // 10 + 1
        cfg.cov_for_runtime = cfg.cov_for_selection * 2
        n_cand = cov // 4 + 1
        mine = [wi for wi in range(len(rg.starts))
                if win_global[(i_ref, wi)] % n_procs == proc_id]
        if engine != "host" and mine:
            jobs.append(dict(job_i=i_ref, ref_name=st.ref_names[i_ref],
                             rg=rg, cfg=cfg, n_cand=n_cand, indices=mine,
                             perm_key_base=i_ref * 1_000_003))
        else:
            for k, wi in enumerate(mine):
                decision, _ = haplotag_region_given_bam(
                    st, bam, st.ref_names[i_ref], rg.starts[wi], rg.ends[wi],
                    cfg, n_cand, n_permutations=opt.n_permutations,
                    perm_key=i_ref * 1_000_003 + wi)
                local_dec[win_global[(i_ref, wi)]] = decision
                if (k + 1) % 100 == 0:
                    log_info("main_methreport",
                             f"scored {k + 1}/{len(mine)} windows on "
                             f"{st.ref_names[i_ref]}")
    if jobs:
        from .kernels.engine_torch import run_jobs_batched
        results = run_jobs_batched(st, bam, jobs,
                                   n_permutations=opt.n_permutations,
                                   engine=engine, device=dev)
        for job, (decisions, _) in zip(jobs, results):
            for wi in job["indices"]:
                local_dec[win_global[(job["job_i"], wi)]] = decisions[wi]

    dec_vec = distributed.allgather_decisions(local_dec, n_windows)
    if proc_id != 0:
        log_info("main_methreport", f"non-zero process of {n_procs}: "
                 "skipping report write")
        return 0

    n_correct = n_switch = n_fail = tot = 0
    with open(opt.output_prefix + ".report.tsv", "w") as f:
        for i_ref, rg in enumerate(st.ranges):
            for wi, (s, e) in enumerate(zip(rg.starts, rg.ends)):
                decision = int(dec_vec[win_global[(i_ref, wi)]])
                f.write(f"{st.ref_names[i_ref]}\t{s}\t{e}\t")
                if decision == 0:
                    n_correct += 1
                    f.write("correct\n")
                elif decision == 1:
                    n_switch += 1
                    f.write("switch\n")
                else:
                    n_fail += 1
                    f.write("fail\n")
                tot += 1
                if tot % 100 == 0:
                    denom = max(n_correct + n_switch, 1)
                    print(f"Parsed N={tot} regions, currently at "
                          f"{st.ref_names[i_ref]}:{s}-{e}, "
                          f"correct/(correct+switch)={n_correct / denom * 100.0:.2f}%, "
                          f"correct/N={n_correct / tot * 100.0:.2f}%")
                f.flush()
    denom = max(n_correct + n_switch, 1)
    msg = (f"Total N={tot} regions, correct/(correct+switch)="
           f"{n_correct / denom * 100.0:.2f}%, correct/N={n_correct / max(tot, 1) * 100.0:.2f}%")
    print(msg)
    log_info("main_methreport", msg)
    log_info("main_methreport", f"done, used {Get_T() - T:.1f}s")
    return 0
