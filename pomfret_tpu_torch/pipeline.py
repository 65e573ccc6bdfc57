"""methphase and report pipelines on the port's device engine.

Counterpart of pomfret_tpu/pipeline.py: blockjoin_parallel (:358-498),
_blockjoin_all_chroms_jax (here _blockjoin_all_chroms_torch, :302-355),
main_blockjoin (:584-639) and main_methreport (:722-870), with the jax
call sites replaced. Everything
else — CliOpt, the host engine's per-chromosome path, coverage estimation,
the writers — is imported from pomfret_tpu.pipeline, which imports no jax
at module level.
"""
from __future__ import annotations

import concurrent.futures as _fut
import dataclasses
import os
import sys
from typing import Dict, List, Tuple

import numpy as np

from pomfret_tpu.core.intervals import (Storage, generate_new_phase_blocks,
                                        lift_decisions,
                                        make_decisions_flippings_onraw,
                                        merge_close_intervals,
                                        store_raw_intervals)
from pomfret_tpu.core.readset import READBACK, MmrConfig
from pomfret_tpu.core.recovery import recover_variant_phase_in_dropped_intervals
from pomfret_tpu.core.varhaptag import pre_haplotagging_read_in_one_ref
from pomfret_tpu.core.variants import HAPTAG_UNPHASED
from pomfret_tpu.io.cram import open_alignment
from pomfret_tpu.io.intervals_loader import (IS_GTF, IS_TSV, IS_VCF,
                                             load_intervals_from_file)
from pomfret_tpu.io.writers import (output_gtf, output_modify_bam,
                                    output_modify_vcf, output_tsv)
from pomfret_tpu.pipeline import (CliOpt, _blockjoin_one_chrom,
                                  _derive_chrom_params,
                                  estimate_read_coverage_cached,
                                  haplotag_region_given_bam)
from pomfret_tpu.utils.log import Get_T, log_err, log_info, log_warn
from pomfret_tpu.utils.stats import stage

from . import resolve_device


def _single_process():
    if int(os.environ.get("POMFRET_NUM_PROCS", "1")) > 1:
        raise NotImplementedError("multi-process runs (POMFRET_NUM_PROCS > 1)"
                                  " are not yet ported to pomfret_tpu_torch")


def _blockjoin_all_chroms_torch(st: Storage, fn_bam: str, config: MmrConfig,
                                n_cand_in: int, ref_covs, manifest, done,
                                n_permutations: int, *, engine: str,
                                device) -> List[Dict[str, int]]:
    """All chromosomes' gap jobs through ONE device pipeline
    (run_jobs_batched), so the in-flight groups span chromosome
    boundaries. Per-chromosome parameter derivation, resume handling and
    the first-wins tag merge order (done gaps first, then engine gaps, both
    in gap order) are those of the per-chromosome path. Returns the
    per-chromosome qname->haptag maps."""
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
        indices = []
        for i in range(len(rg.starts)):
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


def blockjoin_parallel(opt: CliOpt, config: MmrConfig,
                       device=None) -> Storage:
    """Load gaps (+ optional varhaptag), then join per chromosome
    (blockjoin.c:4428-4603). opt.engine is auto|host|torch|cuda; `device`
    is where the torch engine runs (see resolve_device)."""
    _single_process()
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
        # one device serializes the loop; worker threads would only add
        # resident batches
        log_warn("blockjoin_parallel",
                 f"{engine} engine drives a single device; clamping worker threads to 1")
        opt = dataclasses.replace(opt, threads=1)

    from pomfret_tpu.utils.manifest import ManifestWriter, load_manifest
    manifest_path = opt.output_prefix + ".mp.manifest.jsonl"
    done = load_manifest(manifest_path) if opt.resume else None
    manifest = ManifestWriter(manifest_path, append=bool(opt.resume))

    if engine != "host":
        maps = _blockjoin_all_chroms_torch(st, opt.fn_bam, config,
                                           opt.n_candidates_per_iter,
                                           ref_covs, manifest, done,
                                           opt.n_permutations,
                                           engine=engine, device=dev)
    elif opt.threads > 1 and n_jobs > 1:
        with _fut.ThreadPoolExecutor(opt.threads) as ex:
            maps = list(ex.map(
                lambda i: _blockjoin_one_chrom(st, opt.fn_bam, i, config,
                                               opt.n_candidates_per_iter,
                                               ref_covs[i], "host", None,
                                               manifest, done,
                                               opt.n_permutations),
                range(n_jobs)))
    else:
        maps = [_blockjoin_one_chrom(st, opt.fn_bam, i, config,
                                     opt.n_candidates_per_iter, ref_covs[i],
                                     "host", None, manifest, done,
                                     opt.n_permutations)
                for i in range(n_jobs)]
    manifest.close()
    local_tags: Dict[str, int] = {}
    for m in maps:
        for qn, hp in m.items():
            local_tags.setdefault(qn, hp)
    st.qname2haptag.update(local_tags)
    log_info("blockjoin_parallel", f"done, used {Get_T() - T:.1f}s.")
    return st


def main_blockjoin(opt: CliOpt, device=None) -> int:
    """methphase (main_blockjoin, blockjoin.c:4643-4735)."""
    if opt.profile:
        raise NotImplementedError("--profile is not yet ported to "
                                  "pomfret_tpu_torch")
    config = MmrConfig(
        k=opt.k, k_span=opt.k_span, lo=opt.lo, hi=opt.hi,
        cov_known=opt.cov, cov_for_selection=opt.cov_for_selection,
        cov_for_runtime=opt.cov_for_selection * 2,
        readlen_threshold=opt.readlen_threshold, min_mapq=opt.mapq)
    st = blockjoin_parallel(opt, config, device)
    lift_decisions(st)
    make_decisions_flippings_onraw(st)
    generate_new_phase_blocks(st, use_raw=True)
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


def main_methreport(opt: CliOpt, device=None) -> int:
    """report (main_methreport, blockjoin.c:4908-5097): probe windows
    inside the phased blocks, each scored like a gap. The batched device
    engine takes every window of every chromosome through one
    run_jobs_batched; --engine host scores them one by one. One process;
    the JAX package's round-robin over hosts is not ported."""
    _single_process()
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
    win_global: Dict[Tuple[int, int], int] = {}
    g = 0
    for i_ref, rg in enumerate(st.ranges):
        for wi in range(len(rg.starts)):
            win_global[(i_ref, wi)] = g
            g += 1
    n_windows = g
    dec_vec = np.full(n_windows, -1, dtype=np.int32)

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
        mine = list(range(len(rg.starts)))
        if engine != "host" and mine:
            jobs.append(dict(job_i=i_ref, ref_name=st.ref_names[i_ref],
                             rg=rg, cfg=cfg, n_cand=n_cand, indices=mine,
                             perm_key_base=i_ref * 1_000_003))
        else:
            for k, wi in enumerate(mine):
                decision, _ = haplotag_region_given_bam(
                    st, bam, st.ref_names[i_ref], rg.starts[wi], rg.ends[wi],
                    cfg, n_cand, "host", opt.n_permutations,
                    perm_key=i_ref * 1_000_003 + wi)
                dec_vec[win_global[(i_ref, wi)]] = decision
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
                dec_vec[win_global[(job["job_i"], wi)]] = decisions[wi]

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
