"""CLI front-end of the port: pomfret-tpu-torch methphase | report |
methstat | warmup | varhaptag | bam2cram.

Same flags, defaults and outputs as pomfret_tpu.cli (the argument parsing
and checks are copies of it), with --engine cuda|torch|host|auto (cuda
by default: without a GPU a run that names no engine raises) and
--device. One process: the JAX package's multi-host runs
(POMFRET_NUM_PROCS > 1) are not ported.
"""
from __future__ import annotations

import argparse
import os
import sys

from . import ENGINES, VERSION
from .pipeline import (CliOpt, main_blockjoin, main_methreport,
                       main_methstat, main_varhaptag, main_warmup)
from .utils.log import (Get_T, Get_U, data_has_implicit, log_err, log_warn,
                        set_verbose)


def _add_methphase_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("bam", help="sorted+indexed BAM with MM/ML (and MD) tags")
    p.add_argument("-o", dest="output_prefix", default="pomfret")
    p.add_argument("-c", dest="cov", type=int, default=-1,
                   help="read coverage (total); inferred when absent")
    p.add_argument("-t", dest="threads", type=int, default=1)
    p.add_argument("-T", "--bam-threads", dest="threads_bam", type=int, default=None)
    p.add_argument("-k", dest="k", type=int, default=3)
    p.add_argument("-l", dest="k_span", type=int, default=5000)
    p.add_argument("-L", dest="readlen_threshold", type=int, default=15000)
    p.add_argument("-n", dest="n_candidates_per_iter", type=int, default=None,
                   help="candidates per iteration [15, or cov/4 with -c]")
    p.add_argument("--lo", type=int, default=100)
    p.add_argument("--hi", type=int, default=156)
    p.add_argument("--mapq", type=int, default=10)
    p.add_argument("--vcf", dest="fn_vcf", default=None)
    p.add_argument("--gtf", dest="fn_gtf", default=None)
    p.add_argument("--tsv", dest="fn_tsv", default=None)
    p.add_argument("-u", "--bam-is-untagged", dest="bam_needs_haplotagging",
                   action="store_true")
    p.add_argument("-U", "--write-input-tagging",
                   dest="write_bam_input_haplotagging", action="store_true")
    p.add_argument("--write-bam", dest="do_output_bam", action="store_true")
    p.add_argument("--output-tsv", dest="do_output_tsv", action="store_true")
    p.add_argument("--dbg", dest="write_debug_files", action="store_true")
    p.add_argument("--chunk-size", dest="chunk_size", type=int, default=50000)
    p.add_argument("--chunk-stride", dest="chunk_stride", type=int, default=1000000)
    p.add_argument("-v", dest="verbose", action="count", default=0)
    p.add_argument("--engine", choices=ENGINES, default="cuda",
                   help="the CUDA kernels (default; raises without a GPU), "
                        "the plain torch loop, the host oracle, or auto "
                        "(cuda when a GPU is present, else host); "
                        "POMFRET_FUSED_GEN=1|2|3 picks the engine "
                        "generation (default 3)")
    p.add_argument("--device", default=None,
                   help="device of the torch engine (default cpu); the cuda "
                        "engine takes a cuda device (default cuda)")
    p.add_argument("--resume", action="store_true",
                   help="resume from <prefix>.mp.manifest.jsonl (skip completed gaps)")
    p.add_argument("--profile", action="store_true",
                   help="write a torch.profiler trace to <prefix>.profile/")
    p.add_argument("--n-permutations", dest="n_permutations", type=int,
                   default=1,
                   help="permutation-voting restarts per direction "
                        "(reference hardcodes 1; >5 enables majority voting)")
    p.add_argument("--ref-fasta", dest="ref_fasta", default=None,
                   help="reference FASTA for CRAM input without an embedded "
                        "reference (also via POMFRET_REF_FASTA)")


def _opt_from_args(a) -> CliOpt:
    opt = CliOpt(
        threads=a.threads,
        threads_bam=a.threads_bam if a.threads_bam is not None else a.threads,
        lo=a.lo, hi=a.hi,
        fn_gtf=a.fn_gtf, fn_tsv=a.fn_tsv, fn_vcf=a.fn_vcf, fn_bam=a.bam,
        bam_needs_haplotagging=a.bam_needs_haplotagging,
        write_bam_input_haplotagging=a.write_bam_input_haplotagging,
        output_prefix=a.output_prefix,
        readlen_threshold=a.readlen_threshold, mapq=a.mapq,
        k=a.k, k_span=a.k_span, cov=a.cov,
        cov_for_selection=a.cov // 10 if a.cov > 0 else -1,
        # explicit -n beats the -c derivation (cli.c processes flags in
        # order; argparse can't, so explicit -n wins deterministically)
        n_candidates_per_iter=(a.n_candidates_per_iter
                               if a.n_candidates_per_iter is not None
                               else (a.cov // 4 if a.cov > 0 else 15)),
        do_output_bam=a.do_output_bam, do_output_tsv=a.do_output_tsv,
        write_debug_files=a.write_debug_files,
        chunk_size=a.chunk_size, chunk_stride=a.chunk_stride,
        engine=a.engine, resume=a.resume, profile=a.profile,
        n_permutations=a.n_permutations,
    )
    return opt


def _sancheck(opt: CliOpt) -> bool:
    """sancheck_cliopt (cli.c:120-241). Returns True when sane."""
    if opt.threads <= 0:
        log_warn("sancheck_cliopt", f"invalid thread number ({opt.threads}), clipped to 1")
        opt.threads = 1
    if opt.lo < 0 or opt.lo > 127:
        log_err("sancheck_cliopt", f"bad lower threshold for mod call quality ({opt.lo})")
        return False
    if opt.hi > 255 or opt.hi <= 127:
        log_err("sancheck_cliopt", f"bad upper threshold for mod call quality ({opt.hi})")
        return False
    if opt.readlen_threshold < 0:
        opt.readlen_threshold = 0
    if opt.mapq > 60:
        log_warn("sancheck_cliopt", "mapq seems too high, proceed anyways")
    if opt.mapq < 0:
        opt.mapq = 0
    if opt.k <= 0:
        log_warn("sancheck_cliopt", "clipping methmer k to 1")
        opt.k = 1
    if opt.k_span <= 0:
        log_warn("sancheck_cliopt", "clipping methmer span to 1")
        opt.k_span = 1
    if opt.n_candidates_per_iter <= 0:
        log_warn("sancheck_cliopt", "clipping candidate per iter to 1")
        opt.n_candidates_per_iter = 1
    if opt.n_permutations < 1:
        log_warn("sancheck_cliopt", "clipping n_permutations to 1")
        opt.n_permutations = 1
    if not (opt.fn_gtf or opt.fn_tsv or opt.fn_vcf):
        log_err("sancheck_cliopt", "gtf, tsv and vcf cannot all be absent")
        return False
    if opt.bam_needs_haplotagging and not opt.fn_vcf:
        log_err("sancheck_cliopt", "input bam was flagged unhaplotagged, but vcf is missing.")
        return False
    if not opt.fn_bam:
        log_err("sancheck_cliopt", "missing bam file")
        return False
    if not opt.output_prefix:
        log_err("sancheck_cliopt", "no output prefix given")
        return False
    opt.output_prefix = opt.output_prefix.rstrip("/") or None
    if not opt.output_prefix:
        log_err("sancheck_cliopt", "no output prefix given")
        return False
    if opt.chunk_size <= 0 or opt.chunk_stride <= 0:
        log_err("sancheck_cliopt", "invalid chunk size/stride")
        return False
    return True


def _sancheck_files_exist(opt: CliOpt) -> bool:
    """sancheck_cliopt_t_files_exist (blockjoin.c:4606-4641)."""
    import os
    if not os.path.exists(opt.fn_bam):
        log_err("sancheck_files", f"cannot open bam file: {opt.fn_bam}")
        return False
    for name, fn in (("vcf", opt.fn_vcf), ("gtf", opt.fn_gtf), ("tsv", opt.fn_tsv)):
        if fn and not os.path.exists(fn):
            log_err("sancheck_files", f"cannot open {name}: {fn}")
            return False
    return True


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pomfret-tpu-torch")
    sub = parser.add_subparsers(dest="cmd")
    for cmd, what in (
            ("methphase", "join phase blocks using 5mC"),
            ("report", "self-evaluate join quality on phased regions"),
            ("methstat", "dump usable methmer sites per gap"),
            ("warmup", "build the kernel and native IO libraries and run "
                       "the device engine once per shape of this dataset")):
        _add_methphase_args(sub.add_parser(cmd, help=what))
    p_vh = sub.add_parser("varhaptag", help="haplotag reads from a phased VCF")
    p_vh.add_argument("vcf")
    p_vh.add_argument("bam")
    p_vh.add_argument("-o", dest="fn_out", default="pomfret_varhaptag")
    p_vh.add_argument("-t", dest="threads", type=int, default=1)
    p_vh.add_argument("-v", dest="verbose", action="store_true")
    p_vh.add_argument("--dont-write-bam", dest="write_bam", action="store_false")
    p_vh.add_argument("--ref-fasta", dest="ref_fasta", default=None,
                      help="reference FASTA for CRAM input")
    p_bc = sub.add_parser("bam2cram", help="convert BAM to CRAM 3.0 + .crai")
    p_bc.add_argument("bam")
    p_bc.add_argument("cram")
    p_bc.add_argument("--ref-fasta", dest="ref_fasta", default=None,
                      help="encode against this FASTA (default: embed a "
                           "consensus reference per slice)")
    p_bc.add_argument("--no-ref", dest="no_ref", action="store_true",
                      help="store sequences verbatim (RR=false)")
    p_bc.add_argument("--records-per-slice", type=int, default=1000)
    return parser


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sys.stderr.write(f"[M::main] pomfret-tpu-torch {VERSION}\n")
    sys.stderr.write("[M::main] CMD: pomfret-tpu-torch " + " ".join(argv)
                     + "\n")
    T = Get_T()
    parser = _parser()
    a = parser.parse_args(argv)
    ret = 1
    if getattr(a, "ref_fasta", None) and a.cmd != "bam2cram":
        # CramReader resolves POMFRET_REF_FASTA at every internal open site
        os.environ["POMFRET_REF_FASTA"] = a.ref_fasta
    if a.cmd in ("methphase", "report", "methstat", "warmup"):
        set_verbose(a.verbose)
        opt = _opt_from_args(a)
        if not _sancheck(opt) or not _sancheck_files_exist(opt):
            ret = 1
        elif a.cmd == "warmup":
            ret = main_warmup(opt, a.device)
        elif a.cmd == "report":
            if not opt.fn_vcf:
                log_err("main", "missing input: phased vcf file.")
                ret = 1
            else:
                ret = main_methreport(opt, a.device)
        elif a.cmd == "methstat":
            ret = main_methstat(opt)
        else:
            ret = main_blockjoin(opt, a.device)
    elif a.cmd == "varhaptag":
        ret = main_varhaptag(a.vcf, a.bam, a.fn_out, a.threads, a.verbose,
                             a.write_bam)
    elif a.cmd == "bam2cram":
        from .io.cram_writer import bam_to_cram
        bam_to_cram(a.bam, a.cram, ref_fasta=a.ref_fasta,
                    embed_ref=a.ref_fasta is None and not a.no_ref,
                    no_ref=a.no_ref, records_per_slice=a.records_per_slice)
        sys.stderr.write(f"[M::bam2cram] wrote {a.cram} (+ .crai)\n")
        ret = 0
    else:
        parser.print_help(sys.stderr)
        ret = 1
    sys.stderr.write("\n[M::main] CMD: pomfret-tpu-torch " + " ".join(argv)
                     + "\n")
    sys.stderr.write(f"[M::main] used: {Get_T() - T:.1f}s, peak RSS "
                     f"{Get_U():.1f}GiB\n")
    if data_has_implicit():
        # main.c:96-100
        sys.stderr.write("[W::main] Input BAM has implicit modified base calls.\n")
        sys.stderr.write("  pomfret-tpu extracts 5mC without considering 5hmC, which is different from\n")
        sys.stderr.write("  `modkit adjust-mods --motif CG 0 --ignore h in.bam out.bam`.\n")
    return ret


if __name__ == "__main__":
    sys.exit(main())
