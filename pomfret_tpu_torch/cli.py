"""CLI front-end of the port: pomfret-tpu-torch methphase | report.

The flags and defaults are pomfret_tpu.cli's (reused from it), with
--engine auto|host|torch|cuda and --device. The other subcommands of
pomfret_tpu.cli are not yet ported.
"""
from __future__ import annotations

import argparse
import os
import sys

from pomfret_tpu.cli import (_add_methphase_args, _opt_from_args, _sancheck,
                             _sancheck_files_exist)
from pomfret_tpu.utils.log import (Get_T, Get_U, data_has_implicit,
                                   log_err, set_verbose)

from . import ENGINES, VERSION
from .pipeline import main_blockjoin, main_methreport

NOT_PORTED = ("methstat", "warmup", "varhaptag", "bam2cram")


def _parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog="pomfret-tpu-torch")
    sub = parser.add_subparsers(dest="cmd")
    for cmd, what in (("methphase", "join phase blocks using 5mC"),
                      ("report", "self-evaluate join quality on phased "
                                 "regions")):
        p = sub.add_parser(cmd, help=what, conflict_handler="resolve")
        _add_methphase_args(p)
        p.add_argument("--engine", choices=ENGINES, default="auto",
                       help="host oracle, the plain torch loop, or the CUDA "
                            "kernels (auto: cuda when a GPU is present, "
                            "else host); POMFRET_FUSED_GEN=1|2|3 picks the "
                            "engine generation (default 3)")
        p.add_argument("--device", default=None,
                       help="device of the torch engine (default cpu); the "
                            "cuda engine takes a cuda device (default cuda)")
    return parser


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    sys.stderr.write(f"[M::main] pomfret-tpu-torch {VERSION}\n")
    sys.stderr.write("[M::main] CMD: pomfret-tpu-torch " + " ".join(argv)
                     + "\n")
    if argv and argv[0] in NOT_PORTED:
        sys.stderr.write(f"[E::main] subcommand {argv[0]!r} is not yet "
                         "ported to pomfret_tpu_torch\n")
        return 2
    T = Get_T()
    parser = _parser()
    a = parser.parse_args(argv)
    if a.cmd not in ("methphase", "report"):
        parser.print_help(sys.stderr)
        return 1
    if a.ref_fasta:
        # CramReader resolves POMFRET_REF_FASTA at every internal open site
        os.environ["POMFRET_REF_FASTA"] = a.ref_fasta
    set_verbose(a.verbose)
    opt = _opt_from_args(a)
    if not _sancheck(opt) or not _sancheck_files_exist(opt):
        ret = 1
    elif a.cmd == "report":
        if not opt.fn_vcf:
            log_err("main", "missing input: phased vcf file.")
            ret = 1
        else:
            ret = main_methreport(opt, a.device)
    else:
        ret = main_blockjoin(opt, a.device)
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
