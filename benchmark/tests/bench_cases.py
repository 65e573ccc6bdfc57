"""A tiny cell for the benchmark's own tests: BENCHMARK.json's cell with
its configuration's set cut to 2 chromosomes of 3 blocks of 60 kb, run by the
harness on the CPU (the port's plain torch loop; with `cuda`, on the card
with its kernels), optionally with a fault planted in the port
underneath.

    python benchmark/tests/bench_cases.py CELL SEED TRACE FAULT CACHE \
        [cuda] [procs=P]

FAULT: none; answer (the decision of a joined window of each batch
turned, cis for trans, where the port decides it); tag (one read's tag
of every joined window altered there); half (every other window of each
batch, the first among them, left undecided); unchanged (the greedy
loop returns the tags it was seeded with); rank_exit, rank_hang (rank 1
of a group exits, or never returns, in its first window pass; with
rank_hang a window pass's deadline is DEADLINE_S). procs=P sets the tiny
configuration's `procs`: each pass a gloo group of P ranks, every rank
with the same fault planted. Prints the harness's output; exits with its
code.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = dict(n_chroms=2, n_blocks=3, block_len=60_000)
DEADLINE_S = 20.0


def tiny_spec(cell: str, cache: str, procs=None) -> dict:
    """The cell's spec with its set cut to TINY (and its configuration's
    `procs` set, where given)."""
    import run
    spec = run.load_spec(ROOT, cell)
    conf = dict(spec["config"])
    conf["set"] = dict(conf["set"], **TINY,
                       per_chrom=conf["set"]["per_chrom"][:TINY["n_chroms"]])
    if procs is not None:
        conf["procs"] = procs
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, "tiny-" + spec["cell"]["config"] + ".json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return dict(spec, config=conf, config_file=path,
                procs=conf.get("procs", 1))


def _rank_1_first_window_pass() -> bool:
    spool = os.environ.get("POMFRET_SPOOL_DIR", "")
    return (os.environ.get("POMFRET_PROC_ID") == "1"
            and os.path.basename(os.path.dirname(spool)) == "p0")


def plant(fault: str) -> None:
    import time
    from pomfret_tpu_torch.kernels import engine_torch
    decide = engine_torch._decide

    def answer(loaded, perms, errs, out, decisions, tag_maps, n_perm):
        decide(loaded, perms, errs, out, decisions, tag_maps, n_perm)
        joined = [i for i, _ in loaded if decisions[i] >= 0]
        if joined:
            decisions[joined[0]] = 1 - decisions[joined[0]]

    def tag(loaded, perms, errs, out, decisions, tag_maps, n_perm):
        decide(loaded, perms, errs, out, decisions, tag_maps, n_perm)
        for i, _ in loaded:
            if tag_maps.get(i):
                q = next(iter(tag_maps[i]))
                tag_maps[i][q] = 1 - tag_maps[i][q]

    def half(loaded, perms, errs, out, decisions, tag_maps, n_perm):
        decide(loaded, perms, errs, out, decisions, tag_maps, n_perm)
        for j, (i, _) in enumerate(loaded):
            if j % 2 == 0:
                decisions[i], tag_maps[i] = -1, {}

    def rank_exit(*args):
        if _rank_1_first_window_pass():
            os._exit(1)
        decide(*args)

    def rank_hang(*args):
        while _rank_1_first_window_pass():
            time.sleep(1.0)
        decide(*args)

    if fault == "unchanged":
        import torch
        from pomfret_tpu_torch.parallel import batch

        def unchanged(ids, has_mmr, hp_init, *args, **kw):
            return hp_init.clone(), torch.zeros(
                (ids.shape[0], 8), dtype=torch.int32, device=ids.device)
        batch.loop_plain = unchanged
    elif fault != "none":
        engine_torch._decide = {"answer": answer, "tag": tag, "half": half,
                                "rank_exit": rank_exit,
                                "rank_hang": rank_hang}[fault]


def main(argv) -> int:
    import run
    cell, seed, trace, fault, cache, *extra = argv
    procs = [int(x.split("=")[1]) for x in extra if x.startswith("procs=")]
    plant(fault)
    if fault == "rank_hang":
        run.DEADLINE_FLOOR_S, run.DEADLINE_WARM_TIMES = DEADLINE_S, 0.0
    args = argparse.Namespace(workload=cell, seed=int(seed), seconds=1.0,
                              trace=int(trace))
    return run.run(args, tiny_spec(cell, cache, *procs[-1:]),
                   cpu="cuda" not in extra, cache=cache, ref_procs=2,
                   prelude=[os.path.abspath(__file__), fault])


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
