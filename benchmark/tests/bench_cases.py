"""A tiny cell for the benchmark's own tests: BENCHMARK.json's cell with
its configuration's set cut to 2 chromosomes of 3 blocks of 60 kb, run by the
harness on the CPU (the port's plain torch loop; with `cuda`, on the card
with its kernels), optionally with a fault planted in the port
underneath.

    python benchmark/tests/bench_cases.py CELL SEED TRACE FAULT CACHE [cuda]

FAULT: none; answer (the decision of a joined window of each batch
turned, cis for trans, where the port decides it); tag (one read's tag
of every joined window altered there); half (every other window of each
batch, the first among them, left undecided); unchanged (the greedy
loop returns the tags it was seeded with). Prints the harness's output;
exits with its code.
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


def tiny_spec(cell: str, cache: str) -> dict:
    """The cell's spec with its set cut to TINY."""
    import run
    spec = run.load_spec(ROOT, cell)
    conf = dict(spec["config"])
    conf["set"] = dict(conf["set"], **TINY,
                       per_chrom=conf["set"]["per_chrom"][:TINY["n_chroms"]])
    os.makedirs(cache, exist_ok=True)
    path = os.path.join(cache, "tiny-" + spec["cell"]["config"] + ".json")
    with open(path, "w") as f:
        json.dump(conf, f)
    return dict(spec, config=conf, config_file=path)


def plant(fault: str) -> None:
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

    if fault == "unchanged":
        import torch
        from pomfret_tpu_torch.parallel import batch

        def unchanged(ids, has_mmr, hp_init, *args, **kw):
            return hp_init.clone(), torch.zeros(
                (ids.shape[0], 8), dtype=torch.int32, device=ids.device)
        batch.loop_plain = unchanged
    elif fault != "none":
        engine_torch._decide = {"answer": answer, "tag": tag,
                                "half": half}[fault]


def main(argv) -> int:
    import run
    cell, seed, trace, fault, cache, *device = argv
    plant(fault)
    args = argparse.Namespace(workload=cell, seed=int(seed), seconds=1.0,
                              trace=int(trace))
    return run.run(args, tiny_spec(cell, cache),
                   cpu=device != ["cuda"], cache=cache, ref_procs=2)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
