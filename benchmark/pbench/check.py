"""Whether a run's passes produced what the plain reference says they must.

Once the window has closed, the reference (oracle.py, numpy from
blockjoin.c's semantics, on the maker's record of the reads and the VCF's
text) works out every gap of the set in worker processes of its own, and
the numbers below are compared, each with its limit:

- passes_differing: completed passes whose outputs differ from the last
  pass's, byte for byte (every pass runs the same job);
- windows_missing: gaps that the last pass's manifest leaves out;
- decisions_differing: gaps whose decision (cis, trans, none) differs
  from the reference's;
- tags_differing: reads of the joined gaps whose tag, as the manifest
  records it, differs from the reference's, or that only one side tags;
- lines_differing: lines of the last pass's .mp.vcf and .mp.gtf that
  differ from those the reference writes for its own decisions.

Every limit is 0: the outputs are discrete and exact.
"""
from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
from typing import Dict, List, Tuple

LIMITS = {"passes_differing": 0, "windows_missing": 0,
          "decisions_differing": 0, "tags_differing": 0,
          "lines_differing": 0}
OUTPUTS = (".mp.vcf", ".mp.gtf", ".mp.manifest.jsonl")

_READS: dict = {}


def _digest(prefix: str) -> str:
    h = hashlib.sha1()
    for ext in OUTPUTS:
        path = prefix + ext
        h.update(ext.encode())
        if os.path.exists(path):
            with open(path, "rb") as f:
                h.update(f.read())
        else:
            h.update(b"<missing>")
    return h.hexdigest()


def _worker_init(truth_path: str) -> None:
    import sys
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if here not in sys.path:
        sys.path.insert(0, here)
    from pbench import maker, oracle
    _READS.update({name: oracle.Reads(name, t) for name, t in
                   maker.load_truth(truth_path).items()})


def _coverage(args) -> Tuple[str, int]:
    from pbench import oracle
    name, ref_len = args
    return name, oracle.coverage(_READS[name], ref_len)


def _decide(args) -> dict:
    from pbench import oracle
    name, s, e, cov, precision, readback = args
    return oracle.decide(_READS[name], s, e, cov, precision, readback)


def reference(truth_path: str, ref_len: int, wins, procs: int,
              precision: str = "float32", readback: int = 50_000) -> dict:
    """Each chromosome's coverage and every gap's decision and tags, worked
    out by the reference in `procs` spawned workers (precision and
    readback other than the defaults make the controls)."""
    ctx = multiprocessing.get_context("spawn")
    names = sorted({c for c, _, _ in wins})
    with ctx.Pool(procs, initializer=_worker_init,
                  initargs=(truth_path,)) as pool:
        covs = dict(pool.map(_coverage, [(n, ref_len) for n in names]))
        got = pool.map(_decide, [(c, s, e, covs[c], precision, readback)
                                 for c, s, e in wins], chunksize=1)
    return dict(coverage=covs, windows=got)


def write_outputs(vcf_path: str, wins, got, prefix: str) -> None:
    """The .mp.gtf and .mp.vcf that the decisions `got` (one a window of
    `wins`) make of the VCF, as the reference writes them."""
    from pbench import oracle
    lines, chroms = oracle.read_vcf(vcf_path)
    dec: Dict[str, List[int]] = {ch.name: [] for ch in chroms}
    for (c, _, _), r in zip(wins, got):
        dec[c].append(int(r["decision"]))
    for ext, out in ((".mp.gtf", oracle.gtf_lines(chroms, dec)),
                     (".mp.vcf", oracle.vcf_lines(lines, chroms, dec))):
        with open(prefix + ext, "w") as f:
            f.write("".join(x + "\n" for x in out))


def _lines(path: str) -> List[str]:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return f.read().split("\n")


def _lines_differing(a: List[str], b: List[str]) -> int:
    n = max(len(a), len(b))
    return sum(1 for i in range(n)
               if (a[i] if i < len(a) else None)
               != (b[i] if i < len(b) else None))


def _record(line: str):
    """The manifest record a line holds, or None where it holds none (a
    line torn by two processes writing one manifest at once)."""
    try:
        e = json.loads(line)
    except ValueError:
        return None
    if not (isinstance(e, dict) and {"ref", "start", "end"} <= set(e)
            and type(e.get("decision")) is int
            and isinstance(e.get("tags"), dict)):
        return None
    return e


def read_manifest(path: str) -> List[dict]:
    """The records of a manifest; a line that holds none is left out, so
    the gaps it would have recorded count as missing."""
    out = []
    if os.path.exists(path):
        with open(path, errors="replace") as f:
            for line in f:
                e = _record(line) if line.strip() else None
                if e is not None:
                    out.append(e)
    return out


def compare(prefixes: List[str], wins, ref: dict,
            ref_prefix: str) -> Dict[str, int]:
    """The numbers compared, from the passes' output prefixes (in order;
    the last is judged) and the reference's decisions and outputs."""
    last = prefixes[-1]
    want = _digest(last)
    nums = {"passes_differing": sum(1 for p in prefixes
                                    if _digest(p) != want)}
    man = {(e["ref"], e["start"], e["end"]): e
           for e in read_manifest(last + ".mp.manifest.jsonl")}
    missing = dec = tags = 0
    for (c, s, e), r in zip(wins, ref["windows"]):
        got = man.get((c, s, e))
        if got is None:
            missing += 1
            continue
        if int(got["decision"]) != r["decision"]:
            dec += 1
        gt, rt = got["tags"], r["tags"]
        tags += sum(1 for q in set(gt) | set(rt) if gt.get(q) != rt.get(q))
    nums.update(windows_missing=missing, decisions_differing=dec,
                tags_differing=tags)
    nums["lines_differing"] = sum(
        _lines_differing(_lines(last + ext), _lines(ref_prefix + ext))
        for ext in (".mp.vcf", ".mp.gtf"))
    return nums


def report(nums: Dict[str, int]) -> Tuple[bool, Dict[str, dict]]:
    """(correct, each number with its limit)."""
    out = {k: {"value": v, "limit": LIMITS[k]} for k, v in nums.items()}
    return all(v <= LIMITS[k] for k, v in nums.items()), out
