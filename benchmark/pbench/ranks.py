"""A cell run as P ranks of one gloo group on one host.

A configuration's file may name `procs`, the deployment's number of ranks
on its one host (1 where it names none). Rank 0 is the harness's own
process (run.py); ranks 1 to P-1 are this file run as a script, started by
`Group` with subprocess.Popen (fork and exec) once the set is made. Each
rank imports pbench.rss first and samples its own resident set, imports
the port, touches the card as rank 0 does, writes the port's output to a
log of its own (<work>/port.rank<r>.log) and waits on its standard input
for one JSON line a command, answering each on its standard output:

- {"cmd": "pass", "name", "argv", "env"}: the pass's variables
  (POMFRET_COORDINATOR, POMFRET_NUM_PROCS, POMFRET_PROC_ID,
  POMFRET_SPOOL_DIR) set, `pomfret_tpu_torch.cli.main(argv)` run; the
  answer gives its exit code, wall and the port's count of window reads.
- {"cmd": "window", "trace"}: sent once the warm pass is done, before
  rank 0 opens its window: the stage seconds reset and, with `trace`, the
  port traced as rank 0 traces it (`WindowTrace`; torch.profiler's start
  takes seconds, which no pass of the window may hold).
- {"cmd": "end"}: the answer gives what the rank measured (`closing`),
  then the rank exits.

A rank exits where its standard input closes or its parent is gone. A
pass of the group ends when every rank has answered; a rank that exits,
fails or passes the pass's deadline ends the run (`Group.abort`).
"""
from __future__ import annotations

import json
import os
import queue
import signal
import socket
import subprocess
import sys
import threading
import time
import traceback
from typing import Callable, Dict, List, Optional

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
GROUP_VARS = ("POMFRET_COORDINATOR", "POMFRET_NUM_PROCS", "POMFRET_PROC_ID")
LOG_TAIL = 3000  # characters of each rank's port log logged on a failure


class RankFailure(RuntimeError):
    """A rank exited, failed its pass or passed the deadline."""


def free_port(used: set) -> int:
    """A free TCP port on 127.0.0.1 that no earlier pass used."""
    while True:
        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if port not in used:
            used.add(port)
            return port


def log_tail(path: str, n: int = LOG_TAIL) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError as e:
        return f"<{e}>"


class WindowTrace:
    """The traced window of one process, as rank 0 has always traced it:
    the port's stage events on, its loop-kernel launches counted from
    outside (roofline.LoopBytes), torch.profiler over the window with the
    devtrace.MARKER range opened at its start."""

    def __init__(self, cpu: bool):
        from torch.profiler import ProfilerActivity, profile, record_function
        from pbench import devtrace, roofline
        from pomfret_tpu_torch.parallel import batch
        from pomfret_tpu_torch.utils import stats
        self._batch, self._stats = batch, stats
        stats.record_stage_events(True)
        self.loop = roofline.LoopBytes(batch.run_batch_fused3)
        batch.run_batch_fused3 = self.loop
        acts = [ProfilerActivity.CPU] + ([] if cpu else
                                         [ProfilerActivity.CUDA])
        self._prof = profile(activities=acts)
        self._prof.__enter__()
        self.t_mark = time.perf_counter()
        self._marker = record_function(devtrace.MARKER)
        self._marker.__enter__()

    def close(self):
        """The device intervals on perf_counter's clock; the stage events
        are kept in `events`."""
        from pbench import devtrace
        self._marker.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        self._batch.run_batch_fused3 = self.loop.fn
        ivs = devtrace.device_events(self._prof, self.t_mark)
        del self._prof
        self.events = self._stats.STAGE_EVENTS
        self._stats.record_stage_events(False)
        return ivs

    def loop_kernel(self, ivs) -> dict:
        return dict(launches=len(self.loop.counts),
                    bytes=self.loop.total_bytes(),
                    device_s=sum(t - s for s, t, name in ivs
                                 if "loop_kernel" in name))


class Group:
    """Ranks 1 to n-1 of the cell's group, started now; rank 0 is the
    caller. `prelude` ([file, argument]) is loaded by each rank once the
    port is imported, its plant(argument) called (the harness's tests plant
    faults so). `cleanup` runs before a failure found while rank 0 runs its
    own pass ends the process."""

    def __init__(self, n: int, work_dir: str, *, cpu: bool, prelude=(),
                 cleanup: Callable[[], None] = lambda: None):
        self.n, self.work_dir = n, work_dir
        self._err = os.dup(2)  # the run's log, while rank 0's pass has fd 2
        self.ports: set = set()
        self.answers: Dict[int, "queue.Queue"] = {}
        self.procs: Dict[int, subprocess.Popen] = {}
        self.readers: Dict[int, threading.Thread] = {}
        self.pgid: Optional[int] = None
        self._failing = threading.Lock()
        self.cleanup = cleanup
        for r in range(1, n):
            with open(self.log_path(r), "wb") as logf:
                p = subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), str(r),
                     "cpu" if cpu else "cuda", *prelude],
                    stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                    stderr=logf, process_group=self.pgid or 0)
            self.pgid = self.pgid or p.pid  # the first rank leads the group
            self.procs[r], self.answers[r] = p, queue.Queue()
            self.readers[r] = threading.Thread(
                target=self._read, args=(r, p.stdout), daemon=True)
            self.readers[r].start()
            self.say(f"rank {r} of {n} started: pid {p.pid}")

    def say(self, msg: str) -> None:
        os.write(self._err, f"[bench] {msg}\n".encode())

    def log_path(self, rank: int) -> str:
        return os.path.join(self.work_dir, "port.log" if rank == 0
                            else f"port.rank{rank}.log")

    def _read(self, rank: int, pipe) -> None:
        for line in pipe:
            try:
                msg = json.loads(line)
            except ValueError:
                continue
            self.answers[rank].put(msg)

    def _send(self, rank: int, msg: dict) -> None:
        p = self.procs[rank]
        try:
            p.stdin.write((json.dumps(msg) + "\n").encode())
            p.stdin.flush()
        except OSError as e:
            self.abort(f"rank {rank} takes no command ({e})")

    def _exited(self) -> Optional[str]:
        for r, p in self.procs.items():
            if p.poll() is not None:
                return f"rank {r} exited {p.returncode}"
        return None

    def _silent(self, rank: int) -> bool:
        """Whether `rank` has exited with nothing more to answer."""
        if self.procs[rank].poll() is None:
            return False
        self.readers[rank].join(timeout=5.0)  # its last line read
        return self.answers[rank].empty()

    def _collect(self, what: str, deadline: float) -> List[dict]:
        """Each rank's next answer, rank 1 first, before `deadline`
        (time.monotonic()); aborts where a rank that has not answered
        exits, or where one answers with a failure."""
        out = []
        for r in sorted(self.procs):
            while True:
                try:
                    msg = self.answers[r].get(timeout=0.2)
                    break
                except queue.Empty:
                    late = [s for s in sorted(self.procs)
                            if s >= r and self._silent(s)]
                    if late:
                        p = self.procs[late[0]]
                        self.abort(f"{what}: rank {late[0]} exited "
                                   f"{p.returncode}")
                    if time.monotonic() > deadline:
                        self.abort(f"{what}: rank {r} passed the deadline")
            if msg.get("rc", 0) != 0:
                self.abort(f"{what}: rank {r} exited {msg['rc']}")
            out.append(msg)
        return out

    def open_window(self, trace: bool, deadline_s: float) -> None:
        for r in sorted(self.procs):
            self._send(r, dict(cmd="window", trace=trace))
        self._collect("window", time.monotonic() + deadline_s)

    def run_pass(self, name: str, argv: List[str], spool: str,
                 own: Callable[[], None], deadline_s: float) -> List[dict]:
        """One pass of the group: every rank runs `argv` with this pass's
        variables, rank 0 by `own()` in this process. Returns ranks 1 to
        n-1's answers once every rank has answered."""
        env = dict(POMFRET_COORDINATOR=f"127.0.0.1:{free_port(self.ports)}",
                   POMFRET_NUM_PROCS=str(self.n), POMFRET_SPOOL_DIR=spool)
        deadline = time.monotonic() + deadline_s
        for r in sorted(self.procs):
            self._send(r, dict(cmd="pass", name=name, argv=argv,
                               env=dict(env, POMFRET_PROC_ID=str(r))))
        done = threading.Event()
        watch = threading.Thread(target=self._watch,
                                 args=(name, deadline, done), daemon=True)
        watch.start()
        os.environ.update(env, POMFRET_PROC_ID="0")
        try:
            own()
        except BaseException:
            done.set()
            for _ in range(10):  # a rank's exit may be what failed rank 0
                why = self._exited()
                if why:
                    break
                time.sleep(0.1)
            self.abort(f"pass {name}: {why or 'rank 0 failed'}",
                       raise_=False)
            raise
        finally:
            done.set()
            for k in GROUP_VARS:
                os.environ.pop(k, None)
        watch.join()
        return self._collect(f"pass {name}", deadline)

    def _watch(self, name: str, deadline: float, done) -> None:
        """While rank 0 runs its own pass (it may wait in a collective that
        a rank never joins): a rank that exits, or the deadline, ends the
        run from here."""
        while not done.wait(0.2):
            why = self._exited()
            if why is None and time.monotonic() > deadline:
                why = "the group passed the deadline"
            if why and not done.is_set():
                self.abort(f"pass {name}: {why}", raise_=False)
                self.cleanup()
                os._exit(1)

    def request_end(self) -> None:
        for r in sorted(self.procs):
            self._send(r, dict(cmd="end"))

    def collect_end(self, deadline_s: float) -> List[dict]:
        """Ranks 1 to n-1's `closing` records, once request_end() has
        been sent; each rank has exited then."""
        got = self._collect("end", time.monotonic() + deadline_s)
        for r, p in self.procs.items():
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                self.abort(f"rank {r} did not exit after its end")
        return [m["end"] for m in got]

    def abort(self, why: str, raise_: bool = True) -> None:
        """Kill every rank, log each port log's tail, raise RankFailure
        (the first caller alone logs)."""
        first = self._failing.acquire(blocking=False)
        self.close()
        if first:
            self.say(f"the group failed: {why}; every rank killed")
            for r in range(self.n):
                self.say(f"rank {r}'s port log ends:\n"
                         + log_tail(self.log_path(r)))
        if raise_:
            raise RankFailure(why)

    def close(self) -> None:
        """No rank left: the ranks' process group killed, each reaped."""
        if self.pgid is not None:
            try:
                os.killpg(self.pgid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                pass
        for p in self.procs.values():
            if p.poll() is None:
                p.kill()
            p.wait()
            for f in (p.stdin, p.stdout):
                try:
                    f.close()
                except OSError:
                    pass


def union(every: List[dict], lo: float, hi: float):
    """The group's trace over rank 0's window [lo, hi], from each rank's
    `closing` record (rank 0 first): (every rank's device intervals
    together, the busy seconds of their union, the loop kernel's launches,
    bytes and device seconds summed over the ranks, one record a rank with
    its own busy seconds in place of its intervals and module names)."""
    from pbench import devtrace
    ivs = [tuple(iv) for r in every for iv in r["intervals"]]
    loop = {k: sum(r["loop_kernel"][k] for r in every)
            for k in ("launches", "bytes", "device_s")}
    by_rank = [dict({k: v for k, v in r.items()
                     if k not in ("intervals", "modules")},
                    busy_s=devtrace.busy_s(r["intervals"], lo, hi))
               for r in every]
    return ivs, devtrace.busy_s(ivs, lo, hi), loop, by_rank


def closing(rank: int, sampler, trace: Optional[WindowTrace], base: dict,
            walls: List[float], cpu: bool) -> dict:
    """What a rank (rank 0 too) measured over the window, in this order:
    its peak by the port's rule (rss.run_peak_mib), the card's reserved
    peak, the window's stage seconds and counters, its DIST_STATS and
    window reads since `base` (read as the window opened), its pass walls,
    the loop kernel's launches and bytes and its device intervals
    (traced), the top-level names of its modules."""
    import torch
    from pbench import rss
    from pomfret_tpu_torch.parallel import batch, distributed
    from pomfret_tpu_torch.utils import stats
    if not cpu:
        torch.cuda.synchronize()
    sampler.__exit__(None, None, None)
    out = dict(
        rank=rank, peak_rss_mib=rss.run_peak_mib(sampler),
        memory_peak_bytes=0 if cpu else int(torch.cuda.max_memory_reserved()),
        stage_s=dict(stats.STAGE_SECONDS), counters=dict(stats.COUNTERS),
        dist={k: v - base["dist"][k]
              for k, v in distributed.DIST_STATS.items()},
        window_reads=batch.DISPATCH_STATS["window_reads"] - base["reads"],
        walls=walls, loop_kernel=None, intervals=None)
    if trace is not None:
        ivs = trace.close()
        out.update(loop_kernel=trace.loop_kernel(ivs), intervals=ivs)
    out["modules"] = sorted({m.split(".")[0] for m in sys.modules})
    return out


def serve(rank: int, cpu: bool, prelude: List[str]) -> int:
    """A rank: answer commands until `end` or until standard input
    closes."""
    from pbench import rss
    sampler = rss.RssSampler()
    sampler.__enter__()
    answers = os.fdopen(os.dup(1), "w")
    os.dup2(2, 1)  # the port's output goes to this rank's log
    parent = os.getppid()
    threading.Thread(target=_watch_parent, args=(parent,),
                     daemon=True).start()

    def answer(msg: dict) -> None:
        answers.write(json.dumps(msg) + "\n")
        answers.flush()

    import torch
    if not cpu:
        torch.zeros(1, device="cuda")
    from pomfret_tpu_torch import cli
    from pomfret_tpu_torch.parallel import batch, distributed
    from pomfret_tpu_torch.utils import stats
    if prelude:
        import importlib.util
        spec = importlib.util.spec_from_file_location("pbench_prelude",
                                                      prelude[0])
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        mod.plant(*prelude[1:])
    trace, base, walls = None, None, []
    for line in sys.stdin:
        msg = json.loads(line)
        if msg["cmd"] == "end":
            answer(dict(rank=rank, end=closing(rank, sampler, trace, base,
                                               walls, cpu)))
            return 0
        if msg["cmd"] == "window":
            stats.reset_stages()
            base = dict(dist=dict(distributed.DIST_STATS),
                        reads=batch.DISPATCH_STATS["window_reads"])
            if msg["trace"]:
                trace = WindowTrace(cpu)
            answer(dict(rank=rank, rc=0))
            continue
        os.environ.update(msg["env"])
        r0, t0 = batch.DISPATCH_STATS["window_reads"], time.perf_counter()
        try:
            rc = cli.main(msg["argv"])
        except Exception:
            traceback.print_exc()
            rc = 1
        wall = time.perf_counter() - t0
        for k in GROUP_VARS:
            os.environ.pop(k, None)
        if base is not None:
            walls.append(wall)
        answer(dict(rank=rank, name=msg["name"], rc=rc, wall=wall,
                    window_reads=batch.DISPATCH_STATS["window_reads"] - r0))
        if rc != 0:
            return 1
    return 1


def _watch_parent(parent: int) -> None:
    """Exit once the harness is gone (this rank would wait in a
    collective that no one else joins)."""
    while os.getppid() == parent:
        time.sleep(1.0)
    os._exit(1)


if __name__ == "__main__":
    sys.path[0] = BENCH  # pbench as a package, not its files as modules
    sys.path.insert(0, ROOT)
    from pbench import rss  # noqa: F401  (first: it reads the inherited peak)
    from pbench import ranks
    sys.exit(ranks.serve(int(sys.argv[1]), sys.argv[2] == "cpu",
                         sys.argv[3:]))
