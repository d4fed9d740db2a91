"""Where the tier-1 suite's wall time goes under pytest-xdist `--dist load`.

A pytest plugin and a command-line tool; it holds no tests.

As a plugin (`PYTHONPATH=tests python -m pytest ... -p torch_suite_timing`,
with TORCH_SUITE_TIMING=<file>), it appends one line per test phase to
the file: seconds since the session started, the worker, the phase
(setup, call, teardown), the outcome, its seconds and the test id.

As a tool it reads such a log and a collection list (the lines of
`pytest --collect-only -q` holding "::"), prints each test file's summed
seconds and the time its last test ended, and replays the scheduling of
pytest-xdist 3.8's LoadScheduling (xdist/scheduler/load.py) on the
logged durations: an initial chunk of N // workers // 4 consecutive tests
to each worker, then, when a worker's queue falls below
max(2, pending // workers // 4) and it is not running long tests with two
or more queued, a refill of consecutive tests up to
max(2, pending // workers // 2). A test sent to a worker stays there: a
worker that runs long tests one after another ends the run while the
others idle. `--add K` inserts K tests of `--add-seconds` each after the
last port test file, to see how the count moves the chunk boundaries;
`--noise S` repeats the replay 200 times with every duration scaled by a
lognormal factor of sigma S and prints the spread of the wall time and
the share of replays within `--limit` seconds.

    python tests/torch_suite_timing.py LOG COLLECTED [--add K] [--noise S]
"""

from __future__ import annotations

import argparse
import collections
import heapq
import os
import random
import statistics
import time

_T0 = time.time()
_FILE = None


def pytest_runtest_logreport(report):
    """Log a phase of a test (the controller sees every worker's reports;
    a worker's own lines carry "-" and are skipped by the tool)."""
    global _FILE
    path = os.environ.get("TORCH_SUITE_TIMING")
    if not path:
        return
    if _FILE is None:
        _FILE = open(path, "a")
    node = getattr(getattr(report, "node", None), "gateway", None)
    _FILE.write(f"{time.time() - _T0:.1f}\t{node.id if node else '-'}\t{report.when}\t"
                f"{report.outcome}\t{report.duration:.2f}\t{report.nodeid}\n")
    _FILE.flush()


def read_log(path):
    """[(end seconds, worker, phase, outcome, seconds, test id)] of the
    controller's lines."""
    rows = []
    for line in open(path):
        r = line.rstrip("\n").split("\t")
        if len(r) == 6 and r[1] != "-":
            rows.append((float(r[0]), r[1], r[2], r[3], float(r[4]), r[5]))
    return rows


def replay(order, seconds, workers=6):
    """(wall seconds, {worker: [(start, test id)]}) of LoadScheduling over
    the tests in collection order with the given durations."""
    pending = list(range(len(order)))
    queue = [[] for _ in range(workers)]
    chunk = max(min(len(order) // workers // 4, len(order)), 2)
    for k in range(workers):
        queue[k] += pending[:chunk]
        del pending[:chunk]
    events = [(seconds[order[q[0]]], k) for k, q in enumerate(queue) if q]
    heapq.heapify(events)
    ran = collections.defaultdict(list)
    wall = 0.0
    while events:
        now, k = heapq.heappop(events)
        item = queue[k].pop(0)
        took = seconds[order[item]]
        ran[k].append((now - took, order[item]))
        wall = max(wall, now)
        if pending:
            lo = max(2, len(pending) // workers // 4)
            hi = max(2, len(pending) // workers // 2)
            if len(queue[k]) < lo and not (took >= 0.1 and len(queue[k]) >= 2):
                n = hi - len(queue[k])
                queue[k] += pending[:n]
                del pending[:n]
        if queue[k]:
            heapq.heappush(events, (now + seconds[order[queue[k][0]]], k))
    return wall, ran


def main():
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("log")
    p.add_argument("collected")
    p.add_argument("--add", type=int, default=0)
    p.add_argument("--add-seconds", type=float, default=2.0)
    p.add_argument("--noise", type=float, default=0.0)
    p.add_argument("--limit", type=float, default=1470.0,
                   help="the run's time limit, for the share of noisy replays within it")
    p.add_argument("--unlogged-seconds", type=float, default=2.0,
                   help="duration of a collected test the log does not hold")
    a = p.parse_args()
    rows = read_log(a.log)
    summed = collections.defaultdict(float)
    last = collections.defaultdict(float)
    seconds = collections.defaultdict(float)
    for end, _, _, _, s, test in rows:
        f = test.split("::")[0]
        summed[f] += s
        last[f] = max(last[f], end)
        seconds[test] += s
    print("file, summed s, last end s")
    for f in sorted(summed, key=lambda f: -summed[f]):
        print(f"{f:45s} {summed[f]:8.1f} {last[f]:8.1f}")
    order = [line.strip() for line in open(a.collected) if "::" in line]
    missing = [t for t in order if t not in seconds]
    if a.add:
        at = max(i for i, t in enumerate(order) if t.startswith("tests/test_torch_")) + 1
        order[at:at] = [f"added::{i}" for i in range(a.add)]
    dur = {t: seconds.get(t, a.unlogged_seconds) for t in order}
    for t in order[:]:
        if t.startswith("added::"):
            dur[t] = a.add_seconds
    wall, ran = replay(order, dur)
    print(f"{len(order)} tests ({len(missing)} not in the log, {a.unlogged_seconds} s each): "
          f"replayed wall {wall:.0f} s")
    for k in sorted(ran):
        end = max(s + dur[t] for s, t in ran[k])
        longs = ", ".join(f"{t.split('::', 1)[1][:50]} @{s:.0f}" for s, t in ran[k] if dur[t] > 60)
        print(f"  worker {k}: ends {end:.0f} s; {longs}")
    if a.noise:
        rng = random.Random(0)
        walls = sorted(replay(order, {t: v * rng.lognormvariate(0, a.noise)
                                      for t, v in dur.items()})[0] for _ in range(200))
        print(f"noise {a.noise}: median {statistics.median(walls):.0f} s, "
              f"90th percentile {walls[180]:.0f} s, "
              f"{sum(w <= a.limit for w in walls) / len(walls):.2f} within {a.limit:.0f} s")


if __name__ == "__main__":
    main()
