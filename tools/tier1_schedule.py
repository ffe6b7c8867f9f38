"""Replay a tier-1 run's test times under pytest-xdist's ``--dist loadfile``.

The tier-1 command runs ``pytest -n 6 --dist loadfile`` and writes each
test's time (setup and teardown included) to a junit XML file.  This script
reads that file and replays the run as pytest-xdist 3.x schedules it:

* a work unit is a test file;
* the queue holds the files ordered by their number of tests, most first,
  ties in collection order (xdist's default ``--loadscope-reorder``);
* each worker is first given one file, and a second one at once where its
  first holds 2 tests or fewer;
* when one of a worker's tests completes and 2 or fewer of its tests are left
  to run, the worker is given the next file of the queue.

It prints, for each worker, when it was given each file and when it ended,
and the replayed wall time: the latest end, without the run's collection
and start-up.  ``--move FILE::PREFIX=DEST`` replays a layout in which the
tests of FILE whose names start with PREFIX live in the file DEST instead
(a new file or an existing one), to weigh a change of layout before making
it.  One replay can swing by a minute when a small change reorders the
tail, so ``--draws N`` also replays N copies with each file's times scaled
by a random log-normal factor (sigma 0.15; each test's by a tenth of that)
and prints their mean and 90th percentile; every layout gets the same draws.  The replay knows nothing of how workers slow each other
down, so compare layouts on the times of one run, and confirm a chosen
layout with the tier-1 command itself.

    python3 tools/tier1_schedule.py /tmp/_t1.xml
    python3 tools/tier1_schedule.py /tmp/_t1.xml --draws 300 \\
        --move test_torch_msm_cases::=test_torch_msm
"""

import argparse
import collections
import heapq
import random
import xml.etree.ElementTree as ET


def load(path):
    """{file: [(test name, seconds), ...]} in the order the XML lists them."""
    root = ET.parse(path).getroot()
    suite = root.find("testsuite") if root.tag == "testsuites" else root
    files = collections.OrderedDict()
    for case in suite.iter("testcase"):
        name = case.get("classname").split(".")[1]       # tests.<file>[.<Class>]
        files.setdefault(name, []).append((case.get("name"), float(case.get("time"))))
    return files


def move(files, spec):
    """Apply one ``FILE::PREFIX=DEST`` to a copy of ``files``."""
    src_prefix, dest = spec.split("=", 1)
    src, prefix = src_prefix.split("::", 1)
    out = {k: list(v) for k, v in files.items()}
    moved = [t for t in out[src] if t[0].startswith(prefix)]
    out[src] = [t for t in out[src] if not t[0].startswith(prefix)]
    out[dest] = out.get(dest, []) + moved
    return {k: v for k, v in out.items() if v}


WORKERS = 6     # the tier-1 command's -n
SPREAD = 0.15   # sigma of a file's log-normal time factor in --draws


def replay(files, scale=None):
    """Per worker: [(seconds when given, file), ...] and its end; the wall."""
    scale = scale or {}
    workers = WORKERS
    queue = collections.deque(sorted(sorted(files), key=lambda f: -len(files[f])))
    pending = [collections.deque() for _ in range(workers)]
    given = [[] for _ in range(workers)]

    def give(w, now):
        f = queue.popleft()
        pending[w].extend(t * scale.get(f, 1.0) for _, t in files[f])
        given[w].append((now, f))

    for w in range(min(workers, len(queue))):
        give(w, 0.0)
    for w in range(workers):
        if queue and len(pending[w]) <= 2:
            give(w, 0.0)
    events = [(pending[w][0], w) for w in range(workers) if pending[w]]
    heapq.heapify(events)
    ends = [0.0] * workers
    while events:
        now, w = heapq.heappop(events)
        pending[w].popleft()                    # its running test completes
        if queue and len(pending[w]) <= 2:
            give(w, now)
        if pending[w]:
            heapq.heappush(events, (now + pending[w][0], w))
        else:
            ends[w] = now
    return given, ends, max(ends)


def draws(files, count):
    """Mean and 90th percentile of the wall time over ``count`` noisy replays."""
    rng, walls = random.Random(1), []
    names = sorted(files)
    for _ in range(count):
        factor = {f: rng.lognormvariate(0, SPREAD) for f in names}
        noisy = {f: [(n, t * rng.lognormvariate(0, SPREAD / 10)) for n, t in files[f]]
                 for f in names}
        walls.append(replay(noisy, factor)[2])
    walls.sort()
    return sum(walls) / count, walls[int(0.9 * count)]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("xml", help="the junit XML of a tier-1 run")
    ap.add_argument("--move", action="append", default=[], metavar="FILE::PREFIX=DEST")
    ap.add_argument("--draws", type=int, default=0, metavar="N")
    args = ap.parse_args()
    files = load(args.xml)
    for spec in args.move:
        files = move(files, spec)
    given, ends, wall = replay(files)
    for w, (g, end) in enumerate(zip(given, ends)):
        print(f"gw{w} ends {end:7.1f} s: " + ", ".join(f"{f} at {t:.0f}" for t, f in g))
    print(f"replayed wall time {wall:.1f} s (collection and start-up not included)")
    if args.draws:
        mean, p90 = draws(files, args.draws)
        print(f"{args.draws} noisy replays: mean {mean:.1f} s, 90th percentile {p90:.1f} s")


if __name__ == "__main__":
    main()
