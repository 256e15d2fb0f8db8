"""Per-test timeline of a pytest run, and its summary.

As a plugin it appends one JSON line per test (xdist worker, node id,
start and end time, process id) to the file named by ``TIMELINE_OUT``,
and does nothing where that is unset:

    TIMELINE_OUT=/tmp/tl.jsonl PYTHONPATH=src:tests python -m pytest -q \\
        -p _timeline -p xdist -n 6 --dist load --junitxml=/tmp/t.xml ...

Run as a script, it summarises such a file: per worker process its test
count, first start, last end and busy seconds (a worker that crashed
shows as one process, its replacement as another), the tests that ran
longer than 30 s, and busy seconds per file. With the run's JUnit XML
and its terminal log it also says how many passes had ended by a time
limit and how many passes the log's progress lines show (a crashed
worker's message breaks the progress line it is printed into):

    python tests/_timeline.py /tmp/tl.jsonl --xml /tmp/t.xml \\
        --log /tmp/t.log --limit 1470
"""
import argparse
import json
import os
import re
import time
from collections import defaultdict

import pytest

_OUT = os.environ.get("TIMELINE_OUT")


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_protocol(item, nextitem):
    t0 = time.time()
    yield
    if _OUT:
        with open(_OUT, "a") as f:
            f.write(json.dumps({
                "w": os.environ.get("PYTEST_XDIST_WORKER", "-"),
                "id": item.nodeid, "t0": t0, "t1": time.time(),
                "pid": os.getpid()}) + "\n")


def _outcomes(xml_path):
    import xml.etree.ElementTree as ET
    out = {}
    for tc in ET.parse(xml_path).getroot().iter("testcase"):
        nid = tc.get("classname").replace(".", "/") + ".py::" + tc.get("name")
        kids = {c.tag for c in tc}
        out[nid] = ("fail" if kids & {"failure", "error"} else
                    "skip" if "skipped" in kids else "pass")
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("timeline")
    ap.add_argument("--xml")
    ap.add_argument("--log")
    ap.add_argument("--limit", type=float, default=1470.0)
    args = ap.parse_args()
    rows = [json.loads(line) for line in open(args.timeline)]
    t0 = min(r["t0"] for r in rows)
    by_worker = defaultdict(list)
    for r in rows:
        by_worker[(r["w"], r["pid"])].append(r)
    for (w, pid), rs in sorted(by_worker.items()):
        rs.sort(key=lambda r: r["t0"])
        print(f"{w} pid {pid}: {len(rs)} tests, start {rs[0]['t0'] - t0:.0f}"
              f" s, end {rs[-1]['t1'] - t0:.0f} s, busy "
              f"{sum(r['t1'] - r['t0'] for r in rs):.0f} s")
    for r in sorted(rows, key=lambda r: r["t0"]):
        if r["t1"] - r["t0"] > 30:
            print(f"  {r['w']} {r['t0'] - t0:.0f}-{r['t1'] - t0:.0f} s "
                  f"({r['t1'] - r['t0']:.0f} s) {r['id']}")
    per_file = defaultdict(float)
    for r in rows:
        per_file[r["id"].split("::")[0]] += r["t1"] - r["t0"]
    for name, s in sorted(per_file.items(), key=lambda kv: -kv[1]):
        print(f"{s:8.1f} s  {name}")
    port = sum(s for name, s in per_file.items() if "test_torch_" in name)
    print(f"busy {sum(per_file.values()):.0f} s, of it the port's tests "
          f"{port:.0f} s; last end {max(r['t1'] for r in rows) - t0:.0f} s")
    if args.xml:
        outcome = _outcomes(args.xml)
        passed = sum(v == "pass" for v in outcome.values())
        by_limit = sum(outcome.get(r["id"]) == "pass"
                       and r["t1"] - t0 <= args.limit for r in rows)
        print(f"passed {passed}; ended by {args.limit:.0f} s: {by_limit}")
        if args.log:
            prog = re.compile(r"[.FEsx]+( *\[ *[0-9]+%\])?")
            dots = sum(line.count(".") for line in open(args.log).read()
                       .split("\n") if prog.fullmatch(line))
            print(f"passes on whole progress lines of the log: {dots} "
                  f"({passed - dots} on lines a crash message broke)")


if __name__ == "__main__":
    main()
