"""Run one test many times in one pytest process -- alone, or after every
test of its file -- and record each repeat's outcome, the order the tests
ran in, and the report of every failing repeat.

    PYTHONPATH=src python3 tools/repeat_card_test.py --test FILE::TEST \
        --repeats 200 [--after-file] [--out F.json] [-- PYTEST_ARGS]

(for example ``--test tests/test_torch_cuda.py::
test_sharded_brute_on_card_matches_cpu ... -- -m cuda``; the test takes
no parameters).

Each repeat is a fresh copy of the test item (``Function.from_parent``), so
its function-scoped fixtures are set up and torn down every time, as in a
normal run.  With ``--after-file`` the whole file runs first, in its own
order, in the same process; then the repeats.  Prints one JSON line:
{"test", "after_file", "repeats", "passed", "failed", "skipped",
"file_passed", "file_failed", "first_failures", "order_before_repeats",
"seconds"}; exits 1 when a repeat failed or the
test was not collected.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import pytest


class _Repeat:
    """The plugin: replaces the collected items by the file's items (with
    ``after_file``) followed by ``n`` copies of the target, and records
    each call's outcome."""

    def __init__(self, nodeid: str, n: int, after_file: bool):
        self.nodeid, self.n, self.after_file = nodeid, n, after_file
        self.order: list[str] = []
        self.outcomes: list[tuple[str, str]] = []
        self.failures: list[dict] = []
        self.found = False

    @pytest.hookimpl(trylast=True)
    def pytest_collection_modifyitems(self, session, config, items):
        target = [it for it in items if it.nodeid == self.nodeid]
        if not target:
            items[:] = []
            return
        self.found = True
        item = target[0]
        copies = [pytest.Function.from_parent(
            item.parent, name=f"{item.name}[repeat{i}]", callobj=item.obj,
            originalname=item.originalname, keywords=dict(item.keywords))
            for i in range(self.n)]
        items[:] = (list(items) if self.after_file else []) + copies

    def pytest_runtest_logreport(self, report):
        if report.when == "call" or report.outcome != "passed":
            self.outcomes.append((report.nodeid, report.outcome))
            if report.when == "call" and "[repeat" not in report.nodeid:
                self.order.append(report.nodeid)
            if report.outcome == "failed":
                self.failures.append({"nodeid": report.nodeid,
                                      "when": report.when,
                                      "text": str(report.longrepr)[-6000:]})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--test", required=True, help="file.py::test_name")
    ap.add_argument("--repeats", type=int, default=200)
    ap.add_argument("--after-file", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("pytest_args", nargs="*")
    args = ap.parse_args()
    path = args.test.split("::")[0]
    plugin = _Repeat(args.test, args.repeats, args.after_file)
    t0 = time.perf_counter()
    pytest.main(["-q", "-p", "no:cacheprovider", "-p", "no:randomly",
                 *args.pytest_args, path], plugins=[plugin])
    reps = [o for n, o in plugin.outcomes if "[repeat" in n]
    rec = {"test": args.test, "after_file": args.after_file,
           "repeats": args.repeats,
           "passed": sum(o == "passed" for o in reps),
           "failed": sum(o == "failed" for o in reps),
           "skipped": sum(o == "skipped" for o in reps),
           "file_passed": sum(o == "passed" for n, o in plugin.outcomes
                              if "[repeat" not in n),
           "file_failed": sorted({n for n, o in plugin.outcomes
                                  if "[repeat" not in n and o == "failed"}),
           "first_failures": plugin.failures[:5],
           "order_before_repeats": plugin.order,
           "seconds": time.perf_counter() - t0}
    line = json.dumps(rec)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    print(line)
    ok = plugin.found and rec["passed"] == args.repeats
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
