"""Runnable formatting gate (no third-party deps).

The reference CI gates on ``black --check``
(/root/reference/.circleci/config.yml); black is unavailable in this
build's primary environment, so this enforces the mechanically-checkable
slice of the same contract with the stdlib only:

* no tab characters in source lines
* no trailing whitespace
* lines <= 100 characters (black's 88 plus a grace margin for tables)
* file ends with exactly one newline

Run: ``python tools/format_gate.py [paths...]`` — exits 1 with a listing
on violation.  Wired into tox's default envlist; the black env remains
for environments that have black installed.
"""

from __future__ import annotations

import pathlib
import sys

MAX_LEN = 100
DEFAULT_PATHS = [
    "pyrayt_tpu", "tests", "bench.py", "chip_smoke.py", "__graft_entry__.py", "examples",
]


def check_file(path: pathlib.Path):
    problems = []
    try:
        text = path.read_text()
    except UnicodeDecodeError:
        return [f"{path}: not utf-8"]
    lines = text.split("\n")
    for i, line in enumerate(lines, 1):
        if "\t" in line:
            problems.append(f"{path}:{i}: tab character")
        if line != line.rstrip():
            problems.append(f"{path}:{i}: trailing whitespace")
        if len(line) > MAX_LEN:
            problems.append(f"{path}:{i}: line length {len(line)} > {MAX_LEN}")
    if text and not text.endswith("\n"):
        problems.append(f"{path}: missing final newline")
    if text.endswith("\n\n"):
        problems.append(f"{path}: multiple trailing newlines")
    return problems


def main(argv):
    roots = argv[1:] or DEFAULT_PATHS
    problems = []
    for root in roots:
        p = pathlib.Path(root)
        files = [p] if p.is_file() else sorted(p.rglob("*.py"))
        for f in files:
            problems += check_file(f)
    for problem in problems:
        print(problem)
    print(f"format gate: {len(problems)} problem(s)")
    return 1 if problems else 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
