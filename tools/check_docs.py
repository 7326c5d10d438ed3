"""Doc-drift guard: numbers the docs quote from the code must match it.

- docs/DESIGN.md's and README's "<N>-frame discarded warmup" must equal the
  live ``DEFAULT_WARMUP_FRAMES`` constant exactly;
- README's "N tests" line must match the live collected count exactly
  (``--tests N`` to supply it, ``--collect`` to run pytest collection here;
  skipped otherwise so the in-suite test stays cheap).

Speed numbers are not checked here: they come from runs on the card and
live in PERF.md with their origin.

Run standalone:  python tools/check_docs.py --collect
In-suite:        tests/test_docs.py calls check_constants().
Exit code 1 on any mismatch, listing each one.
"""

import argparse
import os
import re
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def check_constants():
    """Docs quoting code constants must match the live source (exactly).

    Currently pinned: the segmented-analysis default warmup length, which
    docs once quoted stale after the constant changed."""
    problems = []
    seg_src = open(os.path.join(
        ROOT, "audio_analyzer_rs_tpu", "models", "segmented.py")).read()
    m = re.search(r"^DEFAULT_WARMUP_FRAMES\s*=\s*(\d+)", seg_src, re.M)
    if not m:
        return ["models/segmented.py: DEFAULT_WARMUP_FRAMES not found"]
    warmup = int(m.group(1))
    for fname in ("README.md", os.path.join("docs", "DESIGN.md")):
        body = open(os.path.join(ROOT, fname)).read()
        for q in re.finditer(r"(\d+)-frame discarded warmup", body):
            if int(q.group(1)) != warmup:
                problems.append(
                    f"{fname}: '{q.group(0)}' != DEFAULT_WARMUP_FRAMES="
                    f"{warmup} (models/segmented.py)")
    return problems


def check_test_count(collected: int):
    """README's 'N tests' claim vs the live collected count."""
    readme = open(os.path.join(ROOT, "README.md")).read()
    m = re.search(r"(\d+) tests", readme)
    if not m:
        return []
    quoted = int(m.group(1))
    if quoted != collected:
        return [f"README.md says '{quoted} tests' but the suite collects "
                f"{collected}"]
    return []


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tests", type=int, default=None,
                    help="collected test count to check README against")
    ap.add_argument("--collect", action="store_true",
                    help="run pytest --collect-only here to get the count")
    args = ap.parse_args()

    problems = check_constants()
    collected = args.tests
    if args.collect and collected is None:
        import subprocess
        out = subprocess.run(
            [sys.executable, "-m", "pytest", "tests/", "--collect-only",
             "-q"], cwd=ROOT, capture_output=True, text=True).stdout
        m = re.search(r"(\d+) tests collected", out)
        if m:
            collected = int(m.group(1))
        else:
            problems.append("could not parse pytest --collect-only output")
    if collected is not None:
        problems += check_test_count(collected)

    for p in problems:
        print(f"DOC DRIFT: {p}", file=sys.stderr)
    if problems:
        sys.exit(1)
    print("docs agree with the code"
          + (f" and {collected} collected tests" if collected else ""))


if __name__ == "__main__":
    main()
