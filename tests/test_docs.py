"""Doc-drift guard in the suite: constants quoted in README.md and
docs/DESIGN.md must match the code (tools/check_docs.py).  The test-count
claim is checked by the standalone CLI (`python tools/check_docs.py
--collect`) so the in-suite check stays collection-free."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "tools"))


def test_readme_matches_latest_bench_record():
    """Kept under its old name; the bench-record half is gone with the
    old bench records, so it now checks the quoted code constants."""
    import check_docs
    problems = check_docs.check_constants()
    assert not problems, "\n".join(problems)
