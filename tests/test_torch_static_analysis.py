"""The port under the repository's static analyzer (``znicz_tpu.analysis``,
every rule, no baseline): zero findings.  Where the port keeps a JAX
construct the analyzer flags, it carries JAX's pragma with JAX's reason.
``--no-cache`` keeps the run from writing the analyzer's cache file into
the repository."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_the_port_has_no_findings_under_every_rule():
    out = subprocess.run(
        [sys.executable, "-m", "znicz_tpu.analysis", "znicz_tpu_torch", "--no-baseline",
         "--no-cache"],
        cwd=REPO, capture_output=True, text=True, timeout=300,
    )
    assert out.returncode == 0, out.stdout + out.stderr
    # the summary goes to stderr, each finding to stdout
    assert "0 new finding(s)" in out.stderr, out.stderr
    assert "ZNC" not in out.stdout, out.stdout
