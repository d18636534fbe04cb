"""Golden-format tests: emitted logs must honor the postprocess parsing
contract (token[1]=size, tokens[3:]=values, substring selectors), and the
postprocess scripts must produce a .png from them (SURVEY.md §4 implication
(c))."""

import io
import os
import subprocess
import sys

from gpu_bench.core.reporting import Reporter

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_line_contract():
    buf = io.StringIO()
    rep = Reporter("Benchmark01 : L2 norm reduction", stream=buf)
    rep.emit("Size", 1024, ["A", "B"], [1.23456789012, 2.0],
             [3.14159265358979, 2.5e-3], "GB/s")
    lines = buf.getvalue().splitlines()
    assert lines[0] == "-" * 32
    assert lines[1].startswith("Benchmark01")
    data = [l for l in lines if "Size" in l and "GB/s" in l]
    assert len(data) == 1
    toks = data[0].split()
    assert toks[1] == "1024"
    assert [float(v) for v in toks[3:]] == [3.141592654, 0.0025]
    norm_line = [l for l in lines if "norm:" in l][0]
    assert norm_line.split()[3] == "1.23456789"  # 10 significant digits


def test_postprocess_runs(tmp_path):
    log = tmp_path / "outfile.log"
    with open(log, "w") as f:
        rep = Reporter("Benchmark02 : Vector Addition", stream=f)
        for size in (1024, 2048, 4096):
            rep.emit("Size", size, ["XLA", "Pallas"], [1.0, 1.0],
                     [size * 0.001, size * 0.0012], "GB/s")
    r = subprocess.run(
        [sys.executable, os.path.join(REPO, "postprocess", "postprocess02.py"),
         str(tmp_path)],
        capture_output=True, text=True, timeout=120,
    )
    assert r.returncode == 0, r.stderr
    assert (tmp_path / "outfile.png").exists()


# ---- the SURVEY §5.5 north-star: the reference's OWN postprocess scripts,
# copied verbatim, must turn our logs into plots ----------------------------

import shutil

import pytest

REFERENCE = "/root/reference"

_REF_CASES = [
    # (reference script, log selector prefix, unit, expected png stem)
    ("benchmark01/postprocess.py", "Size", "GB/s", "outfile"),
    ("benchmark02/postprocess.py", "Size", "GB/s", "outfile"),
    ("benchmark03/postprocess.py", "Size", "GB/s", "outfile"),
    ("benchmark04/postprocess.py", "nelmt", "DOF/s", "nq8x8"),
    ("benchmark05/postprocess.py", "nelmt", "DOF/s", "nq8x8x8"),
]


@pytest.mark.skipif(not os.path.isdir(REFERENCE),
                    reason="reference checkout not present")
@pytest.mark.parametrize("script,prefix,unit,stem", _REF_CASES)
def test_reference_postprocess_unchanged(tmp_path, script, prefix, unit,
                                         stem):
    """Copy the reference's postprocess.py VERBATIM next to a log written
    by our Reporter and run it: a .png must appear.  This is the
    byte-compatibility contract SURVEY.md §5.5 names as the north-star
    ('so the five postprocess.py scripts run unchanged'; reference parsing
    contract at benchmark04/postprocess.py:10-27)."""
    shutil.copy(os.path.join(REFERENCE, script), tmp_path / "postprocess.py")
    with open(tmp_path / (stem + ".log"), "w") as f:
        rep = Reporter("Benchmark", stream=f)
        rep.sweep_title("BwdTrans (NQ = 8, 8)")
        for size in (1024, 2048, 4096):
            rep.emit(prefix, size, ["XLA", "Pallas"], [1.0, 1.0],
                     [size * 0.001, size * 0.0012], unit)
    env = dict(os.environ, MPLBACKEND="Agg", JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "postprocess.py"], cwd=tmp_path,
                       capture_output=True, text=True, timeout=180, env=env)
    assert r.returncode == 0, r.stderr
    assert (tmp_path / (stem + ".png")).exists()
