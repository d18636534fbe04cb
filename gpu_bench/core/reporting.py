"""Log-line writer.

The emitted format is a strict contract with the postprocessing pipeline
(SURVEY.md §3.3): for b01-b03 every throughput line contains the selector
substrings "Size" + "GB/s", token [1] is the size, tokens [3:] are the
per-variant values (benchmark01/postprocess.py:10-15); b04/b05 use
"nelmt" + "DOF/s" plus a title line containing "NQ ="
(benchmark04/postprocess.py:10-11).  Values are printed with 10 significant
digits, matching the reference's std::setprecision(10)
(benchmark01/benchmark01.cc:318).
"""

from __future__ import annotations

import sys
from typing import Optional, Sequence, TextIO


def fmt10(v: float) -> str:
    """10-significant-digit formatting, like std::setprecision(10)."""
    return f"{v:.10g}"


class Reporter:
    failures = 0  # warnings raised so far; the CLIs exit non-zero if any

    def __init__(self, title: str, stream: Optional[TextIO] = None):
        self.stream = stream if stream is not None else sys.stdout
        bar = "-" * 32
        self._write(bar)
        self._write(f"{title:<32}")
        self._write(bar)

    def _write(self, line: str) -> None:
        self.stream.write(line + "\n")
        self.stream.flush()  # append-to-log semantics: partial sweeps usable

    def sweep_title(self, line: str) -> None:
        """e.g. 'BwdTrans (NQ = 8, 8)' — parsed as the plot title."""
        self._write(line)

    def emit(
        self,
        prefix: str,
        size: int,
        labels: Sequence[str],
        norms: Sequence[float],
        values: Sequence[float],
        unit: str,
    ) -> None:
        """Write the Case/norm/throughput line triple for one sweep point."""
        self._write(f"{prefix} {size} Case: " + " ".join(labels))
        self._write(f"{prefix} {size} norm: " + " ".join(fmt10(n) for n in norms))
        self._write(f"{prefix} {size} {unit}: " + " ".join(fmt10(v) for v in values))

    def note(self, msg: str) -> None:
        """Out-of-band message; goes to stderr so logs stay parseable."""
        print(msg, file=sys.stderr, flush=True)

    def warn(self, msg: Optional[str]) -> None:
        """Count a failure (a variant, a row, a norm disagreement) and print
        it as a WARNING note; msg=None counts without printing."""
        self.failures += 1
        if msg is not None:
            self.note("WARNING: " + msg)
