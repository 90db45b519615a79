"""FUNcube Dongle control — the FCD.java analog.

The reference shells out to the external ``fcdctl`` C binary for every
operation (status probe, tune, reset; FCD.java:95-189) and parses its
stdout. A server host has no USB dongle, so this wrapper degrades to
``available() == False`` when the binary is absent — exactly like the
reference's "no FCD" path (FCD.java:219-224) — while keeping the full
control surface for deployments that do have RF hardware attached to the
ingest host.
"""

from __future__ import annotations

import re
import shutil
import subprocess
from typing import NamedTuple, Optional


class FcdStatus(NamedTuple):
    version: str       # "V1.0" | "V1.1" | "V2.0"
    freq_khz: Optional[int]


class FCD:
    """Control wrapper over the ``fcdctl`` subprocess."""

    def __init__(self, binary: Optional[str] = None):
        self.binary = binary or shutil.which("fcdctl")
        self._status: Optional[FcdStatus] = None

    def available(self) -> bool:
        return self.binary is not None and self._probe() is not None

    def _run(self, *args: str) -> Optional[str]:
        if not self.binary:
            return None
        try:
            r = subprocess.run([self.binary, "-m", *args],
                               capture_output=True, text=True, timeout=10)
            if r.returncode != 0:
                return None
            return r.stdout
        except Exception:
            return None

    def _probe(self) -> Optional[FcdStatus]:
        out = self._run("-s")
        if out is None:
            return None
        ver = "V1.0"
        for v in ("V2.0", "V1.1", "V1.0"):
            if v in out:
                ver = v
                break
        m = re.search(r"FREQ\D*(\d+)", out)
        self._status = FcdStatus(ver, int(m.group(1)) if m else None)
        return self._status

    def status(self, refresh: bool = False) -> Optional[FcdStatus]:
        if refresh or self._status is None:
            return self._probe()
        return self._status

    def set_freq_khz(self, khz: int) -> bool:
        """Tune (FCD.java:158-173: fcdctl -m -f <MHz>)."""
        return self._run("-f", f"{khz / 1000.0:.6f}") is not None

    def default_rate(self) -> int:
        """96 kS/s for V1.x, 192 kS/s for V2 (jsdr.java:271-277)."""
        st = self.status()
        return 192000 if st and st.version.startswith("V2") else 96000

    def reset(self) -> bool:
        return self._run("-r") is not None

    def capture_source(self, rate: Optional[int] = None,
                       cards_path: str = "/proc/asound/cards"
                       ) -> Optional[str]:
        """A live-source spec for the dongle's audio capture device —
        the analog of FCD.getLine() locating the "FUNcube Dongle" mixer
        for direct capture (FCD.java:235-259). Scans ALSA card names and
        returns a ``capture:arecord ...`` spec consumable by
        io.live.StreamSource / the CLI, or None when absent."""
        try:
            cards = open(cards_path).read()
        except OSError:
            return None
        m = re.search(r"^\s*(\d+)\s.*FUNcube", cards, re.MULTILINE)
        if not m:
            return None
        rate = rate or self.default_rate()
        return (f"capture:arecord -D hw:{m.group(1)},0 -f S16_LE "
                f"-r {rate} -c 2 -t raw")
