"""The card's identity and clock, as nvidia-smi reads them."""

from __future__ import annotations

import subprocess


def smi(query: str) -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, check=True, timeout=30).stdout
    except (OSError, subprocess.SubprocessError):
        return None
    return out.strip().splitlines()[0] if out.strip() else None


def sm_clock_max_mhz() -> float | None:
    """The card's maximum SM clock (clocks.max.sm), MHz."""
    line = smi("clocks.max.sm")
    return float(line.split()[0]) if line else None
