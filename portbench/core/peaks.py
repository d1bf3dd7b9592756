"""Published peaks of the cards the benchmark runs on, and the card's power
limit as ``nvidia-smi`` reads it (a card set below its maximum runs slower
under load, so the limit is printed beside every roofline share).

Peaks are NVIDIA's data-sheet figures and never a reading of the build or of
a clock at run time, so a kernel that does the same work in fewer
instructions cannot read more than its share.
"""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM5 (80 GB HBM3): 3.35 TB/s of HBM bandwidth at its 700 W limit
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(kind: str) -> float:
    try:
        return HBM_BYTES_PER_S[kind]
    except KeyError:
        raise ValueError(f"no published HBM bandwidth for {kind!r}") from None


def power_limit() -> str:
    """``nvidia-smi``'s name and power limit of card 0, or what went wrong."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
                             capture_output=True, text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi: {e}"
    return out.stdout.strip() or out.stderr.strip()
