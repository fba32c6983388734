"""The yardstick's table of peaks: one NVIDIA H100 SXM (NVIDIA's data sheet,
dense rates) at its full 700 W; a card set to a lower power limit runs
slower under load, so the limit is read and reported beside every run."""

from __future__ import annotations

import subprocess

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
FP32_FLOP_PER_S = 67e12


def bound_s(bytes_moved: float, flops: float = 0.0, flop_per_s: float = FP32_FLOP_PER_S) -> float:
    """The least time the card could take: bytes over HBM bandwidth or
    operations over the peak rate, whichever is larger."""
    return max(bytes_moved / HBM_BYTES_PER_S, flops / flop_per_s)


def kw_queue_bytes(B: int, J: int, c: int) -> int:
    """One kw_queue call on B queues of J jobs and c slots: arrivals and
    services read once, speeds once; starts, finishes, scaled services and
    the int32 slots written once."""
    return 4 * B * J * (2 + 4) + 4 * c


def power_limit() -> str | None:
    """`nvidia-smi`'s name and power limit of the card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0] if lines else None
