"""Bound A of the nearest-neighbour kernel, frozen from the port's PERF.md (kernel table).

The least time one H100 SXM could take for a ``nearest_batch`` launch of
shape ``(B, Nq, Nr)``: 8 float32 operations for each launched query and each
*valid* reference point (three fused multiply-adds, a compare and a select),
at the data sheet's 67 TFLOP/s outside the tensor cores, or the bytes it must
move (queries and references read once, the mask once, distance and index
written once) at 3.35 TB/s, whichever is longer. The data sheet's rates assume
the 700 W power limit; the traced run prints the card's limit beside the share.
"""

from __future__ import annotations

PEAK_F32_OPS = 67e12  # operations/s, H100 SXM data sheet, float32 outside the tensor cores
PEAK_HBM_BYTES = 3.35e12  # bytes/s, H100 SXM data sheet
OPS_PER_PAIR = 8


def launch_bound_s(b: int, nq: int, nr: int, valid_refs: int) -> float:
    """Seconds of one launch; ``valid_refs`` counts the valid refs over the whole batch."""
    ops = OPS_PER_PAIR * nq * valid_refs
    moved = b * nq * 12 + b * nr * 12 + b * nr + b * nq * 8
    return max(ops / PEAK_F32_OPS, moved / PEAK_HBM_BYTES)


def total_bound_s(launches) -> float:
    """Sum over ``(B, Nq, Nr, count, valid refs of the batch)`` records."""
    return sum(count * launch_bound_s(b, nq, nr, refs) for b, nq, nr, count, refs in launches)
