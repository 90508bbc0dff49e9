"""Roofline arithmetic for the extension kernel (K1, K1p).

A frozen copy, so that later changes to the port cannot move the
yardstick, of ``chip_smoke.py``'s ``HBM_BYTES_PER_S``, ``OPS_PER_CELL``
(K1's 12 integer operations per band cell), ``bound``, ``k1_work`` and
the INT32 rate it reads from the card (SMs x 64 INT32 lanes x the
maximum SM clock), and of ``dentist_tpu_torch/ops/banded.py``'s
``bw_for``, as of commit 6dfa3e3.  A launch's bound is the larger of its
bytes over the HBM bandwidth and its integer operations over the INT32
rate, both counted from the launch's own arguments: every lane's band
cells up to its ``a_len``, each input read once and the result block
written once.
"""

from __future__ import annotations

import subprocess

#: the H100's HBM bandwidth (NVIDIA's data sheet, SXM), bytes/s
HBM_BYTES_PER_S = 3.35e12
#: integer operations per band cell of K1: the recurrence's compares,
#: adds, mins and selects, the score key and its max
K1_OPS_PER_CELL = 12
#: DP rows per trace sample of the result block
TRACE = 126


def int_ops_per_s() -> float:
    """The card's INT32 issue rate: SMs x 64 lanes x max SM clock."""
    import torch

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True).stdout.split()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * 64 * mhz * 1e6


def bw_for(R: int, W: int) -> int:
    """B-window width for an R-row bucket, rounded to a multiple of 4."""
    bw = int(1.4 * R) + 2 * W + 8
    return -(-bw // 4) * 4


def k1_bound_s(n_lanes: int, rows_sum: int, meta_bytes: int, R: int, W: int,
               packed: bool, int_rate: float) -> float:
    """Least seconds for one K1 (``packed=False``) or K1p launch of
    ``n_lanes`` lanes whose ``a_len`` clamped to [0, R] sum to
    ``rows_sum``: band cells at ``K1_OPS_PER_CELL`` operations each
    against ``int_rate``, or the windows (2-bit rows for K1p), the meta
    and the (4 + R/126, N) int32 result against the HBM bandwidth."""
    BW = bw_for(R, W)
    cells = rows_sum * W
    win = n_lanes * (R + BW) // 4 if packed else n_lanes * (R + BW)
    io = win + meta_bytes + n_lanes * 4 * (4 + R // TRACE)
    return max(io / HBM_BYTES_PER_S, K1_OPS_PER_CELL * cells / int_rate)
