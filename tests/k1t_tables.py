"""Band-offset tables for the tests of K1t, the extension DP's table
mode: the ladder of the slopes ``num_k`` with its last ``walks``
schedules replaced by random walks of 0..2 columns a row from the
ladder's row 0, kept inside the B window as the table mode requires."""

import numpy as np

from dentist_tpu_torch.ops.banded import _CHUNK, bw_for, ladder


def walk_table(seed: int, num_k, R: int, W: int, walks: int = 1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    offs = ladder(num_k, R, W)
    top = bw_for(R, W) - 2 * W - 2 * _CHUNK + 1  # the last row's widest
    for k in range(offs.shape[1] - walks, offs.shape[1]):
        steps = rng.choice(3, size=R, p=(0.25, 0.5, 0.25))
        excess = int(offs[0, k] + steps.sum() - top)
        if excess > 0:
            steps[np.flatnonzero(steps)[:excess]] -= 1
        offs[1:, k] = offs[0, k] + np.cumsum(steps)
    return offs
