"""Hostile Rice scan lanes shared by the CPU and the card's kernel tests
(no JAX import: the card's test file runs without it)."""

import numpy as np
import torch


def hostile_lanes(W: int, n: int, seed: int = 0):
    """(words, rstart, err, is_rice, order, n_codes, pbits, psm) of lanes
    built to reach every path of the reader; row b is lane b:

    0-1  all-ones words, 7-bit parameters: k = 127 (escape), every code a
         jump of 128+ bits past the buffered ones; psm = -1 on lane 1
    2    all-zero words: q = 64 from the first code
    3    ones on even words only: q = 32 at every odd word
    4    a cursor that starts past the window; 5 one that starts before it
    6    5-bit parameters of 31 (escape) in random words, psm = -1
    7    not Rice; 8 err on entry; 9 n_codes < 0; 10 pbits 0 (k = 0, err)
    11.. random words and headers (6- and 7-bit parameters too)
    """
    rng = np.random.default_rng(seed)
    B = 24
    words = rng.integers(0, 1 << 32, (B, W), dtype=np.uint64).astype(np.uint32)
    words[0:2] = 0xFFFFFFFF
    words[2] = 0
    words[3] = 0
    words[3, ::2] = 0xFFFFFFFF
    words[6, ::3] = 0xFBFFFFFF
    lane = lambda lo, hi: rng.integers(lo, hi, B).astype(np.int32)  # noqa: E731
    rstart = lane(0, 32 * W)
    rstart[:4] = [3, 0, 5, 17]
    rstart[4], rstart[5], rstart[6] = 32 * W + 40, -70, 0
    is_rice = rng.random(B) < 0.9
    is_rice[:7] = True
    is_rice[7] = False
    err = np.zeros(B, bool)
    err[8] = True
    order = lane(0, 13)
    n_codes = lane(n - 12, n + 1)
    n_codes[9] = -3
    pbits = lane(4, 8)
    pbits[[0, 1, 2, 3]] = 7
    pbits[6] = 5
    pbits[10] = 0
    psm = ((1 << rng.integers(0, 9, B)) - 1).astype(np.int32)
    psm[[1, 6]] = -1
    t = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a)).to(dt)  # noqa: E731
    return (t(words.view(np.int32), torch.int32), t(rstart, torch.int32), t(err, torch.bool),
            t(is_rice, torch.bool), t(order, torch.int32), t(n_codes, torch.int32),
            t(pbits, torch.int32), t(psm, torch.int32))
