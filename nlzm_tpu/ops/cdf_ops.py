"""Batched CDF bank for the device engine.

All 72 adaptive CDF contexts of the LZ model live in one [B, 72, 17] int32
tensor ("the bank"); every context is padded to 17 fences with pad fences
pinned at full scale, so lookup and update are uniform 17-wide vector
ops with no per-size branching:

    lookup:  y = sum(f >= cells[1:17])            (pads never count)
    update:  cells += (mixin_row - cells) >> 7    (pad targets equal pads)

The mixin tensor is indexed by [size_class, symbol] where size_class is
log2(num_syms) - 2 (4/8/16-symbol CDFs; the 4-symbol command CDF is class 0).

This is the vector-lane generalization of the reference's SSE path
(NLZM.cpp:360-376, 396-424); the layout/batching is original.
"""

import numpy as np

from ..constants import CDF_ADAPT_BITS, CDF_SCALE_TOTAL

# ---- context layout ----
CTX_CMD = 0
CTX_LIT_HI = 1
CTX_LIT_LO = 2  # + hi nibble -> 2..17
CTX_LEN_DIRECT = 18
CTX_LEN_EXT_HI = 19
CTX_LEN_EXT_LO = 20  # + hi nibble -> 20..35
CTX_DIST_HI = 36  # + length class -> 36..39
CTX_DIST_LO = 40  # + 8*length class + hi slot -> 40..71
NUM_CTX = 72
CDF_WIDTH = 17  # fences per context (padded)

_CTX_SIZES = (
    [4, 16]
    + [16] * 16
    + [8, 16]
    + [16] * 16
    + [8] * 4
    + [8] * 32
)
assert len(_CTX_SIZES) == NUM_CTX


def ctx_sizes() -> np.ndarray:
    return np.asarray(_CTX_SIZES, dtype=np.int32)


def initial_bank() -> np.ndarray:
    """[NUM_CTX, 17] uniform starting fences, padded with full scale."""
    bank = np.zeros((NUM_CTX, CDF_WIDTH), dtype=np.int32)
    for c, n in enumerate(_CTX_SIZES):
        step = CDF_SCALE_TOTAL // n
        row = [i * step for i in range(n)] + [CDF_SCALE_TOTAL] * (CDF_WIDTH - n)
        bank[c] = row
    return bank


def mixin_tensor() -> np.ndarray:
    """[3, 16, 17] adaptation targets for size classes 4/8/16.

    Row [cls, y] is the 17-wide target vector after coding symbol y: fences
    at or below y pull toward their index, live fences above y pull toward
    just past full scale, pad fences (and the total fence) stay pinned.
    """
    out = np.zeros((3, 16, CDF_WIDTH), dtype=np.int32)
    for cls, n in enumerate((4, 8, 16)):
        bias = (1 << CDF_ADAPT_BITS) - 1 - n
        for y in range(n):
            row = []
            for x in range(CDF_WIDTH):
                if x >= n:
                    row.append(CDF_SCALE_TOTAL)
                elif x <= y:
                    row.append(x)
                else:
                    row.append(CDF_SCALE_TOTAL + x + bias)
            out[cls, y] = row
    return out


def ctx_classes() -> np.ndarray:
    """[NUM_CTX] size class per context (log2(n) - 2)."""
    return np.asarray([int(n).bit_length() - 3 for n in _CTX_SIZES], dtype=np.int32)
