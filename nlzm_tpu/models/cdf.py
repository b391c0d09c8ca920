"""Adaptive nibble-CDF primitives (host/serial form).

A CDF over N symbols (N in {2, 4, 8, 16}) is stored as N+1 cumulative
16-bit fences in [0, 16384]; fence 0 is pinned to 0 and fence N to 16384.
Adaptation nudges every interior fence 1/128th of the way toward a
per-symbol target row ("mixin"), which is branch-free and maps directly
onto int16 vector lanes in the batched device kernels (nlzm_tpu.ops.cdf_ops).

Wire-format parity: NLZM.cpp:212-438 (constants, mixin construction,
update/lookup/cost semantics). The batched device layout is original.
"""

from functools import lru_cache

from ..constants import CDF_ADAPT_BITS, CDF_ADAPT_TOTAL, CDF_SCALE_BITS, CDF_SCALE_TOTAL
from ..utils.log2lut import LOG2_LUT

# CDF1 (2 symbols) keeps a single adaptive fence with dedicated targets.
MIXIN1 = (CDF_SCALE_TOTAL - CDF_ADAPT_TOTAL - 1, CDF_ADAPT_TOTAL + 1)


@lru_cache(maxsize=None)
def mixin_table(num_syms: int) -> tuple[tuple[int, ...], ...]:
    """Adaptation target rows: row y is the target fence vector after symbol y.

    Fences at or below y pull toward their index (shrinking everything below),
    fences above y pull toward just past full scale, widening symbol y's
    interval. The +bias keeps every interval nonempty forever.
    """
    bias = (1 << CDF_ADAPT_BITS) - 1 - num_syms
    rows = []
    for y in range(num_syms):
        row = [x if x <= y else CDF_SCALE_TOTAL + x + bias for x in range(num_syms)]
        rows.append(tuple(row))
    return tuple(rows)


def cdf_initial(num_syms: int) -> list[int]:
    """Uniform starting fences (num_syms + 1 cells)."""
    step = CDF_SCALE_TOTAL // num_syms
    return [i * step for i in range(num_syms)] + [CDF_SCALE_TOTAL]


def new_cdf(num_syms: int) -> list[int]:
    return cdf_initial(num_syms)


def cdf_update(cells: list[int], y: int) -> None:
    """Adapt fences after coding symbol y (in place).

    Uses arithmetic shift semantics: (target - cell) >> 7 rounds toward
    negative infinity, exactly as C int arithmetic does.
    """
    n = len(cells) - 1
    if n == 2:
        cells[1] += (MIXIN1[y] - cells[1]) >> CDF_ADAPT_BITS
        return
    row = mixin_table(n)[y]
    for i in range(1, n):  # fence 0 is always 0; its target is also 0
        cells[i] += (row[i] - cells[i]) >> CDF_ADAPT_BITS
    # fence[0] target is row[0] == 0 for every y, so it never moves; skip it.


def cdf_lookup(cells: list[int], f: int) -> int:
    """Symbol whose interval contains scaled frequency f: cells[y] <= f < cells[y+1]."""
    n = len(cells) - 1
    if n == 2:
        return 1 if f >= cells[1] else 0
    # fence bisection, identical result to a linear scan on monotone fences
    r = 0
    half = n >> 1
    while half:
        if f >= cells[r + half]:
            r += half
        half >>= 1
    return r


def cdf_cost(cells: list[int], y: int) -> int:
    """Approximate code length of symbol y in 1/32-bit units."""
    return LOG2_LUT[(cells[y + 1] - cells[y]) >> (CDF_SCALE_BITS - 8)]


def cdf_span(cells: list[int], y: int) -> tuple[int, int]:
    """(start, freq) pair handed to the rANS coder for symbol y."""
    return cells[y], cells[y + 1] - cells[y]
