"""CRC32 (poly 0xEDB88320) integrity checks.

The host path delegates to zlib (identical polynomial/init/final-xor to the
reference's slicing-by-16 implementation, NLZM.cpp:126-210). crc32_tables()
exposes the 16x256 slicing tables for the vectorized device kernel in
nlzm_tpu.ops.crc32_ops.
"""

import zlib
from functools import lru_cache

import numpy as np

_POLY = 0xEDB88320


def crc32(data, prev: int = 0) -> int:
    """CRC32 of bytes-like `data`, chained from `prev`."""
    return zlib.crc32(bytes(data), prev) & 0xFFFFFFFF


@lru_cache(maxsize=1)
def crc32_tables() -> np.ndarray:
    """Slicing tables: shape (16, 256) uint32; tables[0] is the classic table."""
    t0 = np.zeros(256, dtype=np.uint64)
    for n in range(256):
        c = n
        for _ in range(8):
            c = (c >> 1) ^ _POLY if (c & 1) else (c >> 1)
        t0[n] = c

    tables = np.zeros((16, 256), dtype=np.uint64)
    tables[0] = t0
    for k in range(1, 16):
        prev = tables[k - 1]
        tables[k] = t0[(prev & 0xFF).astype(np.int64)] ^ (prev >> np.uint64(8))
    return tables.astype(np.uint32)
