"""32-bit interleaved rANS core (host/serial form).

State invariant: x in [2^16, freq * 2^18) after each encode step; the decoder
needs no division. Renormalization moves 16 bits at a time; the byte pair is
stored high-byte-first. Four lanes are interleaved round-robin per frame so a
decoder can keep four states in flight (and the batched device decoder keeps
4 * num_blocks states in flight; see nlzm_tpu.ops.rans_ops).

Wire parity: NLZM.cpp:440-488, 599-608.
"""

from ..constants import CDF_SCALE_BITS, CDF_SCALE_MASK, RANS_LANES, RANS_MID

__all__ = [
    "RANS_MID",
    "rans_advance",
    "rans_stream_encode",
    "rans_states_from_bytes",
]


def rans_advance(x: int, start: int, freq: int, stream: bytes, pos: int):
    """Decode-side: consume symbol (start, freq) then renormalize.

    Returns (new_state, new_pos). `stream` holds the renorm byte pairs.
    """
    x = freq * (x >> CDF_SCALE_BITS) + (x & CDF_SCALE_MASK) - start
    if x < RANS_MID:
        x = (x << 16) | (stream[pos] << 8) | stream[pos + 1]
        pos += 2
    return x, pos


def rans_stream_encode(spans: list[tuple[int, int]]) -> bytes:
    """Encode a forward list of (start, freq) spans into the frame's rANS section.

    The encoder walks the span list backward through RANS_LANES interleaved
    states (symbol i belongs to lane i % RANS_LANES), emitting renormalization
    byte pairs into a shared tail-growing stream, then prepends the four final
    states little-endian (lane 0 first in the byte stream).
    """
    states = [RANS_MID] * RANS_LANES
    out_rev: list[int] = []  # bytes in reverse stream order

    for i in range(len(spans) - 1, -1, -1):
        start, freq = spans[i]
        x = states[i & (RANS_LANES - 1)]
        if x >= (freq << 18):  # freq * ((RANS_MID >> SCALE_BITS) << 16)
            out_rev.append(x & 0xFF)
            out_rev.append((x >> 8) & 0xFF)
            x >>= 16
        states[i & (RANS_LANES - 1)] = (
            ((x // freq) << CDF_SCALE_BITS) + (x % freq) + start
        )

    for lane in range(RANS_LANES - 1, -1, -1):
        x = states[lane]
        out_rev.extend(((x >> 24) & 0xFF, (x >> 16) & 0xFF, (x >> 8) & 0xFF, x & 0xFF))

    out_rev.reverse()
    return bytes(out_rev)


def rans_states_from_bytes(data: bytes, pos: int):
    """Decode-side: read RANS_LANES little-endian 32-bit seed states."""
    states = []
    for _ in range(RANS_LANES):
        states.append(
            data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16) | (data[pos + 3] << 24)
        )
        pos += 4
    return states, pos
