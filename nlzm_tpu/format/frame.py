"""Chunked frame container: 12-byte header + direct-bit section + rANS section.

Frame layout (all header fields big-endian u32; NLZM.cpp:534-663):

    [num_ops][num_bits_bytes][num_rans_bytes]
    [MSB-first direct bits ... + 4 flush bytes]
    [rANS stream: 4 seed states LE then interleaved renorm pairs]

num_ops counts every coded item (each CDF symbol and each direct-bit write);
num_bits_bytes spans the header plus the bit section. A frame whose num_ops
is 0 is the end-of-stream sentinel (only its first 4 bytes exist).

This module is the host/serial implementation; the batched device decoder
consumes the same sections via nlzm_tpu.ops.decode_v2.
"""

from ..constants import CDF_SCALE_MASK, FRAME_HEADER_BYTES, RANS_MID
from ..models.cdf import cdf_lookup
from ..utils.log2lut import LOG2_LUT
from .rans import rans_states_from_bytes, rans_stream_encode


class FrameWriter:
    """Accumulates coded items for one frame, then serializes it.

    Unlike the reference (which stages into the caller's output buffer), this
    writer owns growable buffers and produces the frame bytes at flush();
    the wire bytes are identical.
    """

    __slots__ = ("spans", "bit_bytes", "_word", "_word_bits", "num_ops", "est_rans_bits")

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        self.spans: list[tuple[int, int]] = []
        self.bit_bytes = bytearray()
        self._word = 0
        self._word_bits = 0
        self.num_ops = 0
        self.est_rans_bits = 0

    def put_span(self, start: int, freq: int) -> None:
        """Queue one rANS symbol given its (start, freq) span."""
        assert freq > 0
        self.num_ops += 1
        self.spans.append((start, freq))
        self.est_rans_bits += LOG2_LUT[freq >> 6]

    def put_cdf(self, cells: list[int], y: int) -> None:
        self.put_span(cells[y], cells[y + 1] - cells[y])

    def put_bits(self, v: int, nb: int) -> None:
        """Queue nb direct bits, MSB first."""
        assert 0 <= v < (1 << nb)
        self.num_ops += 1
        self._word |= v << (32 - self._word_bits - nb)
        self._word_bits += nb
        while self._word_bits >= 8:
            self.bit_bytes.append((self._word >> 24) & 0xFF)
            self._word = (self._word << 8) & 0xFFFFFFFF
            self._word_bits -= 8

    def estimated_bytes(self) -> int:
        """Upper-ish estimate of the serialized frame size (sizing heuristic)."""
        return (
            FRAME_HEADER_BYTES
            + len(self.bit_bytes)
            + (self.est_rans_bits >> (8 + 5))
            + 64
        )

    def flush(self) -> bytes:
        """Serialize the frame and reset for the next one."""
        bits = bytearray(self.bit_bytes)
        word = self._word
        for _ in range(4):  # drain staging word; always 4 pad bytes
            bits.append((word >> 24) & 0xFF)
            word = (word << 8) & 0xFFFFFFFF

        rans = rans_stream_encode(self.spans)

        num_bits_bytes = FRAME_HEADER_BYTES + len(bits)
        header = bytearray(12)
        header[0:4] = self.num_ops.to_bytes(4, "big")
        header[4:8] = num_bits_bytes.to_bytes(4, "big")
        header[8:12] = len(rans).to_bytes(4, "big")

        out = bytes(header) + bytes(bits) + rans
        self.reset()
        return out


SENTINEL_FRAME = b"\x00\x00\x00\x00"


class FrameReader:
    """Streaming reader over one frame's two sections."""

    __slots__ = (
        "data",
        "num_ops",
        "consumed",
        "_bit_pos",
        "_bit_end",
        "_word",
        "_word_bits",
        "_rans_pos",
        "_states",
        "_lane",
    )

    def __init__(self, data: bytes, base: int = 0) -> None:
        """Parse the frame starting at data[base]. num_ops == 0 => sentinel."""
        self.data = data
        self.num_ops = int.from_bytes(data[base : base + 4], "big")
        if self.num_ops == 0:
            self.consumed = 4
            return
        num_bits_bytes = int.from_bytes(data[base + 4 : base + 8], "big")
        num_rans_bytes = int.from_bytes(data[base + 8 : base + 12], "big")
        self.consumed = num_bits_bytes + num_rans_bytes

        self._bit_pos = base + FRAME_HEADER_BYTES
        self._bit_end = base + num_bits_bytes
        self._word = 0
        self._word_bits = 0

        self._states, self._rans_pos = rans_states_from_bytes(data, base + num_bits_bytes)
        self._lane = 0

    @property
    def is_sentinel(self) -> bool:
        return self.num_ops == 0

    def read_cdf(self, cells: list[int]) -> int:
        """Decode one symbol against `cells` from the next rANS lane."""
        self.num_ops -= 1
        lane = self._lane & 3
        self._lane += 1

        x = self._states[lane]
        y = cdf_lookup(cells, x & CDF_SCALE_MASK)
        freq = cells[y + 1] - cells[y]
        x = freq * (x >> 14) + (x & CDF_SCALE_MASK) - cells[y]
        if x < RANS_MID:
            d = self.data
            p = self._rans_pos
            x = (x << 16) | (d[p] << 8) | d[p + 1]
            self._rans_pos = p + 2
        self._states[lane] = x
        return y

    def read_bits(self, nb: int) -> int:
        """Read nb direct bits (MSB-first, 24-bit refill)."""
        self.num_ops -= 1
        word = self._word
        word_bits = self._word_bits
        while word_bits < 24:
            word |= self.data[self._bit_pos] << (24 - word_bits)
            self._bit_pos += 1
            word_bits += 8
        y = word >> (32 - nb)
        self._word = (word << nb) & 0xFFFFFFFF
        self._word_bits = word_bits - nb
        return y
