"""Serial host encoder: chunk loop + parser + model emission.

Two parsers share the same chunk/frame plumbing and model:

- "optimal": forward-graph parse over the full matcher suite
  (choice-parity with the reference: archives are byte-identical).
- "greedy": single-probe hash-4 chain, much faster, bigger output; used for
  quick stream generation and as the shape-model for the device encoder.

Driver parity: NLZM.cpp:1711-1910.
"""

from ..constants import (
    CMD_DICT,
    CMD_LITERAL,
    CMD_REP,
    HASH4_MULT,
    MATCH_MAX,
    MATCH_MIN,
    U32_MASK,
    chunk_feed_for,
    chunk_size_for,
    frame_bits_for,
    get_match_min,
)
from ..format.frame import SENTINEL_FRAME, FrameWriter
from ..models.lz_model import LZModel
from .dictionary import RingDict
from .matchers import BinaryTreeMatcher, HashTableMatcher, MatchTable, RabinKarpMatcher
from .parse import parse_chunk


def _clamp(v, lo, hi):
    return max(lo, min(hi, v))


class SerialEncoder:
    def __init__(self, hist_bits: int, parser: str = "optimal", progress=None) -> None:
        # progress: optional utils.metrics.ProgressLine (reference-style
        # live status, NLZM.cpp:1857-1868)
        self.progress = progress
        self.hist_bits = hist_bits
        self.parser = parser
        self.total_reads = 0  # coded items across all frames
        self.total_cmds = 0  # LZ commands emitted

    def encode(self, data: bytes) -> bytes:
        out = bytearray()
        out += self.hist_bits.to_bytes(2, "big")
        out += frame_bits_for(self.hist_bits).to_bytes(2, "big")
        out += self.encode_frames(data)
        out += SENTINEL_FRAME
        return bytes(out)

    def encode_frames(self, data: bytes) -> bytes:
        """Frames only - no file header, no sentinel (block-container payload)."""
        out = bytearray()
        frame_bits = frame_bits_for(self.hist_bits)
        if self.parser == "greedy":
            self._encode_greedy(data, out, self.hist_bits, frame_bits)
        else:
            self._encode_optimal(data, out, self.hist_bits, frame_bits)
        return bytes(out)

    # ---- optimal (reference-parity) path ----

    def _encode_optimal(self, data: bytes, out: bytearray, hist_bits: int, frame_bits: int):
        window = 1 << hist_bits
        chunk_size = chunk_size_for(frame_bits)
        chunk_feed = chunk_feed_for(frame_bits)

        d = RingDict(hist_bits)
        model = LZModel()
        frame = FrameWriter()
        mt_carry = MatchTable()

        # matcher sizing per NLZM.cpp:1750-1753
        ht2 = HashTableMatcher(12, 1, hist_bits)
        ht3 = HashTableMatcher(12 + _clamp(hist_bits, 15, 17) - 15, 2, hist_bits)
        bt4 = BinaryTreeMatcher(13 + _clamp(hist_bits, 16, 20) - 16, hist_bits)
        rk = RabinKarpMatcher(15 + _clamp(hist_bits, 16, 22) - 16, hist_bits)

        view = memoryview(data)
        chunk_start = 0
        n = len(data)

        while chunk_start < n:
            chunk_read = min(chunk_feed, n - chunk_start)
            p_end = min(chunk_size, chunk_read)

            if d.hist_pos >= 2 * window:
                d.shift(window)
                ht2.shift(window)
                ht3.shift(window)
                bt4.shift(window)
                rk.shift(window)

            chunk = view[chunk_start : chunk_start + chunk_read]
            p = 0
            parse_end = 0
            ops = []
            op_i = 0
            while p < p_end:
                if p == parse_end:
                    d.set_lookahead(chunk[p:], chunk_read - p)
                    ops, parse_len = parse_chunk(
                        model, d, ht2, ht3, bt4, rk, mt_carry, p_end - p
                    )
                    parse_end = p + parse_len
                    op_i = 0

                c, length, dlt = ops[op_i]
                op_i += 1
                self.total_cmds += 1
                if c == CMD_LITERAL:
                    y = chunk[p]
                    d.push(y)
                    model.encode_literal(frame, y)
                    p += 1
                elif c == CMD_DICT:
                    model.encode_match(frame, dlt, length)
                    model.rep.add(dlt)
                    for i in range(length):
                        d.push(chunk[p + i])
                    p += length
                else:  # CMD_REP
                    model.encode_rep(frame, dlt, length)
                    model.rep.add(model.rep.table[dlt])
                    for i in range(length):
                        d.push(chunk[p + i])
                    p += length

            self.total_reads += frame.num_ops
            out += frame.flush()
            chunk_start += p_end
            if self.progress is not None:
                self.progress.update(chunk_start, len(out))

    # ---- greedy path (fast stream generation) ----

    def _encode_greedy(self, data: bytes, out: bytearray, hist_bits: int, frame_bits: int):
        window_reach = (1 << hist_bits) - 1
        chunk_size = chunk_size_for(frame_bits)

        model = LZModel()
        frame = FrameWriter()
        heads: dict[int, int] = {}
        n = len(data)

        pos = 0
        chunk_end = min(chunk_size, n)
        while pos < n:
            best_len = 0
            best_delta = 0
            best_rep = -1
            limit = min(MATCH_MAX, chunk_end - pos)

            if limit >= MATCH_MIN and pos + 4 <= n:
                h = (
                    (data[pos] | (data[pos + 1] << 8) | (data[pos + 2] << 16) | (data[pos + 3] << 24))
                    * HASH4_MULT
                    & U32_MASK
                ) >> 15
                cand = heads.get(h, -1)
                heads[h] = pos
                if cand >= 0:
                    delta = pos - cand
                    if 0 < delta <= window_reach:
                        mlen = 0
                        while mlen < limit and data[cand + mlen] == data[pos + mlen]:
                            mlen += 1
                        if mlen >= get_match_min(delta):
                            best_len, best_delta = mlen, delta

                # rep0 probe often beats a fresh match
                rep0 = model.rep.table[0]
                if rep0 <= pos and rep0 <= window_reach:
                    mlen = 0
                    src = pos - rep0
                    while mlen < limit and data[src + mlen] == data[pos + mlen]:
                        mlen += 1
                    if mlen >= get_match_min(rep0) and mlen + 1 >= best_len:
                        best_len, best_delta, best_rep = mlen, rep0, 0

            self.total_cmds += 1
            if best_len >= MATCH_MIN:
                if best_rep >= 0:
                    model.encode_rep(frame, best_rep, best_len)
                else:
                    model.encode_match(frame, best_delta, best_len)
                model.rep.add(best_delta)
                pos += best_len
            else:
                model.encode_literal(frame, data[pos])
                pos += 1

            if pos >= chunk_end:
                self.total_reads += frame.num_ops
                out += frame.flush()
                chunk_end = min(chunk_end + chunk_size, n)
