"""Serial host codec drivers for the NLZM-compatible single-stream format.

This is the reference-model implementation: clear, exact, and used to
validate both the native C++ runtime and the batched device kernels. The file
layout is:

    u16be hist_bits | u16be frame_bits | frame* | 4-byte zero sentinel

with the ring window sliding (position rebase by one window) whenever the
virtual write position reaches twice the window size.

Wire parity: NLZM.cpp:1711-2039. The encoder here delegates parsing to
nlzm_tpu.lz.parse (greedy or optimal); the compressed stream is decodable by
the reference binary and vice versa.
"""

from .constants import (
    CMD_DICT,
    CMD_LITERAL,
    CMD_REP,
    DEFAULT_HIST_BITS,
    FILE_HEADER_BYTES,
    MAX_FRAME_BITS,
    MAX_HIST_BITS,
    MIN_FRAME_BITS,
    MIN_HIST_BITS_DECODE,
    chunk_size_for,
    frame_bits_for,
    get_match_min,
    shrink_hist_bits,
)
from .format.frame import SENTINEL_FRAME, FrameReader, FrameWriter
from .models.lz_model import LZModel


class FormatError(ValueError):
    pass


def decode_bytes(data: bytes, engine: str = "python") -> bytes:
    """Decode a complete NLZM stream held in memory.

    engine: "python" (reference model) or "native" (C++ host runtime).
    """
    if engine == "native" and len(data) >= FILE_HEADER_BYTES:
        from . import native
        from .format.frame import SENTINEL_FRAME

        hist_bits = int.from_bytes(data[0:2], "big")
        if not (MIN_HIST_BITS_DECODE <= hist_bits <= MAX_HIST_BITS):
            raise FormatError(f"hist_bits {hist_bits} out of range")
        payload = data[FILE_HEADER_BYTES:]
        cap = max(1 << 16, len(data) * 4)
        while True:
            try:
                return native.decode_block(payload, hist_bits, cap)
            except RuntimeError:
                if cap > len(data) * 4096:
                    raise
                cap *= 8
    if len(data) < FILE_HEADER_BYTES:
        raise FormatError("truncated header")
    hist_bits = int.from_bytes(data[0:2], "big")
    frame_bits = int.from_bytes(data[2:4], "big")
    if not (MIN_HIST_BITS_DECODE <= hist_bits <= MAX_HIST_BITS):
        raise FormatError(f"hist_bits {hist_bits} out of range")
    if not (MIN_FRAME_BITS <= frame_bits <= MAX_FRAME_BITS):
        raise FormatError(f"frame_bits {frame_bits} out of range")

    window = 1 << hist_bits
    mask = window - 1
    hist = bytearray(window)
    hist_pos = 0

    model = LZModel()
    out = bytearray()

    pos = FILE_HEADER_BYTES
    while True:
        frame = FrameReader(data, pos)
        if frame.is_sentinel:
            break
        pos += frame.consumed

        if hist_pos >= 2 * window:
            hist_pos -= window

        while frame.num_ops > 0:
            cmd = model.decode_cmd(frame)
            if cmd == CMD_LITERAL:
                y = model.decode_literal(frame)
                hist[hist_pos & mask] = y
                hist_pos += 1
                out.append(y)
            elif cmd == CMD_DICT:
                lv = model.decode_lv(frame)
                dv = model.decode_dv(frame, lv) + 1
                length = lv + get_match_min(dv)
                model.rep.add(dv)
                for _ in range(length):
                    y = hist[(hist_pos - dv) & mask]
                    hist[hist_pos & mask] = y
                    hist_pos += 1
                    out.append(y)
            elif cmd == CMD_REP:
                rep_idx = frame.read_bits(2)
                lv = model.decode_lv(frame)
                dv = model.rep.table[rep_idx]
                length = lv + get_match_min(dv)
                model.rep.add(dv)
                for _ in range(length):
                    y = hist[(hist_pos - dv) & mask]
                    hist[hist_pos & mask] = y
                    hist_pos += 1
                    out.append(y)
            else:
                raise FormatError(f"reserved command {cmd}")

    return bytes(out)


def encode_bytes(
    data: bytes,
    hist_bits: int = DEFAULT_HIST_BITS,
    parser: str = "optimal",
    engine: str = "auto",
    progress=None,
) -> bytes:
    """Encode `data` into an NLZM stream (reference-decodable).

    parser: "greedy" (hash-chain matcher, fast) or "optimal"
    (forward-graph parse with the full matcher suite, best ratio).
    engine: "auto" (native if built) | "native" | "python".
    progress: optional utils.metrics.ProgressLine (live status for the
    Python engine; the native engine is a single call).
    """
    from .lz.encoder import SerialEncoder

    if parser not in ("greedy", "optimal"):
        raise ValueError(f"unknown parser {parser!r}; expected 'greedy' or 'optimal'")
    hist_bits = max(MIN_HIST_BITS_DECODE, min(MAX_HIST_BITS, hist_bits))
    hist_bits = shrink_hist_bits(hist_bits, len(data))

    use_native = engine == "native"
    if engine == "auto":
        from . import native

        use_native = native.available()
    if use_native:
        from . import native
        from .format.frame import SENTINEL_FRAME
        from .constants import frame_bits_for

        payload, _, _ = native.encode_block(data, hist_bits, parser)
        header = hist_bits.to_bytes(2, "big") + frame_bits_for(hist_bits).to_bytes(2, "big")
        return header + payload + SENTINEL_FRAME
    return SerialEncoder(hist_bits, parser=parser, progress=progress).encode(data)


# ---------------------------------------------------------------- files
# Bounded-memory file drivers: the reference encodes/decodes arbitrarily
# large files through fixed buffers with overlapped refill
# (NLZM.cpp:1870-1885, 2014-2018); these mirror that with the native
# streaming codec - RSS stays O(window), independent of file size.

_IO_CHUNK = 4 << 20


def encode_file(
    src_path,
    dst_path,
    hist_bits: int = DEFAULT_HIST_BITS,
    parser: str = "optimal",
    progress=None,
) -> dict:
    """Stream-encode a file into an NLZM stream (reference-decodable).

    Byte-identical to encode_bytes on the same input (same chunk
    schedule; the native streaming encoder is differentially tested
    against the whole-buffer path). Requires the native runtime.
    Returns {"in", "out", "crc32"}.
    """
    import os

    from . import native

    if parser not in ("greedy", "optimal"):
        raise ValueError(f"unknown parser {parser!r}")
    flen = os.stat(src_path).st_size
    hist_bits = max(MIN_HIST_BITS_DECODE, min(MAX_HIST_BITS, hist_bits))
    hist_bits = shrink_hist_bits(hist_bits, flen)

    enc = native.StreamEncoder(hist_bits, parser)
    crc = 0
    done = 0
    out_total = 0
    with open(src_path, "rb") as fin, open(dst_path, "wb") as fout:
        header = hist_bits.to_bytes(2, "big") + frame_bits_for(hist_bits).to_bytes(2, "big")
        fout.write(header)
        out_total += len(header)
        while True:
            chunk = fin.read(_IO_CHUNK)
            final = len(chunk) < _IO_CHUNK
            crc = native.crc32(chunk, crc)
            out = enc.feed(chunk, final=final)
            fout.write(out)
            out_total += len(out)
            done += len(chunk)
            if progress is not None:
                progress.update(done, out_total)
            if final:
                break
        fout.write(SENTINEL_FRAME)
        out_total += len(SENTINEL_FRAME)
    enc.close()
    return {"in": done, "out": out_total, "crc32": crc}


def decode_file(src_path, dst_path, progress=None) -> dict:
    """Stream-decode an NLZM stream file; dst_path=None = test mode
    (decode + CRC only, like the reference's `t`). Returns
    {"in", "out", "crc32"}."""
    import os

    from . import native

    flen = os.stat(src_path).st_size
    with open(src_path, "rb") as fin:
        header = fin.read(FILE_HEADER_BYTES)
        if len(header) < FILE_HEADER_BYTES:
            raise FormatError("truncated header")
        hist_bits = int.from_bytes(header[0:2], "big")
        frame_bits = int.from_bytes(header[2:4], "big")
        if not (MIN_HIST_BITS_DECODE <= hist_bits <= MAX_HIST_BITS):
            raise FormatError(f"hist_bits {hist_bits} out of range")
        if not (MIN_FRAME_BITS <= frame_bits <= MAX_FRAME_BITS):
            raise FormatError(f"frame_bits {frame_bits} out of range")
        dec = native.StreamDecoder(hist_bits)
        crc = 0
        done = len(header)
        out_total = 0
        fout = open(dst_path, "wb") if dst_path else None
        try:
            while not dec.done:
                chunk = fin.read(_IO_CHUNK)
                if not chunk:
                    raise FormatError("truncated stream (no sentinel)")
                done += len(chunk)
                # the native decoder pauses with ~8 MB pending so peak
                # memory stays O(window); pump with empty feeds until dry
                while True:
                    out = dec.feed(chunk)
                    chunk = b""
                    crc = native.crc32(out, crc)
                    if fout:
                        fout.write(out)
                    out_total += len(out)
                    if progress is not None:
                        progress.update(min(done, flen), out_total)
                    if dec.done or not out:
                        break
        finally:
            if fout:
                fout.close()
        dec.close()
    return {"in": done, "out": out_total, "crc32": crc}
