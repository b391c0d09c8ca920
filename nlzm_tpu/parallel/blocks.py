"""NLZP block container: data-parallel profile of the NLZM format.

The single-stream NLZM format decodes strictly serially (adaptive model +
rANS state + LZ history all chain per symbol), so the device/multi-chip scaling
unit is the *block*: the input is split into fixed-size blocks, each encoded
as an independent NLZM frame stream with a fresh model and window. Blocks
decode in lockstep on the device (nlzm_tpu.ops.decode_v2) and shard
data-parallel across a device mesh (nlzm_tpu.parallel.mesh).

Container layout (all integers big-endian):

    0   magic  b"NLZP"
    4   u8     version (1)
    5   u8     hist_bits     (per-block window)
    6   u8     frame_bits
    7   u8     flags         (bit 0: u32 CRC32 of the plain data follows)
    8   u32    block_size    (uncompressed bytes per block; last may be short)
    12  u64    total uncompressed length
    20  u32    num_blocks
    [u32 crc32 when flagged]
    per block: u32 comp_size | u32 total_reads | u32 num_cmds
               (wide profile: the reads slot carries the block's max
                literal-ancestor chain depth - the decoder's exact
                pointer-doubling round budget)
    ... concatenated block payloads (frames only - no per-block file header,
        no sentinel; zero padding after each payload terminates it)

The per-block model restart costs ~1-3% ratio versus single-stream NLZM;
that is the price of parallel decode (SURVEY.md §7).
"""

import io
import struct
from dataclasses import dataclass

import numpy as np

from ..constants import frame_bits_for
from ..lz.encoder import SerialEncoder

MAGIC = b"NLZP"
VERSION = 4  # v4: single-read, context-free wide planes (format/wide.py)
_HDR = struct.Struct(">4sBBBBIQI")
_BLK = struct.Struct(">III")
FLAG_CRC32 = 0x01  # u32be CRC of the uncompressed data follows the header
FLAG_WIDE = 0x02  # blocks use the wide profile (format/wide.py)
FLAG_PRIORS = 0x04  # container-level wide warm-start priors blob follows
FLAG_DICT = 0x08  # shared dictionary follows (u32 raw len, u32 comp len, v1 frames)

DEFAULT_BLOCK_SIZE = 1 << 17  # 128 KB: 5 frames/block at hist_bits 17
WIDE_MAX_BLOCK = 131072  # 2-op sort path above 32 KiB; i32 position budget
DEFAULT_DICT_SIZE = 32768  # keeps 32 KiB blocks on the packed-sort path (D+N <= 64K)

ENGINES = ("auto", "serial", "native", "device")
DECODE_ENGINES = ("serial", "native", "device")


def check_engine(engine: str, allowed=ENGINES) -> None:
    """Refuse an engine name outside `allowed` instead of guessing one."""
    if engine not in allowed:
        raise ValueError(
            f"unknown engine {engine!r}; expected one of {', '.join(allowed)}"
        )


def sample_dict(data: bytes, dict_size: int, segment: int = 2048) -> bytes:
    """Deterministic shared-dictionary sampling: evenly spaced segments.

    The container dictionary is the parallel profiles' long-range reach
    (the role RK256 + big windows play in the single-stream reference,
    NLZM.cpp:788-811, 1033-1123): every block's window starts preloaded
    with it, so cross-block redundancy - vocabulary, boilerplate, headers
    - is reachable without coupling blocks to each other. Evenly spaced
    segments cover the whole input's vocabulary; segments keep their
    original order so runs spanning segment joins stay meaningful.
    """
    if dict_size <= 0 or len(data) <= dict_size:
        return b""
    nseg = max(1, dict_size // segment)
    stride = len(data) / nseg
    parts = []
    for i in range(nseg):
        off = int(i * stride)
        parts.append(data[off : off + segment])
    return b"".join(parts)[:dict_size]


def _compress_dict(dictionary: bytes) -> bytes:
    from .. import native

    hb = hist_bits_for_block(len(dictionary))
    if native.available():
        payload, _, _ = native.encode_block(dictionary, hb, "optimal")
    else:
        enc = SerialEncoder(hb, parser="greedy")
        payload = enc.encode_frames(dictionary)
    return payload


def _decompress_dict(payload: bytes, raw_len: int) -> bytes:
    from .. import native

    hb = hist_bits_for_block(raw_len)
    if native.available():
        return native.decode_block(payload, hb, raw_len)
    from ..codec import decode_bytes
    from ..format.frame import SENTINEL_FRAME

    header = hb.to_bytes(2, "big") + frame_bits_for(hb).to_bytes(2, "big")
    return decode_bytes(header + payload + SENTINEL_FRAME)


@dataclass
class ContainerInfo:
    hist_bits: int
    frame_bits: int
    block_size: int
    total_len: int
    comp_sizes: list
    total_reads: list
    num_cmds: list
    payload_off: int
    crc32: int | None = None
    wide: bool = False
    wide_priors: bytes | None = None
    dictionary: bytes | None = None


def hist_bits_for_block(block_size: int) -> int:
    """Window covering the whole block (blocks never slide)."""
    return max(12, (max(block_size, 2) - 1).bit_length())


def encode_container(
    data: bytes,
    block_size: int = DEFAULT_BLOCK_SIZE,
    parser: str = "greedy",
    engine: str = "auto",
    profile: str = "v1",
    depth_cap: int = 8,
    dict_size: int = 0,
    progress=None,
) -> bytes:
    """Block encode. engine: auto (native if built) | native | serial | device.

    depth_cap > 0 HARD-bounds every byte's literal-ancestor chain depth
    in wide blocks (lift + split at parse time), fixing the device
    expander's pointer-doubling budget at ceil(log2(depth_cap)) rounds.
    The default 8 (3 doubling rounds) costs ~0.1% size on the perf mix
    and ~1% on non-periodic text vs cap 16, and saves a full doubling
    round per decode; cap 4 costs several % because splitting breaks rep
    chains. 0 = soft lift only (no split, depth bounded only in
    practice, ~25).

    profile="wide" encodes blocks in the lane-parallel wide profile
    (format/wide.py): device parse + host plane packing; decodes with the
    batched wide device decoder.

    dict_size > 0 samples a shared dictionary (sample_dict) stored once
    in the container; every wide block's window starts preloaded with it,
    giving the parallel profile long-range reach without coupling blocks.
    Keep dict_size + block_size <= 65536 to stay on the decoder's
    packed-sort path. Requires the native engine and parser="optimal".
    """
    check_engine(engine)
    dictionary = b""
    if dict_size and profile == "wide":
        dictionary = sample_dict(data, dict_size)
    hist_bits = hist_bits_for_block(len(dictionary) + block_size)
    num_blocks = (len(data) + block_size - 1) // block_size if data else 0

    use_native = engine == "native"
    if engine == "auto":
        from .. import native

        use_native = native.available()

    flags = FLAG_CRC32
    if profile == "wide":
        if block_size > WIDE_MAX_BLOCK:
            raise ValueError("wide profile caps blocks at 128 KiB")
        flags |= FLAG_WIDE
        from .. import native
        from ..format.wide import encode_wide_blocks

        if dictionary and not (
            engine != "device" and native.available() and parser == "optimal"
        ):
            raise ValueError(
                "shared dictionaries need the native optimal-parse pipeline "
                "(engine != 'device', parser='optimal', native library built)"
            )
        if num_blocks:
            if engine != "device" and native.available() and parser == "optimal":
                # full native block-major pipeline: forward-graph parse
                # (full matcher suite, adaptive costs), depth lift,
                # rep classification, threaded plane encode
                payloads, priors_blob, depths, ncmds = native.wide_encode_pipeline(
                    data, block_size, hist_bits, depth_cap=depth_cap,
                    progress=progress, dictionary=dictionary or None,
                )
            else:
                from ..ops.encode_ops import parse_blocks_device

                op_len, op_val, op_rep, depths = parse_blocks_device(
                    data, block_size, hist_bits, parser
                )
                if engine == "device":
                    # fully device-resident encode: device parse feeds the
                    # device plane encoder (byte-identical to the host's)
                    from ..ops.wide_encode_dev import encode_wide_blocks_device

                    payloads, priors_blob = encode_wide_blocks_device(
                        op_len, op_val, op_rep
                    )
                else:
                    payloads, priors_blob = encode_wide_blocks(op_len, op_val, op_rep)
                ncmds = [
                    int(np.argmax(op_len[:, b] < 0))
                    if (op_len[:, b] < 0).any()
                    else op_len.shape[0]
                    for b in range(num_blocks)
                ]
            if priors_blob:
                flags |= FLAG_PRIORS
            if dictionary:
                flags |= FLAG_DICT
            # the per-block "reads" slot carries the chain depth: the
            # decoder's exact pointer-doubling round budget
            meta = [
                (len(p), int(d), c)
                for p, d, c in zip(payloads, depths, ncmds)
            ]
        else:
            payloads, meta, priors_blob = [], [], b""
            dictionary = b""
            flags &= ~FLAG_DICT
    elif engine == "device" and num_blocks:
        from ..ops.encode_ops import encode_blocks_device

        payloads, reads, cmds = encode_blocks_device(data, block_size, hist_bits, parser=parser)
        meta = list(zip(map(len, payloads), reads, cmds))
    elif use_native and num_blocks:
        from .. import native

        payloads, reads, cmds = native.encode_blocks(data, block_size, hist_bits, parser)
        meta = list(zip(map(len, payloads), reads, cmds))
    else:
        payloads = []
        meta = []
        done = 0
        for b in range(num_blocks):
            chunk = data[b * block_size : (b + 1) * block_size]
            enc = SerialEncoder(hist_bits, parser=parser)
            payload = enc.encode_frames(chunk)
            payloads.append(payload)
            meta.append((len(payload), enc.total_reads, enc.total_cmds))
            done += len(chunk)
            if progress is not None:
                progress.update(done, sum(m[0] for m in meta))

    from ..utils.crc32 import crc32

    out = io.BytesIO()
    out.write(
        _HDR.pack(
            MAGIC,
            VERSION,
            hist_bits,
            frame_bits_for(hist_bits),
            flags,
            block_size,
            len(data),
            num_blocks,
        )
    )
    out.write(struct.pack(">I", crc32(data)))
    if flags & FLAG_PRIORS:
        out.write(priors_blob)
    if flags & FLAG_DICT:
        dcomp = _compress_dict(dictionary)
        out.write(struct.pack(">II", len(dictionary), len(dcomp)))
        out.write(dcomp)
    for m in meta:
        out.write(_BLK.pack(*m))
    for p in payloads:
        out.write(p)
    return out.getvalue()


def parse_container(data: bytes) -> ContainerInfo:
    magic, version, hist_bits, frame_bits, flags, block_size, total_len, num_blocks = _HDR.unpack_from(
        data, 0
    )
    if magic != MAGIC:
        raise ValueError("not an NLZP container")
    if version != VERSION:
        raise ValueError(f"unsupported NLZP version {version}")
    off = _HDR.size
    crc = None
    if flags & FLAG_CRC32:
        (crc,) = struct.unpack_from(">I", data, off)
        off += 4
    priors = None
    if flags & FLAG_PRIORS:
        from ..format.wide import priors_blob_size

        n = priors_blob_size()
        priors = data[off : off + n]
        off += n
    dictionary = None
    if flags & FLAG_DICT:
        raw_len, comp_len = struct.unpack_from(">II", data, off)
        off += 8
        dictionary = _decompress_dict(data[off : off + comp_len], raw_len)
        if len(dictionary) != raw_len:
            raise IntegrityError("corrupt container dictionary")
        off += comp_len
    comp_sizes, reads, cmds = [], [], []
    for _ in range(num_blocks):
        cs, rd, nc = _BLK.unpack_from(data, off)
        comp_sizes.append(cs)
        reads.append(rd)
        cmds.append(nc)
        off += _BLK.size
    return ContainerInfo(
        hist_bits=hist_bits,
        frame_bits=frame_bits,
        block_size=block_size,
        total_len=total_len,
        comp_sizes=comp_sizes,
        total_reads=reads,
        num_cmds=cmds,
        payload_off=off,
        crc32=crc,
        wide=bool(flags & FLAG_WIDE),
        wide_priors=priors,
        dictionary=dictionary,
    )


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def stage_v1_buckets(data: bytes, info: ContainerInfo, n_buckets: int = 0):
    """Bucket v1 blocks by command count before the FSM scan (adaptive).

    The scan's step count is static per batch, sized by the WORST block,
    so one command-dense block makes every block pay its padding. But a
    step also has a fixed cost that does not shrink with the batch width,
    and each sequential bucket pays it again for its own step count, so
    bucketing only pays when B is large enough that the fixed share is
    small; n_buckets=0 picks 1 bucket below 1024 blocks and 2 above.
    Returns [(streams [Bk, Sk] jnp.uint8, num_steps, block_idx_list), ...].
    """
    import jax.numpy as jnp

    B = len(info.comp_sizes)
    if n_buckets <= 0:
        n_buckets = 2 if B >= 1024 else 1
    if B <= n_buckets * 8:
        n_buckets = 1
    offs = np.zeros(B + 1, np.int64)
    np.cumsum(info.comp_sizes, out=offs[1:])
    offs += info.payload_off
    order = sorted(range(B), key=lambda b: info.num_cmds[b])
    out = []
    for k in range(n_buckets):
        idx = order[k * B // n_buckets : (k + 1) * B // n_buckets]
        if not idx:
            continue
        s = _round_up(max(info.comp_sizes[b] for b in idx) + 24, 256)
        arr = np.zeros((len(idx), s), np.uint8)
        for row, b in enumerate(idx):
            cs = info.comp_sizes[b]
            arr[row, :cs] = np.frombuffer(data, np.uint8, cs, offs[b])
        num_steps = _round_up(max(info.num_cmds[b] for b in idx) + 1, 256)
        out.append((jnp.asarray(arr), num_steps, idx))
    return out


def decode_v1_staged(streams, num_steps: int, block_size: int):
    """FSM decode + LZ expansion of one staged v1 bucket -> [Bk, N] u8."""
    from ..ops.decode_v2 import fsm_decode_v2
    from ..ops.expand_ops import lz_expand_parallel

    op_len, op_val = fsm_decode_v2(streams, num_steps)
    out, produced = lz_expand_parallel(op_len, op_val, block_size)
    return out, produced


def pack_streams(data: bytes, info: ContainerInfo) -> np.ndarray:
    """[B, S] uint8: per-block payloads, zero padded (terminator + window slack)."""
    n = len(info.comp_sizes)
    s = _round_up(max(info.comp_sizes, default=1) + 24, 256)
    arr = np.zeros((n, s), dtype=np.uint8)
    off = info.payload_off
    for b, cs in enumerate(info.comp_sizes):
        arr[b, :cs] = np.frombuffer(data, dtype=np.uint8, count=cs, offset=off)
        off += cs
    return arr


def block_payloads(data: bytes, info: ContainerInfo) -> list:
    """Per-block payload byte strings of a parsed container."""
    out = []
    off = info.payload_off
    for cs in info.comp_sizes:
        out.append(data[off : off + cs])
        off += cs
    return out


class IntegrityError(ValueError):
    pass


def _verified(out: bytes, info: ContainerInfo) -> bytes:
    if info.crc32 is not None:
        from ..utils.crc32 import crc32

        got = crc32(out)
        if got != info.crc32:
            raise IntegrityError(
                f"CRC mismatch: stored {info.crc32:08X}, decoded {got:08X}"
            )
    return out


def decode_container(data: bytes, engine: str = "device") -> bytes:
    """Decode an NLZP container (CRC-verified when the container carries one).

    engine="device": batched FSM decode + LZ expansion (jit; runs on whatever
    jax backend is active). engine="native": threaded C++ host runtime.
    engine="serial": per-block Python reference path.
    """
    check_engine(engine, DECODE_ENGINES)
    info = parse_container(data)
    if not info.comp_sizes:
        return _verified(b"", info)

    if info.wide:
        dictionary = info.dictionary or b""
        if engine in ("serial", "native"):
            # host path: reference plane decoder + (native when built)
            # command expansion; the device path below is the fast one
            from .. import native
            from ..format.wide import decode_wide_block

            out = bytearray()
            dlen = len(dictionary)
            for payload in block_payloads(data, info):
                op_len, op_val = decode_wide_block(payload, info.wide_priors)
                ol = np.asarray(op_len, np.int32)
                ov = np.asarray(op_val, np.int32)
                if engine == "native" and native.available():
                    out += native.expand_ops(
                        ol, ov, info.block_size, dictionary or None
                    )
                else:
                    blk = bytearray()
                    for l, v in zip(ol, ov):
                        if l == 0:
                            blk.append(v)
                        else:
                            if not 0 < v <= len(blk) + dlen:
                                raise IntegrityError(
                                    f"corrupt wide stream: match distance {v} "
                                    f"outside decoded prefix ({len(blk)} bytes "
                                    f"+ {dlen} dict)"
                                )
                            for _ in range(l):
                                p = len(blk) - v
                                blk.append(blk[p] if p >= 0 else dictionary[dlen + p])
                    out += blk
            return _verified(bytes(out[: info.total_len]), info)

        from ..ops.wide_decode import decode_wide_blocks

        return _verified(
            decode_wide_blocks(
                block_payloads(data, info), info.block_size, info.total_len,
                info.wide_priors, info.total_reads,
                dictionary or None,
            ),
            info,
        )

    if engine == "native":
        from .. import native

        payloads = block_payloads(data, info)
        return _verified(
            native.decode_blocks(payloads, info.hist_bits, info.block_size, info.total_len),
            info,
        )

    if engine == "serial":
        from ..codec import decode_bytes
        from ..format.frame import SENTINEL_FRAME

        out = bytearray()
        off = info.payload_off
        header = info.hist_bits.to_bytes(2, "big") + info.frame_bits.to_bytes(2, "big")
        for cs in info.comp_sizes:
            stream = header + data[off : off + cs] + SENTINEL_FRAME
            out += decode_bytes(stream)
            off += cs
        return _verified(bytes(out), info)

    # +1 step per bucket: every block spends one scan step on its
    # terminator header
    full = np.empty(len(info.comp_sizes) * info.block_size, np.uint8)
    for streams, num_steps, idx in stage_v1_buckets(data, info):
        out, _produced = decode_v1_staged(streams, num_steps, info.block_size)
        out_np = np.asarray(out)
        for row, b in enumerate(idx):
            full[b * info.block_size : (b + 1) * info.block_size] = out_np[row]
    return _verified(full.tobytes()[: info.total_len], info)
