"""Bounded-memory NLZP container drivers: bucket-at-a-time file I/O.

The in-memory container path (`blocks.encode_container`/`decode_container`)
holds the whole input, every payload, and the whole archive at once - fine
for benches, fatal for enwik9-class files. These drivers process the file
in buckets of consecutive blocks (default 16 MiB of uncompressed data per bucket), so
RSS stays O(dictionary + bucket) regardless of file size - the container
analog of the reference's fixed-buffer overlapped refill
(/root/reference/NLZM.cpp:1870-1885, 2014-2018).

Wire format: byte-for-byte the same NLZP v4 container `blocks.py` defines.
The only semantic difference is where the warm-start priors come from:
the in-memory encoder histograms EVERY block, the streaming encoder
histograms bucket 0 only and encodes all later buckets against that blob
(the native pipeline's `priors_in`) - any blob is wire-valid because the
decoder applies the stored one.

Layout recap (blocks.py): header | crc32 | [priors] | [dict] | meta table
| payloads. Everything except payload bytes has a size known before the
first payload is written, so the encoder writes placeholders, streams
payloads, and backpatches crc/priors/meta through the (seekable) output.
"""

import os
import struct

import numpy as np

from ..constants import frame_bits_for
from ..utils.crc32 import crc32
from .blocks import (
    _BLK, _HDR, FLAG_CRC32, FLAG_DICT, FLAG_PRIORS, FLAG_WIDE, MAGIC,
    VERSION, WIDE_MAX_BLOCK, ContainerInfo, IntegrityError, _compress_dict,
    check_engine, hist_bits_for_block,
)

DEFAULT_BUCKET_BYTES = 16 << 20


def sample_dict_file(f, flen: int, dict_size: int, segment: int = 2048) -> bytes:
    """blocks.sample_dict over a seekable file (no whole-file read)."""
    if dict_size <= 0 or flen <= dict_size:
        return b""  # mirror blocks.sample_dict: tiny files get no dict
    nseg = max(1, dict_size // segment)
    stride = flen / nseg
    parts = []
    for i in range(nseg):
        off = int(i * stride)
        f.seek(off)
        parts.append(f.read(segment))
    return b"".join(parts)[:dict_size]


def _bucket_blocks(block_size: int, bucket_bytes: int) -> int:
    return max(1, bucket_bytes // block_size)


def encode_container_stream(
    src_path: str,
    dst_path: str,
    block_size: int,
    parser: str = "optimal",
    engine: str = "auto",
    profile: str = "v1",
    depth_cap: int = 8,
    dict_size: int = 0,
    progress=None,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
) -> dict:
    """Stream-encode a file into an NLZP container, bucket by bucket.

    Same parameters and wire output as blocks.encode_container; input is
    read in `bucket_bytes` slices and payloads append as they are ready.
    Returns {"in", "out", "crc32"}.
    """
    from .. import native

    check_engine(engine)
    flen = os.stat(src_path).st_size
    num_blocks = (flen + block_size - 1) // block_size if flen else 0

    use_native = engine == "native" or (engine == "auto" and native.available())
    if profile == "wide":
        if block_size > WIDE_MAX_BLOCK:
            raise ValueError("wide profile caps blocks at 128 KiB")
        if not (engine != "device" and native.available() and parser == "optimal"):
            raise ValueError(
                "streaming wide encode needs the native optimal-parse "
                "pipeline (engine != 'device', parser='optimal', library built)"
            )

    dictionary = b""
    with open(src_path, "rb") as f:
        if dict_size and profile == "wide" and num_blocks:
            dictionary = sample_dict_file(f, flen, dict_size)
    hist_bits = hist_bits_for_block(len(dictionary) + block_size)

    flags = FLAG_CRC32
    if profile == "wide" and num_blocks:
        flags |= FLAG_WIDE | FLAG_PRIORS
        if dictionary:
            flags |= FLAG_DICT

    from ..format.wide import priors_blob_size

    meta = np.zeros((num_blocks, 3), dtype=">u4")
    crc = 0
    bucket_nb = _bucket_blocks(block_size, bucket_bytes)
    priors_blob = None

    with open(src_path, "rb") as fin, open(dst_path, "wb+") as out:
        out.write(
            _HDR.pack(MAGIC, VERSION, hist_bits, frame_bits_for(hist_bits),
                      flags, block_size, flen, num_blocks)
        )
        crc_off = out.tell()
        out.write(b"\0\0\0\0")  # crc backpatched at the end
        priors_off = out.tell()
        if flags & FLAG_PRIORS:
            out.write(bytes(priors_blob_size()))  # backpatched
        if flags & FLAG_DICT:
            dcomp = _compress_dict(dictionary)
            out.write(struct.pack(">II", len(dictionary), len(dcomp)))
            out.write(dcomp)
        meta_off = out.tell()
        out.write(bytes(_BLK.size * num_blocks))  # backpatched

        done = 0
        b0 = 0
        while b0 < num_blocks:
            nb = min(bucket_nb, num_blocks - b0)
            chunk = fin.read(nb * block_size)
            crc = crc32(chunk, crc)
            if profile == "wide":
                payloads, blob, depths, ncmds = native.wide_encode_pipeline(
                    chunk, block_size, hist_bits, depth_cap=depth_cap,
                    dictionary=dictionary or None,
                    with_priors=priors_blob is None,
                    priors_in=priors_blob,
                )
                if priors_blob is None:
                    priors_blob = blob
                for k, p in enumerate(payloads):
                    meta[b0 + k] = (len(p), int(depths[k]), ncmds[k])
                    out.write(p)
            elif engine == "device":
                from ..ops.encode_ops import encode_blocks_device

                payloads, reads, cmds = encode_blocks_device(
                    chunk, block_size, hist_bits, parser=parser)
                for k, p in enumerate(payloads):
                    meta[b0 + k] = (len(p), reads[k], cmds[k])
                    out.write(p)
            elif use_native:
                payloads, reads, cmds = native.encode_blocks(
                    chunk, block_size, hist_bits, parser)
                for k, p in enumerate(payloads):
                    meta[b0 + k] = (len(p), reads[k], cmds[k])
                    out.write(p)
            else:
                from ..lz.encoder import SerialEncoder

                for k in range(nb):
                    blk = chunk[k * block_size : (k + 1) * block_size]
                    enc = SerialEncoder(hist_bits, parser=parser)
                    p = enc.encode_frames(blk)
                    meta[b0 + k] = (len(p), enc.total_reads, enc.total_cmds)
                    out.write(p)
            done += len(chunk)
            b0 += nb
            if progress is not None:
                progress.update(done, out.tell())

        total_out = out.tell()
        out.seek(crc_off)
        out.write(struct.pack(">I", crc))
        if flags & FLAG_PRIORS:
            out.seek(priors_off)
            out.write(priors_blob)
        out.seek(meta_off)
        out.write(meta.tobytes())
    return {"in": flen, "out": total_out, "crc32": crc}


def read_container_head(f) -> ContainerInfo:
    """Parse header + priors + dict + meta from a container FILE; leaves
    the cursor at the first payload byte (== info.payload_off)."""
    hdr = f.read(_HDR.size)
    magic, version, hist_bits, frame_bits, flags, block_size, total_len, num_blocks = (
        _HDR.unpack(hdr)
    )
    if magic != MAGIC:
        raise ValueError("not an NLZP container")
    if version != VERSION:
        raise ValueError(f"unsupported NLZP version {version}")
    crc = None
    if flags & FLAG_CRC32:
        (crc,) = struct.unpack(">I", f.read(4))
    priors = None
    if flags & FLAG_PRIORS:
        from ..format.wide import priors_blob_size

        priors = f.read(priors_blob_size())
    dictionary = None
    if flags & FLAG_DICT:
        raw_len, comp_len = struct.unpack(">II", f.read(8))
        from .blocks import _decompress_dict

        dictionary = _decompress_dict(f.read(comp_len), raw_len)
        if len(dictionary) != raw_len:
            raise IntegrityError("corrupt container dictionary")
    meta = np.frombuffer(f.read(_BLK.size * num_blocks), dtype=">u4")
    meta = meta.reshape(num_blocks, 3).astype(np.int64)
    return ContainerInfo(
        hist_bits=hist_bits,
        frame_bits=frame_bits,
        block_size=block_size,
        total_len=total_len,
        comp_sizes=[int(x) for x in meta[:, 0]],
        total_reads=[int(x) for x in meta[:, 1]],
        num_cmds=[int(x) for x in meta[:, 2]],
        payload_off=f.tell(),
        crc32=crc,
        wide=bool(flags & FLAG_WIDE),
        wide_priors=priors,
        dictionary=dictionary,
    )


def _decode_bucket_wide_device(payloads, info, dict_arr, first_block):
    """Decode one bucket of wide payloads on the device; returns the
    bucket's plain bytes in block order."""
    from ..ops.wide_decode import (
        decode_wide_staged, prepare_wide_bucketed, rounds_hint_of)

    nb = len(payloads)
    out = np.empty(nb * info.block_size, np.uint8)
    buckets = prepare_wide_bucketed(payloads, info.wide_priors, n_buckets=2)
    for staged, idx in buckets:
        staged["rounds_hint"] = rounds_hint_of(
            max((info.total_reads[first_block + b] for b in idx), default=0))
        staged["dict_arr"] = dict_arr
        rows, _produced = decode_wide_staged(staged, info.block_size)
        rows_np = np.asarray(rows)
        for row, b in enumerate(idx):
            out[b * info.block_size : (b + 1) * info.block_size] = rows_np[row]
    return out.tobytes()


def _decode_bucket_v1_device(payloads, info, first_block):
    import jax.numpy as jnp

    from .blocks import _round_up, decode_v1_staged

    nb = len(payloads)
    ncmds = info.num_cmds[first_block : first_block + nb]
    order = sorted(range(nb), key=lambda k: ncmds[k])
    # sub-bucketing pays only at large widths (see stage_v1_buckets)
    n_sub = 2 if nb >= 1024 else 1
    out = np.empty(nb * info.block_size, np.uint8)
    for k in range(n_sub):
        idx = order[k * nb // n_sub : (k + 1) * nb // n_sub]
        if not idx:
            continue
        s = _round_up(max(len(payloads[i]) for i in idx) + 24, 256)
        arr = np.zeros((len(idx), s), np.uint8)
        for row, i in enumerate(idx):
            arr[row, : len(payloads[i])] = np.frombuffer(payloads[i], np.uint8)
        num_steps = _round_up(max(ncmds[i] for i in idx) + 1, 256)
        rows, _ = decode_v1_staged(jnp.asarray(arr), num_steps, info.block_size)
        rows_np = np.asarray(rows)
        for row, i in enumerate(idx):
            out[i * info.block_size : (i + 1) * info.block_size] = rows_np[row]
    return out.tobytes()


def decode_container_stream(
    src_path: str,
    dst_path: str | None,
    engine: str = "device",
    progress=None,
    bucket_bytes: int = DEFAULT_BUCKET_BYTES,
) -> dict:
    """Stream-decode an NLZP container file bucket by bucket.

    dst_path None = test mode (decode + CRC only, like the reference's
    `t`). CRC is accumulated incrementally and verified against the
    stored value. Returns {"in", "out", "crc32"}. engine: device | native.
    """
    from .. import native

    check_engine(engine, ("native", "device"))
    flen = os.stat(src_path).st_size
    with open(src_path, "rb") as fin:
        info = read_container_head(fin)
        num_blocks = len(info.comp_sizes)
        bucket_nb = _bucket_blocks(info.block_size, bucket_bytes)
        dict_arr = None
        if info.wide and engine == "device" and info.dictionary:
            import jax.numpy as jnp

            dict_arr = jnp.asarray(np.frombuffer(info.dictionary, np.uint8))

        out_f = open(dst_path, "wb") if dst_path else None
        crc = 0
        written = 0
        try:
            b0 = 0
            while b0 < num_blocks:
                nb = min(bucket_nb, num_blocks - b0)
                payloads = [fin.read(info.comp_sizes[b0 + k]) for k in range(nb)]
                if info.wide:
                    if engine == "device":
                        plain = _decode_bucket_wide_device(payloads, info, dict_arr, b0)
                    else:
                        # host path: reuse the in-memory wide host decode
                        # on a bucket-sized synthetic container slice
                        from ..format.wide import decode_wide_block

                        parts = []
                        dlen = len(info.dictionary or b"")
                        for p in payloads:
                            op_len, op_val = decode_wide_block(p, info.wide_priors)
                            ol = np.asarray(op_len, np.int32)
                            ov = np.asarray(op_val, np.int32)
                            parts.append(native.expand_ops(
                                ol, ov, info.block_size,
                                info.dictionary or None))
                        plain = b"".join(parts)
                elif engine == "device":
                    plain = _decode_bucket_v1_device(payloads, info, b0)
                else:
                    plain = native.decode_blocks(
                        payloads, info.hist_bits, info.block_size,
                        min(nb * info.block_size,
                            info.total_len - b0 * info.block_size),
                    )
                keep = min(len(plain), info.total_len - b0 * info.block_size)
                plain = plain[:keep]
                crc = crc32(plain, crc)
                if out_f is not None:
                    out_f.write(plain)
                written += keep
                b0 += nb
                if progress is not None:
                    progress.update(written, flen)
        finally:
            if out_f is not None:
                out_f.close()
    if info.crc32 is not None and crc != info.crc32:
        raise IntegrityError(
            f"CRC mismatch: stored {info.crc32:08X}, decoded {crc:08X}"
        )
    return {"in": flen, "out": written, "crc32": crc}
