"""ctypes bindings for the native host runtime (native/libnlzmx.so).

The native library is the framework's C++ engine: serial optimal/greedy
encode, serial decode, threaded block-container codec, op-array LZ
expansion (phase 2 of the device pipeline), and CRC32. It is built with
`make -C native`; this module auto-builds it on first use if the toolchain
is available.
"""

import ctypes
import os
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

_NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "libnlzmx.so"

PARSER_GREEDY = 0
PARSER_OPTIMAL = 1

_PARSER_IDS = {"greedy": PARSER_GREEDY, "optimal": PARSER_OPTIMAL}


class NativeUnavailable(RuntimeError):
    pass


@lru_cache(maxsize=1)
def load() -> ctypes.CDLL:
    if not _LIB_PATH.exists():
        try:
            subprocess.run(
                ["make", "-C", str(_NATIVE_DIR)], check=True, capture_output=True
            )
        except (OSError, subprocess.CalledProcessError) as e:
            raise NativeUnavailable(f"cannot build native library: {e}") from e
    lib = ctypes.CDLL(str(_LIB_PATH))

    c_u8p = ctypes.POINTER(ctypes.c_uint8)
    c_i64 = ctypes.c_longlong
    c_i64p = ctypes.POINTER(c_i64)
    c_i32p = ctypes.POINTER(ctypes.c_int)

    lib.nlzmx_crc32.restype = ctypes.c_uint
    lib.nlzmx_crc32.argtypes = [c_u8p, c_i64, ctypes.c_uint]

    lib.nlzmx_encode_block.restype = c_i64
    lib.nlzmx_encode_block.argtypes = [c_u8p, c_i64, ctypes.c_int, ctypes.c_int, c_u8p, c_i64, c_i64p]

    lib.nlzmx_decode_block.restype = c_i64
    lib.nlzmx_decode_block.argtypes = [c_u8p, c_i64, ctypes.c_int, c_u8p, c_i64]

    lib.nlzmx_expand_ops.restype = c_i64
    lib.nlzmx_expand_ops.argtypes = [c_i32p, c_i32p, c_i64, c_u8p, c_i64]

    lib.nlzmx_expand_ops_dict.restype = c_i64
    lib.nlzmx_expand_ops_dict.argtypes = [c_i32p, c_i32p, c_i64, c_u8p, c_i64, c_u8p, c_i64]

    lib.nlzmx_parse_blocks.restype = ctypes.c_int
    lib.nlzmx_parse_blocks.argtypes = [
        c_u8p, c_i64, c_i64, ctypes.c_int, ctypes.c_int, c_i32p, c_i32p, c_i64,
    ]

    lib.nlzmx_classify_reps.restype = None
    lib.nlzmx_classify_reps.argtypes = [c_i32p, c_i32p, c_i64, c_i64, c_i32p]

    lib.nlzmx_classify_reps_bm.restype = None
    lib.nlzmx_classify_reps_bm.argtypes = [c_i32p, c_i32p, c_i64, c_i64, c_i32p]

    lib.nlzmx_lift_deep.restype = None
    lib.nlzmx_lift_deep.argtypes = [
        c_i32p, c_i32p, c_i64, c_i64, ctypes.c_int, ctypes.c_int, ctypes.c_int, c_i32p,
        c_i64,
    ]

    lib.nlzmx_lift_split.restype = ctypes.c_int
    lib.nlzmx_lift_split.argtypes = [
        c_u8p, c_i64, c_i64, c_i32p, c_i32p, c_i64, c_i64,
        ctypes.c_int, ctypes.c_int, c_i32p, c_i64, ctypes.c_int,
    ]

    lib.nlzmx_wide_encode.restype = ctypes.c_int
    lib.nlzmx_wide_encode.argtypes = [
        c_i32p, c_i32p, c_i32p, c_i64, c_i64, ctypes.c_int, ctypes.c_int,
        c_u8p, c_i64, c_i64p, c_u8p,
    ]

    lib.nlzmx_wide_encode_data.restype = ctypes.c_int
    lib.nlzmx_wide_encode_data.argtypes = [
        c_u8p, c_i64, c_i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, c_u8p, c_i64, c_i64p, c_u8p, c_i32p, c_i32p, c_i64p,
        c_u8p, c_i64, c_u8p, ctypes.c_int,
    ]

    lib.nlzmx_encode_blocks.restype = ctypes.c_int
    lib.nlzmx_encode_blocks.argtypes = [
        c_u8p, c_i64, c_i64, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        c_u8p, c_i64, c_i64p, c_i64p, c_i64p,
    ]

    lib.nlzmx_decode_blocks.restype = ctypes.c_int
    lib.nlzmx_decode_blocks.argtypes = [
        c_u8p, c_i64, c_i64p, c_i64, ctypes.c_int, c_i64, ctypes.c_int, c_u8p, c_i64,
    ]

    lib.nlzmx_senc_new.restype = ctypes.c_void_p
    lib.nlzmx_senc_new.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.nlzmx_senc_feed.restype = ctypes.c_int
    lib.nlzmx_senc_feed.argtypes = [ctypes.c_void_p, c_u8p, c_i64, ctypes.c_int]
    lib.nlzmx_senc_pending.restype = c_i64
    lib.nlzmx_senc_pending.argtypes = [ctypes.c_void_p]
    lib.nlzmx_senc_take.restype = c_i64
    lib.nlzmx_senc_take.argtypes = [ctypes.c_void_p, c_u8p, c_i64]
    lib.nlzmx_senc_stats.restype = None
    lib.nlzmx_senc_stats.argtypes = [ctypes.c_void_p, c_i64p, c_i64p]
    lib.nlzmx_senc_free.restype = None
    lib.nlzmx_senc_free.argtypes = [ctypes.c_void_p]
    lib.nlzmx_sdec_new.restype = ctypes.c_void_p
    lib.nlzmx_sdec_new.argtypes = [ctypes.c_int]
    lib.nlzmx_sdec_feed.restype = ctypes.c_int
    lib.nlzmx_sdec_feed.argtypes = [ctypes.c_void_p, c_u8p, c_i64]
    lib.nlzmx_sdec_pending.restype = c_i64
    lib.nlzmx_sdec_pending.argtypes = [ctypes.c_void_p]
    lib.nlzmx_sdec_take.restype = c_i64
    lib.nlzmx_sdec_take.argtypes = [ctypes.c_void_p, c_u8p, c_i64]
    lib.nlzmx_sdec_free.restype = None
    lib.nlzmx_sdec_free.argtypes = [ctypes.c_void_p]
    return lib


def available() -> bool:
    try:
        load()
        return True
    except NativeUnavailable:
        return False


def _u8p(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def crc32(data: bytes, prev: int = 0) -> int:
    buf = np.frombuffer(data, dtype=np.uint8)
    if len(buf) == 0:
        return prev
    return load().nlzmx_crc32(_u8p(buf), len(buf), prev)


def encode_block(data: bytes, hist_bits: int, parser: str = "optimal"):
    """Encode one block -> (payload_bytes, total_reads, num_cmds)."""
    lib = load()
    src = np.frombuffer(data, dtype=np.uint8)
    cap = max(4096, len(data) * 2 + 65536)
    dst = np.empty(cap, dtype=np.uint8)
    stats = np.zeros(2, dtype=np.int64)
    sz = lib.nlzmx_encode_block(
        _u8p(src) if len(src) else _u8p(dst),
        len(src),
        hist_bits,
        _PARSER_IDS[parser],
        _u8p(dst),
        cap,
        stats.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
    )
    if sz < 0:
        raise RuntimeError("native encode failed (capacity)")
    return dst[:sz].tobytes(), int(stats[0]), int(stats[1])


def decode_block(payload: bytes, hist_bits: int, out_cap: int) -> bytes:
    lib = load()
    src = np.frombuffer(payload, dtype=np.uint8)
    dst = np.empty(max(out_cap, 1), dtype=np.uint8)
    got = lib.nlzmx_decode_block(_u8p(src), len(src), hist_bits, _u8p(dst), out_cap)
    if got < 0:
        raise RuntimeError("native decode failed")
    return dst[:got].tobytes()


def expand_ops(op_len: np.ndarray, op_val: np.ndarray, out_cap: int,
               dictionary: bytes | None = None) -> bytes:
    """Expand one block's op arrays (int32, aligned) into bytes.

    dictionary: optional shared-dict bytes as virtual history before the
    output start (distances may reach len(dictionary) bytes back)."""
    lib = load()
    op_len = np.ascontiguousarray(op_len, dtype=np.int32)
    op_val = np.ascontiguousarray(op_val, dtype=np.int32)
    dst = np.empty(max(out_cap, 1), dtype=np.uint8)
    i32p = ctypes.POINTER(ctypes.c_int)
    if dictionary:
        darr = np.frombuffer(dictionary, dtype=np.uint8)
        got = lib.nlzmx_expand_ops_dict(
            op_len.ctypes.data_as(i32p), op_val.ctypes.data_as(i32p),
            len(op_len), _u8p(dst), out_cap, _u8p(darr), len(darr),
        )
    else:
        got = lib.nlzmx_expand_ops(
            op_len.ctypes.data_as(i32p), op_val.ctypes.data_as(i32p),
            len(op_len), _u8p(dst), out_cap,
        )
    if got < 0:
        raise RuntimeError("native expand failed")
    return dst[:got].tobytes()


class StreamEncoder:
    """Bounded-memory streaming NLZM encoder (frames-only payload).

    Feed input in chunks, drain compressed bytes as they complete;
    native state holds O(window) regardless of file size - the
    reference's overlapped-refill driver (NLZM.cpp:1870-1885) as a
    feed-driven API. Byte-identical to encode_block on the same input
    (same chunk schedule; differentially tested)."""

    def __init__(self, hist_bits: int, parser: str = "optimal"):
        self._lib = load()
        self._h = self._lib.nlzmx_senc_new(hist_bits, _PARSER_IDS[parser])
        self.hist_bits = hist_bits

    def _drain(self) -> bytes:
        n = self._lib.nlzmx_senc_pending(self._h)
        if n == 0:
            return b""
        buf = np.empty(n, np.uint8)
        got = self._lib.nlzmx_senc_take(self._h, _u8p(buf), n)
        return buf[:got].tobytes()

    def feed(self, data: bytes, final: bool = False) -> bytes:
        arr = np.frombuffer(data, np.uint8)
        self._lib.nlzmx_senc_feed(
            self._h, _u8p(arr) if len(arr) else _u8p(np.zeros(1, np.uint8)),
            len(arr), 1 if final else 0,
        )
        return self._drain()

    def finish(self) -> bytes:
        return self.feed(b"", final=True)

    def stats(self):
        import ctypes as ct

        reads = np.zeros(1, np.int64)
        cmds = np.zeros(1, np.int64)
        p64 = ct.POINTER(ct.c_longlong)
        self._lib.nlzmx_senc_stats(
            self._h, reads.ctypes.data_as(p64), cmds.ctypes.data_as(p64))
        return int(reads[0]), int(cmds[0])

    def close(self):
        if self._h:
            self._lib.nlzmx_senc_free(self._h)
            self._h = None

    __del__ = close


class StreamDecoder:
    """Bounded-memory streaming NLZM decoder (frames-only payload).

    Feed compressed bytes, drain decoded output; native state holds one
    window of history. `done` flips when the sentinel frame is seen."""

    def __init__(self, hist_bits: int):
        self._lib = load()
        self._h = self._lib.nlzmx_sdec_new(hist_bits)
        self.done = False

    def feed(self, data: bytes) -> bytes:
        arr = np.frombuffer(data, np.uint8)
        rc = self._lib.nlzmx_sdec_feed(
            self._h, _u8p(arr) if len(arr) else _u8p(np.zeros(1, np.uint8)),
            len(arr),
        )
        if rc < 0:
            raise RuntimeError("corrupt NLZM stream")
        if rc == 1:
            self.done = True
        n = self._lib.nlzmx_sdec_pending(self._h)
        if n == 0:
            return b""
        buf = np.empty(n, np.uint8)
        got = self._lib.nlzmx_sdec_take(self._h, _u8p(buf), n)
        return buf[:got].tobytes()

    def close(self):
        if self._h:
            self._lib.nlzmx_sdec_free(self._h)
            self._h = None

    __del__ = close


def encode_blocks(data: bytes, block_size: int, hist_bits: int, parser: str = "optimal", threads: int = 0):
    """Threaded block encode -> (list of payloads, reads, cmds)."""
    lib = load()
    n = len(data)
    nblocks = (n + block_size - 1) // block_size
    if nblocks == 0:
        return [], [], []
    threads = threads or min(os.cpu_count() or 1, nblocks)
    src = np.frombuffer(data, dtype=np.uint8)
    block_cap = block_size * 2 + 65536
    dst = np.empty(nblocks * block_cap, dtype=np.uint8)
    sizes = np.zeros(nblocks, dtype=np.int64)
    reads = np.zeros(nblocks, dtype=np.int64)
    cmds = np.zeros(nblocks, dtype=np.int64)
    p64 = ctypes.POINTER(ctypes.c_longlong)
    rc = lib.nlzmx_encode_blocks(
        _u8p(src), n, block_size, hist_bits, _PARSER_IDS[parser], threads,
        _u8p(dst), block_cap,
        sizes.ctypes.data_as(p64), reads.ctypes.data_as(p64), cmds.ctypes.data_as(p64),
    )
    if rc != 0:
        raise RuntimeError("native block encode failed")
    payloads = [dst[b * block_cap : b * block_cap + sizes[b]].tobytes() for b in range(nblocks)]
    return payloads, reads.tolist(), cmds.tolist()


def decode_blocks(payloads: list, hist_bits: int, block_size: int, total_len: int, threads: int = 0) -> bytes:
    """Threaded block decode of per-block payloads."""
    lib = load()
    nblocks = len(payloads)
    if nblocks == 0:
        return b""
    threads = threads or min(os.cpu_count() or 1, nblocks)
    stride = max(len(p) for p in payloads) + 8
    src = np.zeros(nblocks * stride, dtype=np.uint8)
    sizes = np.zeros(nblocks, dtype=np.int64)
    for b, p in enumerate(payloads):
        src[b * stride : b * stride + len(p)] = np.frombuffer(p, dtype=np.uint8)
        sizes[b] = len(p)
    dst = np.empty(nblocks * block_size, dtype=np.uint8)
    rc = lib.nlzmx_decode_blocks(
        _u8p(src), stride,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
        nblocks, hist_bits, block_size, threads, _u8p(dst), len(dst),
    )
    if rc != 0:
        raise RuntimeError("native block decode failed")
    return dst.tobytes()[:total_len]


def lift_deep(op_len: np.ndarray, op_val: np.ndarray, block_size: int, cap: int = 15,
              threads: int = 0, dict_len: int = 0) -> np.ndarray:
    """Bound literal-ancestor depth in [T, B] command arrays (in place).

    dict_len > 0: a shared dictionary of that many bytes precedes every
    block as depth-0 virtual history. Returns the per-block max chain
    depth (the decoder's exact pointer-doubling round budget is
    ceil(log2(depth)))."""
    assert op_len.dtype == np.int32 and op_val.dtype == np.int32
    assert op_len.flags.c_contiguous and op_val.flags.c_contiguous
    T, B = op_len.shape
    if threads <= 0:
        threads = min(16, os.cpu_count() or 1)
    i32p = ctypes.POINTER(ctypes.c_int)
    depths = np.zeros(B, np.int32)
    load().nlzmx_lift_deep(
        op_len.ctypes.data_as(i32p), op_val.ctypes.data_as(i32p),
        T, B, block_size, cap, threads, depths.ctypes.data_as(i32p), dict_len,
    )
    return depths


def lift_split(
    data: bytes, op_len: np.ndarray, op_val: np.ndarray, block_size: int,
    cap: int = 4, threads: int = 0, dict_len: int = 0, strict: bool = False,
):
    """Hard-cap literal-ancestor depth by lifting AND splitting matches.

    Unlike lift_deep, the returned per-block depth is guaranteed <= cap,
    so the device expander's doubling-round budget is exactly
    ceil(log2(cap)). Command counts can grow (splits); returns new
    ([T', B] op_len, op_val, depths).
    """
    assert op_len.dtype == np.int32 and op_val.dtype == np.int32
    T, B = op_len.shape
    if threads <= 0:
        threads = min(16, os.cpu_count() or 1)
    i32p = ctypes.POINTER(ctypes.c_int)
    src = np.frombuffer(data, dtype=np.uint8)
    t_cap = T + max(T // 2, 256)
    while True:
        ol = np.full((B, t_cap), -1, np.int32)
        ov = np.zeros((B, t_cap), np.int32)
        ol[:, :T] = op_len.T
        ov[:, :T] = op_val.T
        depths = np.zeros(B, np.int32)
        rc = load().nlzmx_lift_split(
            _u8p(src), len(data), block_size,
            ol.ctypes.data_as(i32p), ov.ctypes.data_as(i32p), t_cap, B,
            cap, threads, depths.ctypes.data_as(i32p), dict_len,
            1 if strict else 0,
        )
        if rc == 0:
            # live rows are a prefix of each block's row
            t_out = int((ol >= 0).sum(axis=1).max()) if B else 0
            return (
                np.ascontiguousarray(ol[:, :t_out].T),
                np.ascontiguousarray(ov[:, :t_out].T),
                depths,
            )
        t_cap *= 2


def wide_encode_pipeline(data: bytes, block_size: int, hist_bits: int,
                         depth_cap: int = 16, with_priors: bool = True,
                         threads: int = 0, progress=None,
                         dictionary: bytes | None = None,
                         priors_in: bytes | None = None,
                         strict: bool = False):
    """Full native wide-profile encode: parse -> lift(-split) ->
    rep-classify -> plane encode, one library call with per-thread
    scratch (staged [B, T] op arrays cost ~64 MB of first-touch page
    faults).

    priors_in: encode against this serialized priors blob instead of
    building one from these blocks (the streaming driver shares bucket
    0's blob across every bucket; the returned blob echoes priors_in).

    Returns (payloads, priors_blob, depths, ncmds)."""
    from .format.wide import priors_blob_size

    lib = load()
    n = len(data)
    nblocks = (n + block_size - 1) // block_size
    if nblocks == 0:
        return [], b"", np.zeros(0, np.int32), []
    if threads <= 0:
        threads = min(16, os.cpu_count() or 1)
    i32p = ctypes.POINTER(ctypes.c_int)
    i64p = ctypes.POINTER(ctypes.c_longlong)
    src = np.frombuffer(data, dtype=np.uint8)
    out_cap = n + nblocks * 70000 + (1 << 20)
    out = np.empty(out_cap, np.uint8)
    sizes = np.zeros(nblocks, np.int64)
    depths = np.zeros(nblocks, np.int32)
    ncmds = np.zeros(nblocks, np.int32)
    priors = np.zeros(priors_blob_size(), np.uint8)
    counter = np.zeros(1, np.int64)
    stop = None
    if progress is not None:
        # ctypes releases the GIL during the call; poll the C-side
        # counter from a thread for the reference-style live status
        import threading

        stop = threading.Event()

        def _poll():
            while not stop.wait(0.25):
                done = int(counter[0])  # parse phase + encode phase
                progress.update(min(min(done, 2 * nblocks) * block_size // 2, progress.total))

        poller = threading.Thread(target=_poll, daemon=True)
        poller.start()
    darr = np.frombuffer(dictionary, dtype=np.uint8) if dictionary else None
    parr = None
    if priors_in is not None:
        if len(priors_in) != priors_blob_size():
            raise ValueError("priors_in blob has the wrong size")
        parr = np.frombuffer(priors_in, dtype=np.uint8)
    try:
        while True:
            rc = lib.nlzmx_wide_encode_data(
                _u8p(src), n, block_size, hist_bits, depth_cap,
                1 if with_priors else 0, threads,
                _u8p(out), out_cap, sizes.ctypes.data_as(i64p), _u8p(priors),
                depths.ctypes.data_as(i32p), ncmds.ctypes.data_as(i32p),
                counter.ctypes.data_as(i64p),
                _u8p(darr) if darr is not None else None,
                len(darr) if darr is not None else 0,
                _u8p(parr) if parr is not None else None,
                1 if strict else 0,
            )
            if rc != 1:
                break
            # rc==1: out_cap overflow (pathological expansion) - regrow
            out_cap *= 2
            out = np.empty(out_cap, np.uint8)
    finally:
        if stop is not None:
            stop.set()
            poller.join()
    if rc != 0:
        raise RuntimeError(f"native wide encode failed (rc={rc})")
    payloads = []
    off = 0
    for b in range(nblocks):
        payloads.append(out[off : off + int(sizes[b])].tobytes())
        off += int(sizes[b])
    blob = priors_in if priors_in is not None else (
        priors.tobytes() if with_priors else b"")
    return payloads, blob, depths, [int(c) for c in ncmds]


def wide_encode(op_len: np.ndarray, op_val: np.ndarray, op_rep: np.ndarray,
                with_priors: bool = True, threads: int = 0):
    """Threaded wide-profile plane encode of [T, B] command arrays.

    Byte-identical to format.wide.encode_wide_blocks (tests diff them);
    ~50x faster (blocks encode block-per-thread instead of batched
    numpy). Returns (payloads list, priors_blob bytes)."""
    from .format.wide import priors_blob_size

    assert op_len.dtype == np.int32 and op_val.dtype == np.int32
    T, B = op_len.shape
    if B == 0:
        return [], b""
    if threads <= 0:
        threads = min(16, os.cpu_count() or 1)
    i32p = ctypes.POINTER(ctypes.c_int)
    ol = np.ascontiguousarray(op_len.T)
    ov = np.ascontiguousarray(op_val.T)
    orp = np.ascontiguousarray(np.asarray(op_rep, np.int32).T)
    # worst-case payload: headers + chunk tables + incompressible planes
    out_cap = B * (17 * T + 65536)
    out = np.empty(out_cap, np.uint8)
    sizes = np.zeros(B, np.int64)
    priors = np.zeros(priors_blob_size(), np.uint8)
    rc = load().nlzmx_wide_encode(
        ol.ctypes.data_as(i32p), ov.ctypes.data_as(i32p), orp.ctypes.data_as(i32p),
        T, B, 1 if with_priors else 0, threads,
        _u8p(out), out_cap,
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)), _u8p(priors),
    )
    if rc != 0:
        raise RuntimeError("native wide encode overflow")
    payloads = []
    off = 0
    for b in range(B):
        payloads.append(out[off : off + int(sizes[b])].tobytes())
        off += int(sizes[b])
    return payloads, (priors.tobytes() if with_priors else b"")


def parse_blocks(data: bytes, block_size: int, hist_bits: int, threads: int = 0):
    """Native optimal parse -> ([T, B] op_len, op_val) command arrays."""
    lib = load()
    n = len(data)
    nblocks = (n + block_size - 1) // block_size
    if nblocks == 0:
        return np.zeros((0, 0), np.int32), np.zeros((0, 0), np.int32)
    threads = threads or min(os.cpu_count() or 1, nblocks)
    t_cap = block_size + 8
    src = np.frombuffer(data, dtype=np.uint8)
    ol = np.empty((nblocks, t_cap), np.int32)
    ov = np.zeros((nblocks, t_cap), np.int32)
    i32p = ctypes.POINTER(ctypes.c_int)
    rc = lib.nlzmx_parse_blocks(
        _u8p(src), n, block_size, hist_bits, threads,
        ol.ctypes.data_as(i32p), ov.ctypes.data_as(i32p), t_cap,
    )
    if rc != 0:
        raise RuntimeError("native parse failed")
    return np.ascontiguousarray(ol.T), np.ascontiguousarray(ov.T)


def classify_reps(op_len: np.ndarray, op_val: np.ndarray) -> np.ndarray:
    """Wide-profile rep classification of [T, B] command arrays."""
    assert op_len.dtype == np.int32 and op_len.flags.c_contiguous
    assert op_val.dtype == np.int32 and op_val.flags.c_contiguous
    T, B = op_len.shape
    out = np.full((T, B), -1, np.int32)  # rows past a block's end stay -1
    i32p = ctypes.POINTER(ctypes.c_int)
    load().nlzmx_classify_reps(
        op_len.ctypes.data_as(i32p), op_val.ctypes.data_as(i32p), T, B,
        out.ctypes.data_as(i32p),
    )
    return out
