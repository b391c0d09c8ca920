"""Canonical Huffman research codec (Moffat-Turpin style), host + device decode.

Capability parity with the reference's research coders
(research/moffat-turpin-huff0-rs/src/coder.rs:112-218 and the Go twin):
two-queue Huffman over all 256 byte symbols, iterative length limiting to
14 bits by halving counts and rebuilding, canonical code assignment, and
left-justified base-code/offset decode tables.

Two container schemes:

- adaptive_* : the reference's semi-static scheme - each frame is coded
  with the table built from the *previous* frame's bytes (bootstrap
  uniform), frame sizes doubling 4 KB -> 32 KB. Serial by construction.
- block container (encode/decode): per-block static tables (256 nibble
  code lengths = 128 bytes stored per block), which is what lets the device
  kernel decode many blocks in lockstep - the same SIMD-across-streams
  design as the LZ engine.
"""

import struct
from functools import partial

import numpy as np

CODE_LEN_LIMIT = 14
_PEEK = CODE_LEN_LIMIT


# ---------------------------------------------------------------- tables
def code_lengths(counts) -> np.ndarray:
    """Length-limited Huffman code lengths over 256 symbols (all coded)."""
    counts = np.maximum(np.asarray(counts, dtype=np.int64), 1)

    while True:
        lengths = _huffman_depths(counts)
        if lengths.max() <= CODE_LEN_LIMIT:
            return lengths
        counts = np.maximum(counts >> 1, 1)


def _huffman_depths(counts: np.ndarray) -> np.ndarray:
    """Two-queue Huffman: leaves sorted ascending + FIFO of merged nodes."""
    n = len(counts)
    order = np.argsort(counts, kind="stable")
    leaf_w = counts[order]
    # nodes: (weight, children) with leaves as ints, internals as tuples
    merged_w = []
    merged_kids = []
    li = 0
    mi = 0

    def pop_min():
        nonlocal li, mi
        take_leaf = li < n and (mi >= len(merged_w) or leaf_w[li] <= merged_w[mi])
        if take_leaf:
            li += 1
            return leaf_w[li - 1], int(order[li - 1])
        mi += 1
        return merged_w[mi - 1], merged_kids[mi - 1]

    for _ in range(n - 1):
        w1, k1 = pop_min()
        w2, k2 = pop_min()
        merged_w.append(w1 + w2)
        merged_kids.append((k1, k2))

    depths = np.zeros(n, dtype=np.int32)
    stack = [(merged_kids[-1], 0)]
    while stack:
        node, d = stack.pop()
        if isinstance(node, tuple):
            stack.append((node[0], d + 1))
            stack.append((node[1], d + 1))
        else:
            depths[node] = d
    return depths


def canonical_codes(lengths: np.ndarray):
    """Canonical assignment: codes ordered by (length, symbol).

    Returns (codes u32[256], first_code u32[15], offset i32[15],
    sym_table u8[256])."""
    lengths = np.asarray(lengths, dtype=np.int32)
    counts_per_len = np.bincount(lengths, minlength=CODE_LEN_LIMIT + 1)
    first = np.zeros(CODE_LEN_LIMIT + 2, dtype=np.int64)
    code = 0
    for length in range(1, CODE_LEN_LIMIT + 1):
        first[length] = code
        code = (code + counts_per_len[length]) << 1
    assert code <= (1 << (CODE_LEN_LIMIT + 1)), "over-subscribed code"

    codes = np.zeros(256, dtype=np.uint32)
    sym_table = np.zeros(256, dtype=np.uint8)
    offset = np.zeros(CODE_LEN_LIMIT + 1, dtype=np.int32)
    nxt = first.copy()
    k = 0
    for length in range(1, CODE_LEN_LIMIT + 1):
        offset[length] = k
        for s in range(256):
            if lengths[s] == length:
                codes[s] = nxt[length]
                nxt[length] += 1
                sym_table[k] = s
                k += 1
    return codes, first[: CODE_LEN_LIMIT + 1].astype(np.uint32), offset, sym_table


def left_tables(lengths: np.ndarray):
    """Left-justified decode tables: for each length L, the 14-bit-justified
    limit of its code range plus the symbol offset."""
    _, first, offset, sym_table = canonical_codes(lengths)
    counts_per_len = np.bincount(lengths, minlength=CODE_LEN_LIMIT + 1)
    base_left = np.zeros(CODE_LEN_LIMIT + 1, dtype=np.int64)
    limit_left = np.zeros(CODE_LEN_LIMIT + 1, dtype=np.int64)
    for L in range(1, CODE_LEN_LIMIT + 1):
        base_left[L] = int(first[L]) << (_PEEK - L)
        limit_left[L] = (int(first[L]) + int(counts_per_len[L])) << (_PEEK - L)
    return base_left, limit_left, offset, sym_table


# ---------------------------------------------------------------- host bit io
class _BitWriter:
    def __init__(self):
        self.out = bytearray()
        self.word = 0
        self.bits = 0

    def put(self, v: int, nb: int) -> None:
        self.word |= v << (32 - self.bits - nb)
        self.bits += nb
        while self.bits >= 8:
            self.out.append((self.word >> 24) & 0xFF)
            self.word = (self.word << 8) & 0xFFFFFFFF
            self.bits -= 8

    def flush(self) -> bytes:
        for _ in range(4):
            self.out.append((self.word >> 24) & 0xFF)
            self.word = (self.word << 8) & 0xFFFFFFFF
        self.bits = 0
        self.word = 0
        return bytes(self.out)


def _encode_payload(data: bytes, lengths: np.ndarray) -> bytes:
    codes, _, _, _ = canonical_codes(lengths)
    w = _BitWriter()
    for b in data:
        w.put(int(codes[b]), int(lengths[b]))
    return w.flush()


def _decode_payload(payload: bytes, lengths: np.ndarray, n: int) -> bytes:
    base_left, limit_left, offset, sym_table = left_tables(lengths)
    out = bytearray()
    word = 0
    bits = 0
    pos = 0
    for _ in range(n):
        while bits < _PEEK and pos < len(payload):
            word = ((word << 8) | payload[pos]) & 0x3FFFFF
            pos += 1
            bits += 8
        peek = (word >> (bits - _PEEK)) & (_PEEK_MASK)
        L = 1
        while L < CODE_LEN_LIMIT and peek >= limit_left[L]:
            L += 1
        idx = offset[L] + ((peek - base_left[L]) >> (_PEEK - L))
        out.append(int(sym_table[idx]))
        bits -= L
    return bytes(out)


_PEEK_MASK = (1 << _PEEK) - 1


# ---------------------------------------------------------------- containers
MAGIC = b"NLZH"
_HDR = struct.Struct(">4sBxHIQ")


def encode(data: bytes, block_size: int = 32768) -> bytes:
    """Per-block static canonical-Huffman container (device-decodable)."""
    nblocks = (len(data) + block_size - 1) // block_size if data else 0
    out = bytearray(_HDR.pack(MAGIC, 1, 0, nblocks, len(data)))
    metas = []
    payloads = []
    for b in range(nblocks):
        chunk = data[b * block_size : (b + 1) * block_size]
        lengths = code_lengths(np.bincount(np.frombuffer(chunk, np.uint8), minlength=256))
        payload = _encode_payload(chunk, lengths)
        # 256 nibble lengths (1..14 fit a nibble)
        packed = bytes(
            (int(lengths[2 * i]) - 1) | ((int(lengths[2 * i + 1]) - 1) << 4)
            for i in range(128)
        )
        metas.append(struct.pack(">I", len(payload)) + packed)
        payloads.append(payload)
    for m in metas:
        out += m
    for p in payloads:
        out += p
    # store block_size after header for ragged reconstruction
    return bytes(out[: _HDR.size]) + struct.pack(">I", block_size) + bytes(out[_HDR.size :])


def _parse(data: bytes):
    magic, ver, _, nblocks, total = _HDR.unpack_from(data, 0)
    if magic != MAGIC:
        raise ValueError("not an NLZH container")
    (block_size,) = struct.unpack_from(">I", data, _HDR.size)
    off = _HDR.size + 4
    sizes = []
    lens = []
    for _ in range(nblocks):
        (ps,) = struct.unpack_from(">I", data, off)
        packed = data[off + 4 : off + 4 + 128]
        arr = np.zeros(256, np.int32)
        for i, byte in enumerate(packed):
            arr[2 * i] = (byte & 0xF) + 1
            arr[2 * i + 1] = (byte >> 4) + 1
        sizes.append(ps)
        lens.append(arr)
        off += 4 + 128
    return block_size, total, sizes, lens, off


def decode(data: bytes, engine: str = "host") -> bytes:
    """engine: host (per-block Python) | device (batched JAX decode)."""
    if engine not in ("host", "device"):
        raise ValueError(f"unknown engine {engine!r}; expected host or device")
    block_size, total, sizes, lens, off = _parse(data)
    if engine == "device":
        return _decode_device(data, block_size, total, sizes, lens, off)
    out = bytearray()
    for b, (ps, lengths) in enumerate(zip(sizes, lens)):
        n = min(block_size, total - b * block_size)
        out += _decode_payload(data[off : off + ps], lengths, n)
        off += ps
    return bytes(out)


# ---------------------------------------------------------------- device decode
def _decode_device(data, block_size, total, sizes, lens, off):
    """Batched canonical-Huffman decode: B blocks advance one symbol per
    scan step; length resolution is 14 dense compares, symbol lookup is a
    one-hot contraction over the per-block permutation table."""
    import jax
    import jax.numpy as jnp

    B = len(sizes)
    if B == 0:
        return b""
    S = max(sizes) + 8
    streams = np.zeros((B, S), np.uint8)
    for b, ps in enumerate(sizes):
        streams[b, :ps] = np.frombuffer(data, np.uint8, ps, off)
        off += ps

    base_l = np.zeros((B, CODE_LEN_LIMIT + 1), np.int32)
    limit_l = np.zeros((B, CODE_LEN_LIMIT + 1), np.int32)
    offs = np.zeros((B, CODE_LEN_LIMIT + 1), np.int32)
    syms = np.zeros((B, 256), np.int32)
    for b, lengths in enumerate(lens):
        bl, ll, o, st = left_tables(lengths)
        base_l[b], limit_l[b], offs[b], syms[b] = bl, ll, o, st

    n_out = np.minimum(np.full(B, block_size), np.maximum(total - np.arange(B) * block_size, 0))
    T = int(n_out.max())

    out = _huff_scan(
        jnp.asarray(streams),
        jnp.asarray(base_l),
        jnp.asarray(limit_l),
        jnp.asarray(offs),
        jnp.asarray(syms),
        jnp.asarray(n_out.astype(np.int32)),
        T,
    )
    flat = np.asarray(out).T.reshape(-1)  # [T, B] -> per-block rows
    res = bytearray()
    for b in range(B):
        res += flat[b * T : b * T + int(n_out[b])].tobytes()
    return bytes(res[:total])


_JITTED_SCAN = None


def _huff_scan(streams, base_l, limit_l, offs, syms, n_out, T):
    global _JITTED_SCAN
    if _JITTED_SCAN is None:
        import jax

        _JITTED_SCAN = jax.jit(_huff_scan_body, static_argnames=("T",))
    return _JITTED_SCAN(streams, base_l, limit_l, offs, syms, n_out, T=T)


def _huff_scan_body(streams, base_l, limit_l, offs, syms, n_out, T):
    import jax
    import jax.numpy as jnp

    B, S = streams.shape
    d32 = jnp.pad(streams, ((0, 0), (0, (-S) % 4))).reshape(B, -1, 4).astype(jnp.uint32)
    data32 = d32[:, :, 0] | (d32[:, :, 1] << 8) | (d32[:, :, 2] << 16) | (d32[:, :, 3] << 24)
    lrange = jnp.arange(1, CODE_LEN_LIMIT + 1)

    def win_byte(win, base, offp):
        j = offp - base
        sel = jax.nn.one_hot(jnp.clip(j >> 2, 0, 2), 3, dtype=jnp.int32)
        w = jnp.sum(sel * win.astype(jnp.int32), axis=1).astype(jnp.uint32)
        return ((w >> ((j & 3) << 3).astype(jnp.uint32)) & jnp.uint32(0xFF)).astype(jnp.int32)

    def step(carry, t):
        word, bits, pos = carry
        # refill to >= 14 bits (2 predicated byte loads from a 3-word window)
        base = pos >> 2
        cols = [
            jnp.take_along_axis(data32, jnp.clip(base + k, 0, data32.shape[1] - 1)[:, None], axis=1)[:, 0]
            for k in range(3)
        ]
        win = jnp.stack(cols, axis=1)
        wbase = base << 2
        for _ in range(2):
            can = bits < _PEEK
            byte = win_byte(win, wbase, pos)
            word = jnp.where(can, ((word << 8) | byte.astype(jnp.uint32)) & jnp.uint32(0x3FFFFF), word)
            pos = pos + can.astype(jnp.int32)
            bits = bits + jnp.where(can, 8, 0)
        peek = ((word >> jnp.clip(bits - _PEEK, 0, 31).astype(jnp.uint32))).astype(jnp.int32) & _PEEK_MASK
        # code length: first L with peek < limit_l[L]
        ge = (peek[:, None] >= limit_l[:, 1:]).astype(jnp.int32)  # [B, 14]
        L = 1 + jnp.sum(ge, axis=1)
        L = jnp.clip(L, 1, CODE_LEN_LIMIT)
        l_oh = jax.nn.one_hot(L, CODE_LEN_LIMIT + 1, dtype=jnp.int32)
        bl = jnp.sum(l_oh * base_l, axis=1)
        of = jnp.sum(l_oh * offs, axis=1)
        idx = of + ((peek - bl) >> (_PEEK - L))
        sym = jnp.sum(jax.nn.one_hot(jnp.clip(idx, 0, 255), 256, dtype=jnp.int32) * syms, axis=1)
        bits = bits - L
        return (word, bits, pos), sym.astype(jnp.uint8)

    carry = (
        jnp.zeros((B,), jnp.uint32),
        jnp.zeros((B,), jnp.int32),
        jnp.zeros((B,), jnp.int32),
    )
    _, ys = jax.lax.scan(step, carry, jnp.arange(T))
    return ys


# ---------------------------------------------------------------- adaptive
def adaptive_encode(data: bytes, initial_frame: int = 4096, max_frame: int = 32768) -> bytes:
    """Semi-static scheme of the reference research coder: each frame uses
    the table built from the previous frame (bootstrap uniform)."""
    out = bytearray(b"NLZA")
    counts = np.ones(256, np.int64)
    frame = initial_frame
    pos = 0
    while pos < len(data):
        chunk = data[pos : pos + frame]
        lengths = code_lengths(counts)
        payload = _encode_payload(chunk, lengths)
        out += struct.pack(">II", len(chunk), len(payload))
        out += payload
        counts = np.bincount(np.frombuffer(chunk, np.uint8), minlength=256).astype(np.int64)
        pos += len(chunk)
        frame = min(frame * 2, max_frame)
    out += struct.pack(">II", 0, 0)
    return bytes(out)


def adaptive_decode(data: bytes, initial_frame: int = 4096, max_frame: int = 32768) -> bytes:
    if data[:4] != b"NLZA":
        raise ValueError("not an NLZA stream")
    out = bytearray()
    counts = np.ones(256, np.int64)
    pos = 4
    while True:
        n, ps = struct.unpack_from(">II", data, pos)
        pos += 8
        if n == 0:
            break
        lengths = code_lengths(counts)
        chunk = _decode_payload(data[pos : pos + ps], lengths, n)
        out += chunk
        counts = np.bincount(np.frombuffer(chunk, np.uint8), minlength=256).astype(np.int64)
        pos += ps
    return bytes(out)
