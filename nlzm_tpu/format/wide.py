"""NLZP wide profile: plane-separated, lane-parallel block format.

The v1 block profile keeps the reference's per-symbol-adaptive model
(NLZM.cpp:212-438), which forces the decoder to advance one command per
scan step and to over-fetch worst-case renorm windows - on a device that is
gather-bound (~7 gathered words per command). The wide profile is the
device-first redesign of the same command stream:

- **Planes.** Commands are split into independent symbol sequences:
  `tok` (literal/dict/rep), `lit` (whole literal byte), `len` (direct
  length), `lex` (length extension byte), `dst` (distance slot), plus a
  raw-bit plane (rep index, distance extra bits). Every plane is
  single-read and context-free (wire v4): one CDF read and one rANS
  renorm per symbol, over joint alphabets up to 256, so ALL five planes
  decode in one fused scan.
- **Lane-parallel rANS.** Each plane interleaves L independent rANS lanes
  (round-robin by symbol). Renorm byte pairs are laid out in exact decode
  order (step, read, lane), so a step fetches ONE contiguous window of
  at most 2L bytes per read instead of per-lane worst-case windows.
  The rANS math is identical to the reference's (NLZM.cpp:444-488):
  14-bit CDFs, 16-bit renorm, 4-byte little-endian lane seeds.
- **Chunked semi-adaptive CDFs.** Tables are static within a chunk
  (warmup schedule 2/2/4/8 steps, then every CHUNK_STEPS=8) and rebuilt
  from realized symbol counts at chunk boundaries (carry halved each
  boundary). Encoder and decoder run the same
  deterministic rebuild, so no tables are transmitted. This trades the
  reference's per-symbol adaptation for lane-parallel decodability.
- **Parallel rep semantics.** `rep idx r` references the r-th most recent
  *dict* command distance (duplicates allowed, no MTF dedup, virtual
  initial table {1,2,3,4} like RepModel's init, NLZM.cpp:1154-1158).
  Unlike the reference's present-check MTF (NLZM.cpp:1160-1181) this
  resolves with a vectorized gather instead of a sequential table replay.

Block payload layout (big-endian):

    for each of the 5 planes: u32 sym_count, u32 stream_bytes
    u32 bits_bytes
    for each plane: u16 x (NC-1) chunk pair-count deltas (renorm pairs
        emitted in each chunk except the last; chunk byte offsets are
        their exclusive prefix sums x2; NC =
        len(chunk_schedule(padded_steps(sym_count, lanes))) is derivable
        from sym_count, so no length prefix; a chunk emits at most
        lanes x CHUNK_STEPS <= 512 pairs, so u16 is ample)
    then the 5 plane streams (each: L x u32le lane seeds, then renorm
    pairs in decode order), then the raw-bit plane (MSB-first).

The chunk-offset tables exist for the device decoder: the host stages
each chunk's renorm window as a dense array slice, so the device scan never
gathers from the stream mid-loop (XLA gathers run ~70M elem/s on this
class of chip; they were the scan bottleneck). Cost ~0.3% of payload.

This module holds the format tables and the host (numpy) encoder; the
batched device decoder lives in nlzm_tpu.ops.wide_decode.
"""

from dataclasses import dataclass

import numpy as np

from ..constants import CDF_SCALE_BITS, CDF_SCALE_TOTAL

CHUNK_STEPS = 8  # steady-state table rebuild cadence (in scan steps)
WARMUP_CHUNKS = (2, 2, 4, 8)  # short early chunks: fast model warmup


def chunk_schedule(steps_needed: int) -> tuple:
    """Chunk lengths covering >= steps_needed (warmup then steady)."""
    sched = []
    total = 0
    for w in WARMUP_CHUNKS:
        sched.append(w)
        total += w
        if total >= steps_needed:
            return tuple(sched)
    while total < steps_needed:
        sched.append(CHUNK_STEPS)
        total += CHUNK_STEPS
    return tuple(sched)


def padded_steps(n_sym: int, lanes: int) -> int:
    """Total scan steps (= sum of the chunk schedule) for n_sym symbols."""
    need = max(1, -(-n_sym // lanes))
    return sum(chunk_schedule(need))


@dataclass(frozen=True)
class PlaneSpec:
    name: str
    lanes: int
    reads: int  # CDF reads per symbol
    alphabets: tuple  # per read
    rows: tuple  # context rows per read

    @property
    def chunk_syms(self) -> int:
        return CHUNK_STEPS * self.lanes


# Wire v4: every plane is SINGLE-READ over a joint alphabet with NO
# context rows. lit carries the whole byte (256 symbols: the exact
# joint of the old hi/lo nibble factorization P(hi) * P(lo|hi)), lex
# the whole extension byte, dst the whole 6-bit slot UNCONDITIONED
# (v3's 4 lc rows measured 0.5% WORSE here: row-splitting dilutes the
# chunk-rebuilt table statistics more than the context helps, unlike
# the reference's continuously-adaptive CDFs where splitting is almost
# free). One read per symbol = ONE rANS renorm per symbol; with all
# five planes context-free the decoder runs a SINGLE fused scan - the
# dst plane no longer waits for assembled lc context.
#
# Lane counts are a throughput/ratio knob: steps per scan shrink with L
# while the rANS seed overhead grows (4 B per lane per block) and chunk
# adaptation coarsens (chunk_syms = CHUNK_STEPS * L). v3 = 2x the
# round-2 lanes with CHUNK_STEPS 16 -> 8 (per-symbol rebuild cadence
# unchanged); 208 lanes x 4 B = 832 B/block of seeds, half of wire v2's.
# Measured (16 MiB non-periodic corpus, wide+dict): v4 0.4706 at 32 KiB
# blocks / 0.4389 at 128 KiB+64K dict (v3 with lc rows: 0.4746/0.4432;
# v2 nibble planes: 0.4946; round-2 lanes: 0.4652) - the joint
# alphabets' finer adaptation more than pays back v2's ratio regression
# while keeping scan steps / 2, and dropping the lc rows both fuses the
# dst scan and gains ~0.8%.
PLANES = (
    PlaneSpec("tok", 64, 1, (4,), (1,)),
    PlaneSpec("lit", 64, 1, (256,), (1,)),
    PlaneSpec("len", 32, 1, (8,), (1,)),
    PlaneSpec("lex", 16, 1, (256,), (1,)),
    PlaneSpec("dst", 32, 1, (64,), (1,)),
)
N_PLANES = len(PLANES)
HDR_BYTES = 8 * N_PLANES + 4

TOK_LIT, TOK_DICT, TOK_REP = 0, 1, 2


def build_cdf(counts: np.ndarray, nsym: int) -> np.ndarray:
    """Deterministic fence table from symbol counts.

    counts: [..., nsym] -> fences [..., max(nsym, 16) + 1] with
    fence[0]=0 and fence[nsym..]=2^14; every symbol keeps freq >= 1 (the
    last symbol absorbs rounding slack). Width floors at 17 for the
    legacy 16-symbol consumers (research/ppm_tpu).
    """
    width = max(nsym, 16) + 1
    tot = counts.sum(axis=-1, keepdims=True)
    freq = 1 + (counts * (CDF_SCALE_TOTAL - nsym)) // (tot + 1)
    fences = np.zeros(counts.shape[:-1] + (width,), np.int32)
    np.cumsum(freq, axis=-1, out=fences[..., 1 : nsym + 1])
    fences[..., nsym:] = CDF_SCALE_TOTAL
    return fences


class _TableBank:
    """Per-(block, read) chunked-adaptive fence tables (numpy).

    prior: optional per-read [rows, nsym] counts shared by every block
    (container-level warm start); seeds the carry and the initial tables.
    """

    def __init__(self, B: int, spec: PlaneSpec, prior=None):
        self.spec = spec
        self.tables = []  # per read: [B, rows, 17]
        self.counts = []  # fresh counts this chunk
        self.carry = []  # decayed history
        for r in range(spec.reads):
            rows, nsym = spec.rows[r], spec.alphabets[r]
            if prior is not None:
                c0 = np.broadcast_to(prior[r], (B, rows, nsym)).astype(np.int64)
                self.carry.append(c0.copy())
                self.tables.append(build_cdf(c0, nsym))
            else:
                t = np.zeros((B, rows, max(nsym, 16) + 1), np.int32)
                step = CDF_SCALE_TOTAL // nsym
                t[..., 1 : nsym + 1] = np.arange(1, nsym + 1) * step
                t[..., nsym:] = CDF_SCALE_TOTAL
                self.tables.append(t)
                self.carry.append(np.zeros((B, rows, nsym), np.int64))
            self.counts.append(np.zeros((B, rows, nsym), np.int64))

    def span(self, r: int, row: np.ndarray, y: np.ndarray, active: np.ndarray):
        """(start, freq) for symbols y in context rows; bumps counts."""
        B, L = y.shape
        b = np.arange(B)[:, None]
        t = self.tables[r][b, row]  # [B, L, 17]
        l = np.arange(L)[None, :]
        start = t[b, l, y]
        freq = t[b, l, y + 1] - start
        np.add.at(self.counts[r], (b.repeat(L, 1)[active], row[active], y[active]), 1)
        return start, freq

    def boundary(self):
        for r in range(self.spec.reads):
            self.carry[r] = (self.carry[r] >> 1) + self.counts[r]
            self.counts[r][:] = 0
            self.tables[r] = build_cdf(self.carry[r], self.spec.alphabets[r])


def _rans_encode_plane(spec: PlaneSpec, syms, rows, n_sym, B, prior=None):
    """Backward interleaved rANS over one plane.

    syms/rows: per read r, [B, T_pad] symbol / context-row arrays
    (T_pad = steps*L); rows[r] may be None for single-row reads (all
    context rows 0 - the wire-v4 planes). n_sym: [B] symbol counts.
    Returns list of per-block byte strings (seeds + pairs, decode order).
    """
    L = spec.lanes
    T_pad = syms[0].shape[1]
    steps = T_pad // L
    bank = _TableBank(B, spec, prior)

    boundary_after = set()
    acc = 0
    for c in chunk_schedule(steps):
        acc += c
        boundary_after.add(acc - 1)

    # forward pass: realized (start, freq) per (step, read, lane)
    starts = [np.zeros((steps, B, L), np.int32) for _ in range(spec.reads)]
    freqs = [np.ones((steps, B, L), np.int32) for _ in range(spec.reads)]
    actives = np.zeros((steps, B, L), bool)
    sym_r = [s.reshape(B, steps, L) for s in syms]
    row_r = [
        None if rows[r] is None else rows[r].reshape(B, steps, L)
        for r in range(spec.reads)
    ]
    zero_row = np.zeros((B, L), np.int64)
    lane_idx = np.arange(L)[None, :]
    for t in range(steps):
        active = (t * L + lane_idx) < n_sym[:, None]
        actives[t] = active
        for r in range(spec.reads):
            y = sym_r[r][:, t, :]
            row_t = zero_row if row_r[r] is None else row_r[r][:, t, :]
            st, fq = bank.span(r, row_t, y, active)
            starts[r][t] = np.where(active, st, 0)
            freqs[r][t] = np.where(active, fq, 1)
        if t in boundary_after:
            bank.boundary()

    # backward pass per lane
    x = np.full((B, L), 1 << 16, np.uint64)
    R = spec.reads
    pair_all = np.zeros((steps * R, B, L), np.uint16)
    mask_all = np.zeros((steps * R, B, L), bool)
    for t in range(steps - 1, -1, -1):
        for r in range(R - 1, -1, -1):
            active = actives[t]
            fq = freqs[r][t].astype(np.uint64)
            st = starts[r][t].astype(np.uint64)
            over = active & (x >= (fq << 18))
            pair_all[t * R + r] = (x & 0xFFFF).astype(np.uint16)
            mask_all[t * R + r] = over
            x1 = np.where(over, x >> 16, x)
            x2 = ((x1 // fq) << CDF_SCALE_BITS) + (x1 % fq) + st
            x = np.where(active, x2, x)

    # assemble per block in decode order (t, r, lane): big-endian pairs
    pa = pair_all.transpose(1, 0, 2).reshape(B, -1)  # [B, steps*R*L]
    ma = mask_all.transpose(1, 0, 2).reshape(B, -1)
    seeds = x.astype("<u4").view(np.uint8).reshape(B, 4 * L)

    # per-chunk byte offsets (relative to the pairs region) for the
    # device decoder's window staging; chunk c starts at 2x(number of
    # renorm pairs emitted before its first step)
    sched = chunk_schedule(steps)
    chunk_start_steps = np.cumsum((0,) + sched[:-1])
    pair_per_step = ma.reshape(B, steps, R * L).sum(axis=2)  # [B, steps]
    cum = np.zeros((B, steps + 1), np.int64)
    np.cumsum(pair_per_step, axis=1, out=cum[:, 1:])
    offsets = 2 * cum[:, chunk_start_steps]  # [B, NC]

    streams = []
    for b in range(B):
        sel = pa[b][ma[b]].astype(">u2")
        streams.append(seeds[b].tobytes() + sel.tobytes())
    return streams, offsets


PRIOR_ROW_BUDGET = 256  # per-row prior mass (carry-scale counts)


def build_priors(syms_all, rows_all, masks_all):
    """Global per-plane (row, symbol) prior counts from batched arrays.

    syms_all/rows_all: {plane: per-read [B, T_pad] arrays}; masks_all:
    {plane: [B, T_pad] active}. rows_all entries may be None for
    single-row reads. Rows scale to PRIOR_ROW_BUDGET total.
    """
    priors = {}
    for spec in PLANES:
        pr = []
        for r in range(spec.reads):
            h = np.zeros((spec.rows[r], spec.alphabets[r]), np.int64)
            m = masks_all[spec.name]
            sy = syms_all[spec.name][r][m]
            rows = rows_all[spec.name][r]
            if rows is None or spec.rows[r] == 1:
                h[0] = np.bincount(sy, minlength=spec.alphabets[r])[
                    : spec.alphabets[r]
                ]
            else:
                np.add.at(h, (rows[m], sy), 1)
            tot = h.sum(axis=1, keepdims=True)
            pr.append((h * PRIOR_ROW_BUDGET) // np.maximum(tot, 1))
        priors[spec.name] = pr
    return priors


def serialize_priors(priors) -> bytes:
    out = bytearray()
    for spec in PLANES:
        for r in range(spec.reads):
            out += priors[spec.name][r].astype(">u2").tobytes()
    return bytes(out)


def parse_priors(blob: bytes):
    priors = {}
    off = 0
    for spec in PLANES:
        pr = []
        for r in range(spec.reads):
            n = spec.rows[r] * spec.alphabets[r]
            a = np.frombuffer(blob, ">u2", n, off).astype(np.int64)
            pr.append(a.reshape(spec.rows[r], spec.alphabets[r]))
            off += 2 * n
        priors[spec.name] = pr
    return priors


def priors_blob_size() -> int:
    return 2 * sum(
        spec.rows[r] * spec.alphabets[r]
        for spec in PLANES
        for r in range(spec.reads)
    )


def _pack_bits(widths: np.ndarray, values: np.ndarray) -> bytes:
    """MSB-first bit packing of (width, value) fields (single block)."""
    total = int(widths.sum())
    if total == 0:
        return b""
    offs = np.cumsum(widths) - widths
    w_rep = np.repeat(widths, widths)
    v_rep = np.repeat(values, widths)
    idx_within = np.arange(total) - np.repeat(offs, widths)
    bits = (v_rep >> (w_rep - 1 - idx_within)) & 1
    return np.packbits(bits.astype(np.uint8)).tobytes()


def mmin_of(delta: np.ndarray) -> np.ndarray:
    """Distance-dependent minimum length (dtype-preserving: callers pass
    i32 at [T, B] scale, where i64 temporaries double the first-touch
    page-fault bill)."""
    one = delta.dtype.type(1)
    return (
        2 * one
        + (delta > 0xFF).astype(delta.dtype)
        + (delta > 0xFFF).astype(delta.dtype)
        + (delta > 0xFFFFF).astype(delta.dtype)
    )


def dist_slot_of(dv: np.ndarray):
    """(slot, add_bits, extra) per the reference slot code (NLZM.cpp:1311-1318).

    dtype-preserving; nbits via float32 log2 (exact for dv < 2^24 -
    distances are < 2^28 but practical deltas here are < 2^18)."""
    dt = dv.dtype
    nbits = np.zeros_like(dv)
    nz = dv > 0
    nbits[nz] = np.floor(np.log2(dv[nz].astype(np.float64))).astype(dt) + dt.type(1)
    big = dv >= 4
    ab = np.where(big, nbits - dt.type(2), dt.type(0))
    top = dv >> np.maximum(ab, 0)
    slot = np.where(big, ((nbits - dt.type(1)) << 1) + (top & 1), dv)
    extra = dv & ((dt.type(1) << np.maximum(ab, 0)) - dt.type(1))
    return slot, ab, extra


def batch_plane_arrays(op_len, op_val, op_rep):
    """Per-block classification + batched plane arrays, vectorized over
    the whole [T, B] command batch (a per-block Python loop here was the
    device-encode pipeline's staging wall).

    Returns (per_block, batched, plane_counts): per_block holds each
    block's (None, raw bits); batched maps plane name ->
    (syms [reads][B, T_pad] i32, rows (None per single-row read),
    counts [B], mask [B, T_pad]). Shared by the host (numpy) and device
    (jit) plane encoders. The native mirror of the classification lives
    in native/src/wide.cpp.
    """
    op_len = np.asarray(op_len, np.int32)
    op_val = np.asarray(op_val, np.int32)
    op_rep = np.asarray(op_rep, np.int32)
    T, B = op_len.shape
    neg = op_len < 0
    n_b = np.where(neg.any(axis=0), neg.argmax(axis=0), T)  # [B]
    valid = np.arange(T)[:, None] < n_b[None, :]

    is_lit = valid & (op_len == 0)
    is_match = valid & (op_len > 0)
    is_rep = is_match & (op_rep >= 0)
    is_dict = is_match & (op_rep < 0)

    tok = np.where(is_lit, TOK_LIT, np.where(is_rep, TOK_REP, TOK_DICT)).astype(np.int32)

    delta = np.where(is_match, op_val, 1).astype(np.int32)
    lv = np.where(is_match, op_len - mmin_of(delta), 0).astype(np.int32)
    assert (lv[is_match] >= 0).all() and (lv[is_match] <= 262).all()
    len_sym = np.minimum(lv, 7)
    is_ext = is_match & (lv >= 7)
    ext = np.maximum(lv - 7, 0)  # <= 255: one joint extension byte

    slot, ab, extra = dist_slot_of(delta - np.int32(1))

    # raw-bit plane, command order: rep -> 2-bit index; dict -> ab bits
    widths = np.zeros((T, B), np.int32)
    widths[is_rep] = 2
    widths[is_dict] = ab[is_dict]
    values = np.zeros((T, B), np.int32)
    values[is_rep] = op_rep[is_rep]
    values[is_dict] = extra[is_dict]
    per_block = [
        (None, _pack_bits(widths[: n_b[b], b], values[: n_b[b], b]))
        for b in range(B)
    ]

    plane_data = {
        "tok": (tok, valid),
        "lit": (op_val, is_lit),
        "len": (len_sym, is_match),
        "lex": (ext, is_ext),
        "dst": (slot, is_dict),
    }
    batched = {}
    plane_counts = []
    b_iota = np.broadcast_to(np.arange(B)[None, :], (T, B))
    for spec in PLANES:
        sym, m = plane_data[spec.name]
        counts = m.sum(axis=0).astype(np.int64)
        T_pad = padded_steps(int(counts.max()), spec.lanes) * spec.lanes
        packed = np.zeros((B, T_pad), np.int32)
        pos = np.cumsum(m, axis=0, dtype=np.int32) - 1
        packed[b_iota[m], pos[m]] = sym[m]
        mask = np.arange(T_pad)[None, :] < counts[:, None]
        batched[spec.name] = (
            [packed], [None] * spec.reads, counts, mask,
        )
        plane_counts.append(counts)
    return per_block, batched, plane_counts


def assemble_payloads(per_block, plane_counts, plane_streams, plane_offsets):
    """Per-block payload bytes from plane streams + chunk offsets."""
    payloads = []
    B = len(per_block)
    for b in range(B):
        out = bytearray()
        for i in range(N_PLANES):
            out += int(plane_counts[i][b]).to_bytes(4, "big")
            out += len(plane_streams[i][b]).to_bytes(4, "big")
        bits = per_block[b][1]
        out += len(bits).to_bytes(4, "big")
        for i in range(N_PLANES):
            # the block's own chunk count (a prefix of the batch schedule)
            nc = len(chunk_schedule(padded_steps(int(plane_counts[i][b]), PLANES[i].lanes)))
            offs = plane_offsets[i][b, : nc + 1]
            # the last chunk's count is implied by the stream length
            deltas = (offs[1 : nc] - offs[: nc - 1]) // 2
            out += deltas.astype(">u2").tobytes()
        for i in range(N_PLANES):
            out += plane_streams[i][b]
        out += bits
        payloads.append(bytes(out))
    return payloads


def build_priors_from_batched(batched):
    """Container-level warm-start priors from batch_plane_arrays output."""
    return build_priors(
        {n: v[0] for n, v in batched.items()},
        {n: v[1] for n, v in batched.items()},
        {n: v[3] for n, v in batched.items()},
    )


def encode_wide_blocks(op_len, op_val, op_rep, with_priors: bool = True):
    """Encode command arrays [T, B] into per-block wide payloads.

    op_len < 0 marks steps past a block's end; all blocks' planes encode
    batched (the rANS passes vectorize across blocks and lanes).
    Returns (payloads, priors_blob) - the blob ("" when with_priors is
    False) carries container-level warm-start counts shared by all blocks.
    """
    per_block, batched, plane_counts = batch_plane_arrays(op_len, op_val, op_rep)
    B = len(per_block)

    priors, blob = None, b""
    if with_priors:
        priors = build_priors_from_batched(batched)
        blob = serialize_priors(priors)

    plane_streams = []
    plane_offsets = []
    for spec in PLANES:
        syms_p, rows_p, counts, _ = batched[spec.name]
        streams, offsets = _rans_encode_plane(
            spec, syms_p, rows_p, counts, B,
            priors[spec.name] if priors else None,
        )
        plane_streams.append(streams)
        plane_offsets.append(offsets)

    return (
        assemble_payloads(per_block, plane_counts, plane_streams, plane_offsets),
        blob,
    )


def encode_wide_block(op_len, op_val, op_rep) -> bytes:
    """Single-block convenience wrapper (no priors) over encode_wide_blocks."""
    op_len = np.asarray(op_len, np.int64)[:, None]
    op_val = np.asarray(op_val, np.int64)[:, None]
    op_rep = np.asarray(op_rep, np.int64)[:, None]
    return encode_wide_blocks(op_len, op_val, op_rep, with_priors=False)[0][0]


def empty_payload() -> bytes:
    """Format-valid payload of a zero-command block (mesh padding).

    Zero symbol counts still require each plane's 4*L seed bytes (the
    decoder stages seeds unconditionally; an all-zero header would make
    the streams shorter than the seed region).
    """
    out = bytearray()
    for spec in PLANES:
        out += (0).to_bytes(4, "big")
        out += (4 * spec.lanes).to_bytes(4, "big")
    out += (0).to_bytes(4, "big")  # bits_len; nc=1 per plane -> no deltas
    for spec in PLANES:
        out += bytes(4 * spec.lanes)
    return bytes(out)


def parse_payload(payload: bytes):
    """Split one wide block payload into its sections.

    Returns (counts, streams, offsets, bits): per-plane symbol counts,
    stream bytes (seeds + pairs), chunk-offset arrays, and the raw-bit
    plane bytes.
    """
    counts, sizes = [], []
    off = 0
    for _ in range(N_PLANES):
        counts.append(int.from_bytes(payload[off : off + 4], "big"))
        sizes.append(int.from_bytes(payload[off + 4 : off + 8], "big"))
        off += 8
    bits_len = int.from_bytes(payload[off : off + 4], "big")
    off += 4
    offsets = []
    for i in range(N_PLANES):
        nc = len(chunk_schedule(padded_steps(counts[i], PLANES[i].lanes)))
        deltas = np.frombuffer(payload, ">u2", nc - 1, off).astype(np.int64)
        off += 2 * (nc - 1)
        o = np.zeros(nc, np.int64)
        np.cumsum(2 * deltas, out=o[1:])
        offsets.append(o)
    streams = []
    for s in sizes:
        streams.append(payload[off : off + s])
        off += s
    bits = payload[off : off + bits_len]
    return counts, streams, offsets, bits


class _PlaneDecoder:
    """Host reference decoder for one plane stream (mirror of
    _rans_encode_plane; the batched device decoder must match it)."""

    def __init__(self, spec: PlaneSpec, stream: bytes, n_sym: int, prior=None,
                 chunk_offsets=None):
        self.spec = spec
        L = spec.lanes
        self.x = np.frombuffer(stream[: 4 * L], "<u4").astype(np.uint64).copy()
        self.pos = 4 * L
        self.stream = stream
        self.n = n_sym
        self.bank = _TableBank(1, spec, prior)
        self.steps = padded_steps(n_sym, spec.lanes)
        self.boundary_after = set()
        self.chunk_start_of = {}  # step -> chunk index (at chunk starts)
        acc = 0
        for ci, c in enumerate(chunk_schedule(self.steps)):
            self.chunk_start_of[acc] = ci
            acc += c
            self.boundary_after.add(acc - 1)
        self.chunk_offsets = chunk_offsets  # verified when provided

    def decode(self, row_fn):
        """row_fn(read, lane_syms_so_far...) -> context rows; returns
        per-read symbol arrays [n]."""
        spec, L = self.spec, self.spec.lanes
        out = [np.zeros(self.steps * L, np.int64) for _ in range(spec.reads)]
        lane_idx = np.arange(L)
        for t in range(self.steps):
            ci = self.chunk_start_of.get(t)
            if ci is not None and self.chunk_offsets is not None:
                stored = int(self.chunk_offsets[ci])
                have = self.pos - 4 * L
                if stored != have:
                    raise ValueError(
                        f"corrupt wide payload: plane {spec.name} chunk {ci} "
                        f"offset mismatch (stored {stored}, cursor {have})"
                    )
            active = (t * L + lane_idx) < self.n
            ys = []
            for r in range(spec.reads):
                rows = row_fn(r, t, ys)
                tbl = self.bank.tables[r][0, rows]  # [L, 17]
                f = (self.x & 0x3FFF).astype(np.int64)
                y = (f[:, None] >= tbl[:, 1:]).sum(axis=1)
                start = tbl[lane_idx, y]
                freq = tbl[lane_idx, y + 1] - start
                x2 = freq.astype(np.uint64) * (self.x >> CDF_SCALE_BITS) + (
                    f - start
                ).astype(np.uint64)
                for lane in range(L):
                    if not active[lane]:
                        continue
                    v = x2[lane]
                    if v < (1 << 16):
                        if self.pos + 2 > len(self.stream):
                            # A corrupt pair near the stream tail can flip
                            # a lane's FINAL refill decision (the renorm
                            # after its last active symbol, whose state is
                            # discarded) - the device decoder correctly
                            # reads a zero window there; the host must not
                            # crash with a bare IndexError.
                            raise ValueError(
                                f"corrupt wide payload: plane {spec.name} "
                                f"stream exhausted at step {t}"
                            )
                        b0v = self.stream[self.pos]
                        b1v = self.stream[self.pos + 1]
                        self.pos += 2
                        v = (v << 16) | (b0v << 8) | b1v
                    self.x[lane] = v
                y = np.where(active, y, 0)
                np.add.at(
                    self.bank.counts[r],
                    (np.zeros(int(active.sum()), np.int64), rows[active], y[active]),
                    1,
                )
                out[r][t * L : (t + 1) * L] = y
                ys.append(y)
            if t in self.boundary_after:
                self.bank.boundary()
        return [o[: self.n] for o in out]


def decode_wide_block(payload: bytes, priors_blob: bytes | None = None):
    """Host reference decode of one wide block -> (op_len, op_val) arrays."""
    priors = parse_priors(priors_blob) if priors_blob else None
    prior_of = lambda name: priors[name] if priors else None
    counts, streams, offsets, bits = parse_payload(payload)

    def simple_rows(spec):
        return lambda r, t, ys: (
            np.zeros(spec.lanes, np.int64) if r == 0 else ys[0]
        )

    tok = _PlaneDecoder(PLANES[0], streams[0], counts[0], prior_of("tok"), offsets[0]).decode(
        simple_rows(PLANES[0])
    )[0]
    lit_b = _PlaneDecoder(PLANES[1], streams[1], counts[1], prior_of("lit"), offsets[1]).decode(
        simple_rows(PLANES[1])
    )[0]
    len_sym = _PlaneDecoder(PLANES[2], streams[2], counts[2], prior_of("len"), offsets[2]).decode(
        simple_rows(PLANES[2])
    )[0]
    ext = _PlaneDecoder(PLANES[3], streams[3], counts[3], prior_of("lex"), offsets[3]).decode(
        simple_rows(PLANES[3])
    )[0]

    slot_arr = _PlaneDecoder(PLANES[4], streams[4], counts[4], prior_of("dst"), offsets[4]).decode(
        simple_rows(PLANES[4])
    )[0]

    # assembly (sequential host mirror)
    T = counts[0]
    is_lit = tok == TOK_LIT
    is_rep = tok == TOK_REP
    is_dict = tok == TOK_DICT
    n_match = int((~is_lit).sum())
    esc = len_sym[:n_match] == 7
    lv = len_sym[:n_match].copy()
    lv[esc] = 7 + ext[: int(esc.sum())]

    # raw bits
    bit_arr = np.unpackbits(np.frombuffer(bits, np.uint8))
    op_len = np.zeros(T, np.int64)
    op_val = np.zeros(T, np.int64)
    lit_i = m_i = dict_i = lex_i = bit_p = 0
    hist = [1, 2, 3, 4]
    for k in range(T):
        if is_lit[k]:
            op_val[k] = lit_b[lit_i]
            lit_i += 1
            continue
        this_lv = lv[m_i]
        m_i += 1
        if is_rep[k]:
            r = int(
                (bit_arr[bit_p] << 1) | bit_arr[bit_p + 1]
            )
            bit_p += 2
            delta = hist[r]
        else:
            slot = slot_arr[dict_i]
            dict_i += 1
            if slot < 4:
                dv = int(slot)
            else:
                ab = int(slot // 2 - 1)
                extra = 0
                for i in range(ab):
                    extra = (extra << 1) | int(bit_arr[bit_p + i])
                bit_p += ab
                dv = ((2 + (int(slot) & 1)) << ab) + extra
            delta = dv + 1
            hist = [delta] + hist[:3]
        op_len[k] = this_lv + int(mmin_of(np.asarray([delta]))[0])
        op_val[k] = delta
    return op_len, op_val


PLANES_BY = {p.name: p for p in PLANES}


def classify_reps_wide(op_len, op_val):
    """op_rep under the wide profile's last-4-dicts rule (single block).

    A match whose distance equals one of the 4 most recent dict-command
    distances (virtual initial history 1,2,3,4) becomes rep r; otherwise
    it is a dict command and its distance enters the history.
    """
    tab = [1, 2, 3, 4]
    op_rep = np.full(len(op_len), -1, np.int64)
    for k in range(len(op_len)):
        if op_len[k] <= 0:
            continue
        d = int(op_val[k])
        if d in tab:
            op_rep[k] = tab.index(d)
        else:
            tab = [d] + tab[:3]
    return op_rep
