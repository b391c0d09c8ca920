"""Batched device PPM-class codec: segment-parallel context mixing (NLZC).

device counterpart of the PPM research codec (research/ppm.py): where the
host codec walks a per-symbol-adaptive order-6 hash trie (inherently
sequential, like the reference's PPMd var.I,
/root/reference/research/ppmd-cleaned-cpp/ppmd_model.cpp), this one
restructures context modeling for lane-parallel decode, the same way the
wide LZ profile restructures NLZM:

- **Segments, not interleaves.** Each block splits into L=32 contiguous
  segments, one per rANS lane. A lane decodes its segment sequentially,
  so its context (the previous bytes) is its OWN previous output -
  no cross-lane dependency inside a step. (Round-robin interleaving would
  make byte s's context byte s-1, owned by the neighboring lane in the
  same step - circular.)
- **Order-2-class nibble model (v4).** Two reads per byte: hi nibble
  keyed by the full previous byte + prev2 hi nibble (4096 rows x 16),
  lo nibble keyed by the current hi nibble + full prev byte (4096 x 16).
- **Container prior (v3).** The encoder makes a first pass collecting
  global per-row counts, quantizes them to u8 (max-normed * 64), and
  ships them once per container (2*4096*16 = 128 KiB pre-RLE). Both sides seed
  the initial tables from 8x the prior and add the same term at every
  rebuild - the PPM-style escape-to-lower-order analog, resolved
  statically. Worth ~7% ratio on the bench mix (0.687 -> 0.617).
- **Hierarchical backoff.** At each rebuild every row also receives
  half the summed counts of its 16-row group (read 0: rows sharing the
  prev byte; read 1: rows sharing hi + prev hi nibble):
  counts += group_sum // 2.
- **Chunk-static tables.** Tables are rebuilt from realized counts on
  both sides (warmup 2/2/4/8 then 16 steps, carry halving) - the wide
  profile's adaptation scheme.
- **Same rANS.** 14-bit CDFs, 16-bit renorm, 4-byte LE lane seeds, renorm
  pairs in exact decode order (step, read, lane).

Container: b"NLZC" | u8 ver | u8 lanes | u32be block_size |
u64be total_len | u32be num_blocks | prior | per block u32be
stream_bytes | streams. Per-lane segment lengths derive from the block
length. The prior ships huff0-coded (u32be byte-length prefix; v4's
4096-row table is dense u8 data: 128 KiB raw -> ~60 KiB) and only when
total_len >= PRIOR_MIN - below that the table would swamp the container
and both sides use a zero prior.

Research-grade like the reference's research tree: it demonstrates the
batched formulation; the order-6 host codec remains the ratio reference
(the var.I harness runs order-6, main.cpp:47).
"""

import numpy as np

from ..constants import CDF_SCALE_BITS, CDF_SCALE_TOTAL
from ..format.wide import build_cdf

# NLZC's own adaptation cadence (decoupled from the wide profile's,
# which retunes as its lane counts evolve): rebuild every 16 steps after
# a 2/2/4/8-step warmup.
CHUNK_STEPS = 16
WARMUP_CHUNKS = (2, 2, 4, 8)


def chunk_schedule(steps_needed: int) -> tuple:
    sched, total = [], 0
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
    need = max(1, -(-n_sym // lanes))
    return sum(chunk_schedule(need))

MAGIC = b"NLZC"
VERSION = 4  # v4: 4096-row order-2-class contexts + container prior + backoff
LANES = 32
DEFAULT_BLOCK = 32768
ROWS = 4096
GROUP = 16  # rows per backoff group (same prev byte / same hi+prev-hi)
PRIOR_W = 8  # prior weight at every rebuild
PRIOR_QUANT = 64  # per-row max-norm scale of the shipped u8 prior
BLEND = 2  # uniform prior mass per cell at each rebuild (guards noise rows)
PRIOR_MIN = 65536  # ship the prior only for inputs at least this long


def _seg_lens(nb: int):
    """Per-lane segment lengths for a block of nb bytes."""
    S = -(-nb // LANES) if nb else 0
    lens = np.clip(nb - np.arange(LANES) * S, 0, max(S, 1)).astype(np.int64)
    return S, lens


def _rows_of(prev, prev2, hi):
    """(row0, row1) context rows (v4, order-2-class): hi nibble keyed by
    full prev byte + prev2 hi nibble; lo nibble keyed by current hi +
    full prev byte. 4096 rows each; measured 0.619 -> 0.599 on the 4 MiB
    bench mix vs the 512-row v3 contexts (deeper variants dilute:
    8192-row prev2 expansion measured 0.618)."""
    return (prev << 4) | (prev2 >> 4), (hi << 8) | prev


def _effective_counts(carry, prior):
    """Shared rebuild rule: carry + backoff group-sum + weighted prior.

    carry: [..., ROWS, 16] int64; prior: [ROWS, 16] int64 (quantized).
    Integer arithmetic only - must stay mirror-exact with the device
    rebuild in _decode_blocks.
    """
    shp = carry.shape[:-2]
    gs = carry.reshape(shp + (ROWS // GROUP, GROUP, 16)).sum(axis=-2)
    gs = np.repeat(gs, GROUP, axis=-2)
    return carry + gs // 2 + PRIOR_W * prior


def _layout(data_blocks):
    """Stack blocks -> per-(step, block, lane) symbol/context arrays."""
    B = len(data_blocks)
    lens = [len(b) for b in data_blocks]
    S_b = [-(-nb // LANES) if nb else 0 for nb in lens]
    steps = padded_steps(max(S_b) if S_b else 1, 1)
    sym = np.zeros((B, LANES, steps), np.int64)
    act = np.zeros((B, LANES, steps), bool)
    for b, blk in enumerate(data_blocks):
        arr = np.frombuffer(blk, np.uint8)
        Sb = S_b[b]
        for l in range(LANES):
            seg = arr[l * Sb : (l + 1) * Sb]
            sym[b, l, : len(seg)] = seg
            act[b, l, : len(seg)] = True
    prev = np.concatenate([np.zeros((B, LANES, 1), np.int64), sym[:, :, :-1]], axis=2)
    prev2 = np.concatenate([np.zeros((B, LANES, 2), np.int64), sym[:, :, :-2]], axis=2)
    tr = lambda a: np.ascontiguousarray(a.transpose(2, 0, 1))  # [steps, B, L]
    return tr(sym), tr(prev), tr(prev2), tr(act), steps


def build_prior(sym, prev, prev2, act):
    """Pass 1: global per-row counts, u8-quantized (max-norm * 64)."""
    hi, lo = sym >> 4, sym & 15
    r0, r1 = _rows_of(prev, prev2, hi)
    prior = np.zeros((2, ROWS, 16), np.int64)
    np.add.at(prior[0], (r0[act], hi[act]), 1)
    np.add.at(prior[1], (r1[act], lo[act]), 1)
    mx = np.maximum(prior.max(axis=2, keepdims=True), 1)
    return (prior * PRIOR_QUANT) // mx  # [2, ROWS, 16], values 0..64


def encode_blocks(data_blocks, prior):
    """Pass 2: batched table simulation + backward rANS for all blocks.

    -> list of per-block stream bytes (seeds + renorm pairs, decode
    order)."""
    B = len(data_blocks)
    sym, prev, prev2, act, steps = _layout(data_blocks)
    hi, lo = sym >> 4, sym & 15
    r0, r1 = _rows_of(prev, prev2, hi)

    t = [np.broadcast_to(
            build_cdf(PRIOR_W * prior[r] + BLEND, 16), (B, ROWS, 17)).copy()
         for r in range(2)]
    c = [np.zeros((B, ROWS, 16), np.int64) for _ in range(2)]
    carry = [np.zeros((B, ROWS, 16), np.int64) for _ in range(2)]
    bounds = set(np.cumsum(chunk_schedule(steps)) - 1)
    bidx = np.repeat(np.arange(B), LANES)

    starts = np.zeros((steps, 2, B, LANES), np.int64)
    freqs = np.ones((steps, 2, B, LANES), np.int64)
    for tstep in range(steps):
        a = act[tstep].ravel()
        for r, (rr, yy) in enumerate(((r0[tstep], hi[tstep]), (r1[tstep], lo[tstep]))):
            rrf, yyf = rr.ravel(), yy.ravel()
            st = t[r][bidx, rrf, yyf]
            fq = t[r][bidx, rrf, yyf + 1] - st
            starts[tstep, r] = np.where(a, st, 0).reshape(B, LANES)
            freqs[tstep, r] = np.where(a, fq, 1).reshape(B, LANES)
            np.add.at(c[r], (bidx[a], rrf[a], yyf[a]), 1)
        if tstep in bounds:
            for r in range(2):
                carry[r] = (carry[r] >> 1) + c[r]
                c[r][:] = 0
                t[r] = build_cdf(_effective_counts(carry[r], prior[r]) + BLEND, 16)

    # backward interleaved rANS, batched over blocks
    x = np.full((B, LANES), 1 << 16, np.uint64)
    pair_all = np.zeros((steps * 2, B, LANES), np.uint16)
    mask_all = np.zeros((steps * 2, B, LANES), bool)
    for tstep in range(steps - 1, -1, -1):
        a = act[tstep]
        for r in (1, 0):
            fq = freqs[tstep, r].astype(np.uint64)
            st = starts[tstep, r].astype(np.uint64)
            over = a & (x >= (fq << 18))
            pair_all[tstep * 2 + r] = (x & 0xFFFF).astype(np.uint16)
            mask_all[tstep * 2 + r] = over
            x1 = np.where(over, x >> 16, x)
            x2 = ((x1 // fq) << CDF_SCALE_BITS) + (x1 % fq) + st
            x = np.where(a, x2, x)

    out = []
    for b in range(B):
        s = x[b].astype("<u4").view(np.uint8).tobytes()
        s += pair_all[:, b][mask_all[:, b]].astype(">u2").tobytes()
        out.append(s)
    return out


def compress(data: bytes, block_size: int = DEFAULT_BLOCK) -> bytes:
    nblocks = -(-len(data) // block_size) if data else 0
    blocks = [data[b * block_size : (b + 1) * block_size] for b in range(nblocks)]
    prior = np.zeros((2, ROWS, 16), np.int64)
    if nblocks:
        if len(data) >= PRIOR_MIN:
            sym, prev, prev2, act, _ = _layout(blocks)
            prior = build_prior(sym, prev, prev2, act)
        streams = encode_blocks(blocks, prior)
    else:
        streams = []
    out = bytearray()
    out += MAGIC
    out += bytes([VERSION, LANES])
    out += block_size.to_bytes(4, "big")
    out += len(data).to_bytes(8, "big")
    out += nblocks.to_bytes(4, "big")
    if len(data) >= PRIOR_MIN:
        # v4 priors are dense (4096 rows of u8 quantized counts): RLE
        # expands them ~1.5x; the repo's huff0 gets raw 128 KiB -> ~60 KiB
        from . import huff0

        enc = huff0.encode(prior.astype(np.uint8).tobytes())
        out += len(enc).to_bytes(4, "big")
        out += enc
    for s in streams:
        out += len(s).to_bytes(4, "big")
    for s in streams:
        out += s
    return bytes(out)


def stage_container(blob: bytes, mesh=None):
    """Parse an NLZC container and stage device inputs.

    -> (words, seg_dev, prior_dev, steps, seg, total_len, nblocks), with
    words/seg_dev optionally sharded over mesh's first axis. nblocks=0
    -> all device entries are None.

    mesh: optional jax.sharding.Mesh - block-shards the stream words and
    segment lengths over the mesh's first axis (data-parallel decode,
    the same SPMD axis as the LZ pipelines; blocks pad to the mesh).
    """
    import jax
    import jax.numpy as jnp

    if blob[:4] != MAGIC or blob[4] != VERSION or blob[5] != LANES:
        raise ValueError("not an NLZC v4 stream (bad magic/version/lanes)")
    block_size = int.from_bytes(blob[6:10], "big")
    total_len = int.from_bytes(blob[10:18], "big")
    nblocks = int.from_bytes(blob[18:22], "big")
    off = 22
    if total_len >= PRIOR_MIN:
        from . import huff0

        enc_n = int.from_bytes(blob[off : off + 4], "big")
        off += 4
        raw = huff0.decode(blob[off : off + enc_n])
        if len(raw) != 2 * ROWS * 16:
            raise ValueError("corrupt NLZC prior (bad huff0 payload size)")
        prior = (
            np.frombuffer(raw, np.uint8).astype(np.int64).reshape(2, ROWS, 16)
        )
        off += enc_n
    else:
        prior = np.zeros((2, ROWS, 16), np.int64)
    sizes = []
    for _ in range(nblocks):
        sizes.append(int.from_bytes(blob[off : off + 4], "big"))
        off += 4
    streams = []
    for sz in sizes:
        streams.append(blob[off : off + sz])
        off += sz
    if not nblocks:
        return None, None, None, 0, None, total_len, 0

    B = nblocks
    pad_B = B
    if mesh is not None:
        n_dev = int(np.prod([mesh.devices.size]))
        pad_B = -(-B // n_dev) * n_dev
    wmax = (max(len(s) for s in streams) + 3) // 4 + 2
    arr = np.zeros((pad_B, 4 * wmax), np.uint8)
    for b, s in enumerate(streams):
        arr[b, : len(s)] = np.frombuffer(s, np.uint8)
    a4 = arr.reshape(pad_B, wmax, 4).astype(np.uint32)
    words = jnp.asarray(
        a4[:, :, 0] | (a4[:, :, 1] << 8) | (a4[:, :, 2] << 16) | (a4[:, :, 3] << 24)
    )

    # per-block per-lane segment lengths (each block segments by its OWN
    # length, matching the encoder; the last block may be short)
    nb = np.minimum(
        np.full(B, block_size, np.int64), total_len - np.arange(B) * block_size
    )
    S_b = -(-nb // LANES)
    seg = np.clip(nb[:, None] - np.arange(LANES)[None, :] * S_b[:, None], 0, S_b[:, None])
    seg_pad = np.zeros((pad_B, LANES), np.int32)
    seg_pad[:B] = seg
    steps = padded_steps(int(S_b.max()), 1)
    seg_dev = jnp.asarray(seg_pad)
    prior_dev = jnp.asarray(prior, jnp.int32)
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec as P

        axis = mesh.axis_names[0]
        sh = NamedSharding(mesh, P(axis))
        words = jax.device_put(words, sh)
        seg_dev = jax.device_put(seg_dev, sh)
        prior_dev = jax.device_put(prior_dev, NamedSharding(mesh, P()))
    return words, seg_dev, prior_dev, steps, seg, total_len, nblocks


def decompress(blob: bytes, mesh=None) -> bytes:
    """Batched device decode of an NLZC container (see stage_container)."""
    words, seg_dev, prior_dev, steps, seg, total_len, B = stage_container(blob, mesh)
    if not B:
        return b""
    out = _decode_blocks(words, seg_dev, prior_dev, steps)
    out_np = np.asarray(out)[:B]  # [B, steps, LANES]

    res = bytearray()
    for b in range(B):
        segs = out_np[b].T  # [LANES, steps]
        for l in range(LANES):
            n = int(seg[b, l])
            res += segs[l, :n].astype(np.uint8).tobytes()
    return bytes(res[:total_len])


def _decode_blocks(words, seg_lens, prior, steps: int):
    """Device scan: decode all blocks' lanes in lockstep -> bytes
    [B, steps, LANES].

    Table lookups are f32 one-hot contractions (exact for fences
    <= 2^14 << 2^24) at Precision.HIGHEST; counts stay i32.
    """
    from functools import partial

    import jax
    import jax.numpy as jnp

    _I32 = jnp.int32
    _U32 = jnp.uint32
    f32 = jnp.float32
    # the f32 one-hot contractions carry exact 14-bit table values; the
    # DEFAULT matmul precision may run f32 operands through bf16 or TF32
    # (8 or 11 significant bits: fence 993 can read back as 992),
    # silently corrupting fences - PX is correctness here, not accuracy
    PX = jax.lax.Precision.HIGHEST
    B, W = words.shape
    L = LANES
    win_words = (2 * L * 2) // 4 + 2

    def build_jnp(carry, prior_r):
        """Mirror of build_cdf(_effective_counts(carry) + BLEND)."""
        gs = jnp.sum(carry.reshape(B, ROWS // GROUP, GROUP, 16), axis=2)
        gs = jnp.repeat(gs, GROUP, axis=1)
        eff = carry + gs // 2 + PRIOR_W * prior_r[None] + BLEND
        tot = jnp.sum(eff, axis=-1, keepdims=True)
        freq = 1 + (eff * (CDF_SCALE_TOTAL - 16)) // (tot + 1)
        fences = jnp.cumsum(freq, axis=-1)[..., :-1]
        return jnp.concatenate(
            [
                jnp.zeros(eff.shape[:-1] + (1,), _I32),
                fences,
                jnp.full(eff.shape[:-1] + (1,), CDF_SCALE_TOTAL, _I32),
            ],
            axis=-1,
        )

    widx = jnp.arange(win_words, dtype=_I32)

    def read_one(x, cursor, win, win_base, tables, counts, row, a):
        f = (x & jnp.asarray(0x3FFF, _U32)).astype(_I32)
        row_oh = jax.nn.one_hot(row, ROWS, dtype=f32)
        tbl = jnp.einsum(
            "blr,brw->blw", row_oh, tables.astype(f32), precision=PX
        ).astype(_I32)
        cmp = (f[:, :, None] >= tbl[:, :, 1:]).astype(_I32)
        dtbl = tbl[:, :, 1:] - tbl[:, :, :-1]
        y = jnp.sum(cmp, axis=2)
        start = jnp.sum(cmp * dtbl, axis=2)
        cmp1 = jnp.concatenate([jnp.ones((B, L, 1), _I32), cmp[:, :, :-1]], axis=2)
        y16 = cmp1 - cmp
        freq = jnp.sum(y16 * dtbl, axis=2)

        x2 = freq.astype(_U32) * (x >> CDF_SCALE_BITS) + (f - start).astype(_U32)
        renorm = a & (x2 < jnp.asarray(1 << 16, _U32))
        rank = jnp.cumsum(renorm.astype(_I32), axis=1) - renorm.astype(_I32)
        h = (cursor[:, None] + 2 * rank - win_base[:, None]) >> 1
        hsel = jax.nn.one_hot(jnp.clip(h, 0, 2 * win_words - 1), 2 * win_words, dtype=_I32)
        win16 = jnp.stack([win & jnp.asarray(0xFFFF, _U32), win >> 16], axis=2).reshape(
            B, 2 * win_words
        )
        pair_le = jnp.einsum("blw,bw->bl", hsel, win16.astype(_I32)).astype(_U32)
        pair = ((pair_le & jnp.asarray(0xFF, _U32)) << 8) | (pair_le >> 8)
        x3 = jnp.where(renorm, (x2 << 16) | pair, x2)
        x = jnp.where(a, x3, x)
        cursor = cursor + 2 * jnp.sum(renorm.astype(_I32), axis=1)

        y = jnp.where(a, y, 0)
        y16a = (y16 * a.astype(_I32)[:, :, None]).astype(f32)
        counts = counts + jnp.einsum(
            "blr,bls->brs", row_oh, y16a, precision=PX
        ).astype(_I32)
        return y, x, cursor, counts

    def step_body(carry, a):
        x, cursor, prev, prev2, th, tl, ch, cl = carry
        base = cursor >> 2
        win = jnp.take_along_axis(
            words, jnp.clip(base[:, None] + widx[None, :], 0, W - 1), axis=1
        )
        win_base = base << 2
        r0 = (prev << 4) | (prev2 >> 4)
        hi, x, cursor, ch = read_one(x, cursor, win, win_base, th, ch, r0, a)
        r1 = (hi << 8) | prev
        lo, x, cursor, cl = read_one(x, cursor, win, win_base, tl, cl, r1, a)
        byte = (hi << 4) | lo
        prev2 = jnp.where(a, prev, prev2)
        prev = jnp.where(a, byte, prev)
        return (x, cursor, prev, prev2, th, tl, ch, cl), byte

    def chunk_body(carry, xs):
        x, cursor, prev, prev2, th, tl, carry_h, carry_l = carry
        act = xs  # [clen, B, L]
        ch = jnp.zeros((B, ROWS, 16), _I32)
        cl = jnp.zeros((B, ROWS, 16), _I32)
        (x, cursor, prev, prev2, _, _, ch, cl), ys = jax.lax.scan(
            step_body, (x, cursor, prev, prev2, th, tl, ch, cl), act
        )
        carry_h = (carry_h >> 1) + ch
        carry_l = (carry_l >> 1) + cl
        return (
            x, cursor, prev, prev2,
            build_jnp(carry_h, prior[0]), build_jnp(carry_l, prior[1]),
            carry_h, carry_l,
        ), ys

    @partial(jax.jit, static_argnames=("steps",))
    def run(words_, seg_lens_, steps: int):
        t_iota = jnp.arange(steps, dtype=_I32)
        active_t = t_iota[:, None, None] < seg_lens_[None, :, :]
        seeds = words_[:, :L].astype(_U32)
        cursor0 = jnp.full((B,), 4 * L, _I32)
        prev0 = jnp.zeros((B, L), _I32)
        tables0 = jnp.broadcast_to(
            build_jnp(jnp.zeros((B, ROWS, 16), _I32), prior[0])[:1], (B, ROWS, 17)
        )
        tables0_l = jnp.broadcast_to(
            build_jnp(jnp.zeros((B, ROWS, 16), _I32), prior[1])[:1], (B, ROWS, 17)
        )
        carry = (
            seeds, cursor0, prev0, prev0, tables0, tables0_l,
            jnp.zeros((B, ROWS, 16), _I32), jnp.zeros((B, ROWS, 16), _I32),
        )
        schedule = chunk_schedule(steps)
        runs = []
        for clen in schedule:
            if runs and runs[-1][0] == clen:
                runs[-1][1] += 1
            else:
                runs.append([clen, 1])
        parts = []
        t0 = 0
        for clen, count in runs:
            act = active_t[t0 : t0 + clen * count].reshape(count, clen, B, L)
            carry, ys = jax.lax.scan(chunk_body, carry, act)
            parts.append(ys.reshape(count * clen, B, L))
            t0 += clen * count
        return jnp.concatenate(parts, axis=0).transpose(1, 0, 2)  # [B, steps, L]

    return run(words, seg_lens, steps)
