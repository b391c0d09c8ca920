"""Batched device encoder: block-parallel greedy LZ + model emission + rANS.

Pipeline (all [B]-batched; B independent blocks encode in lockstep):

  E1 find_matches   sort-based nearest-previous-occurrence candidates
                    (argsort groups equal 4-byte hashes; adjacency gives the
                    most recent prior position) + word-compare length
                    extension to 64 bytes, byte-exact.
  E2 greedy_cover   scan over command slots: at the write head take the
                    verified match if long enough, else a literal; emits the
                    same step-aligned (len, val) command format the decoder
                    produces.
  E3 emit_model     scan over commands mirroring the decoder's model: CDF
                    spans (start, freq) + raw-bit fields per command, with
                    one-hot family adaptation (no scatters).
  E4 rans_backward  reverse scan: 4-lane interleaved rANS over the span
                    list, renorm pairs compacted on device; bit stream
                    packed forward and compacted on device.

The host then wraps per-block sections into standard NLZM frames (one frame
per block; block_size <= frame chunk capacity), so archives decode with the
serial/native/device decoders and the reference binary's wire format.

Between E2 and E3 a `repify` pass replays the decoder's rep-distance table
over the command stream and converts matches whose distance is live in the
table into rep commands (cmd=2 + 2 raw index bits instead of distance
slots + extra bits) - the wire-cheaper encoding of the same match
(NLZM.cpp:1598-1628 gets reps from the parser; here they are recovered
from the greedy cover by table replay).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CDF_SCALE_TOTAL, HASH4_MULT
from .cdf_ops import mixin_tensor
from .decode_v2 import _uniform_cells  # family cell layout reuse

_U32 = jnp.uint32
_I32 = jnp.int32

MAX_MLEN = 264  # reference MATCH_MAX (NLZM.cpp:737)
# dp_parse relaxes every length 1..64 densely, then samples longer
# lengths like the reference's tstep sampling (NLZM.cpp:1558-1560)
DP_LENS = tuple(range(1, 65)) + (72, 80, 96, 112, 128, 160, 192, 224, 264)


# ---------------------------------------------------------------- E1
def _extend_matches(wordp, cand, ok, n_valid, pos, N):
    """Byte-exact match length (<= MAX_MLEN) for candidate positions.

    wordp: [B, N + MAX_MLEN + 4] little-endian 4-byte words per position.
    """
    B = wordp.shape[0]
    full = jnp.zeros((B, N), _I32)  # count of fully-equal leading words
    alive = ok
    mism = jnp.zeros((B, N), _U32)  # first mismatching xor
    csafe = jnp.maximum(cand, 0)
    for k in range(MAX_MLEN // 4):
        off = 4 * k
        a = wordp[:, off : off + N]
        b = jnp.take_along_axis(wordp, jnp.minimum(csafe + off, N + MAX_MLEN), axis=1)
        x = a ^ b
        eq = alive & (x == 0)
        full = full + eq.astype(_I32)
        mism = jnp.where(alive & ~eq & (mism == 0) & (x != 0), x, mism)
        alive = eq

    # trailing bytes within the first mismatching word
    tz = jnp.where(
        (mism & 0xFF) != 0,
        0,
        jnp.where((mism & 0xFFFF) != 0, 1, jnp.where((mism & 0xFFFFFF) != 0, 2, 3)),
    )
    mlen = full * 4 + jnp.where(mism == 0, 0, tz)
    mlen = jnp.minimum(mlen, MAX_MLEN)
    # stay inside the block's valid bytes
    limit = jnp.maximum(n_valid[:, None] - pos, 0)
    return jnp.minimum(mlen, limit)


@partial(jax.jit, static_argnames=("reach", "num_cands"))
def find_matches(data: jax.Array, n_valid: jax.Array, reach: int, num_cands: int = 1):
    """Previous occurrences of each position's 4-byte prefix.

    data: [B, N] uint8 (zero padded past n_valid).
    Sort-based: argsort groups equal 16-bit hashes with positions ascending;
    the k-th previous entry in sort order is the k-th most recent prior
    occurrence. Lengths are verified byte-exact (hash collisions yield short
    or zero lengths, never wrong matches).

    Returns (delta [B, N, C] i32 (0 = none), mlen [B, N, C] i32 <= 64),
    squeezed to [B, N] when num_cands == 1.
    """
    B, N = data.shape
    d = data.astype(_U32)
    # little-endian 4-byte words at every position (pad tail with zeros)
    pad = jnp.zeros((B, 4), _U32)
    dp = jnp.concatenate([d, pad], axis=1)
    word = dp[:, :N] | (dp[:, 1 : N + 1] << 8) | (dp[:, 2 : N + 2] << 16) | (dp[:, 3 : N + 3] << 24)

    h = ((word * HASH4_MULT) & jnp.asarray(0xFFFFFFFF, _U32)) >> 16  # 16-bit hash
    pos = jnp.broadcast_to(jnp.arange(N, dtype=_I32), (B, N))
    # sort by (hash, position): equal hashes adjacent, positions ascending.
    # 16-bit hash * N overflows i32 for N > 32768 (65535*32768+32767 is
    # exactly INT32_MAX); big blocks switch to a 2-operand lexicographic
    # sort ((h, pos) both keys, ~1.8x per element) - same grouping, no
    # packing budget, blocks to the format's 128 KiB cap.
    if N <= 32768:
        key = h.astype(_I32) * N + pos
        order = jnp.argsort(key, axis=1)
        h_s = jnp.take_along_axis(h, order, axis=1)
    else:
        h_s, order = jax.lax.sort(
            (h.astype(_I32), pos), dimension=1, num_keys=2, is_stable=False
        )
    barange = jnp.arange(B)[:, None]
    wordp = jnp.concatenate([word, jnp.zeros((B, MAX_MLEN + 4), _U32)], axis=1)

    deltas, mlens = [], []
    for k in range(1, num_cands + 1):
        same = jnp.concatenate(
            [jnp.zeros((B, k), bool), h_s[:, k:] == h_s[:, :-k]], axis=1
        )
        prev_pos = jnp.concatenate(
            [jnp.zeros((B, k), _I32), order[:, :-k]], axis=1
        )
        cand_sorted = jnp.where(same, prev_pos, -1)
        # scatter candidates back to position order
        cand = jnp.zeros((B, N), _I32).at[barange, order].set(cand_sorted)
        delta = pos - cand
        ok = (cand >= 0) & (delta > 0) & (delta <= reach)
        delta = jnp.where(ok, delta, 0)
        mlen = _extend_matches(wordp, cand, ok, n_valid, pos, N)
        deltas.append(delta)
        mlens.append(mlen)

    if num_cands == 1:
        return deltas[0], mlens[0]
    return jnp.stack(deltas, axis=2), jnp.stack(mlens, axis=2)


# ---------------------------------------------------------------- E2
@partial(jax.jit, static_argnames=("num_steps",))
def greedy_cover(data: jax.Array, delta: jax.Array, mlen: jax.Array, n_valid: jax.Array, num_steps: int):
    """Greedy parse: one command per step per block.

    Returns (op_len [T, B], op_val [T, B]) in the decoder's ys format
    (-1 past end, 0 literal, else match length with op_val = distance).
    """
    B, N = data.shape
    data_i = data.astype(_I32)

    def step(pos, _):
        at = jnp.clip(pos, 0, N - 1)[:, None]
        d = jnp.take_along_axis(delta, at, axis=1)[:, 0]
        l = jnp.take_along_axis(mlen, at, axis=1)[:, 0]
        byte = jnp.take_along_axis(data_i, at, axis=1)[:, 0]
        mmin = (
            2
            + (d > 0xFF).astype(_I32)
            + (d > 0xFFF).astype(_I32)
            + (d > 0xFFFFF).astype(_I32)
        )
        active = pos < n_valid
        use = active & (d > 0) & (l >= mmin)
        length = jnp.where(use, l, 0)
        val = jnp.where(use, d, byte)
        out_len = jnp.where(active, length, -1)
        pos = pos + jnp.where(active, jnp.maximum(length, 1), 0)
        return pos, (out_len, val)

    pos, ys = jax.lax.scan(step, jnp.zeros((B,), _I32), None, length=num_steps)
    return ys


# ---------------------------------------------------------------- E2-opt
# Static approximate bit costs for the DP parse, in 1/16-bit fixed point.
# The reference prices edges with its live adaptive model (NLZM.cpp:
# 1208-1272); a batched DP cannot thread that state across positions, so
# these are calibrated static estimates of the adapted model's costs.
_C_LIT = 6 * 16  # literal: cmd + two nibble CDFs
_C_CMD_M = 2 * 16  # match command symbol
_C_LEN_BASE = 2 * 16  # direct length symbol (lv < 7)
_C_LEN_SLOPE = 4  # mild preference for shorter lv
_C_LEN_ESC = 11 * 16  # escape + two extension nibbles
_C_DIST_SLOT = 5 * 16 + 8  # two distance-slot CDFs
_DP_BIG = 1 << 28


def default_dp_costs():
    """[LIT, CMD_M, LEN_BASE, LEN_SLOPE, LEN_ESC, DIST_SLOT] in 1/16 bit."""
    return jnp.asarray(
        [_C_LIT, _C_CMD_M, _C_LEN_BASE, _C_LEN_SLOPE, _C_LEN_ESC, _C_DIST_SLOT], _I32
    )


@partial(jax.jit, static_argnames=("max_len",))
def dp_parse(
    delta: jax.Array,
    mlen: jax.Array,
    n_valid: jax.Array,
    costs: jax.Array | None = None,
    max_len: int = MAX_MLEN,
):
    """Approximate-cost shortest-path parse (batched backward DP).

    delta/mlen: [B, N, C] candidate distances/verified lengths (C per
    position). A backward scan carries a sliding window win[:, j] =
    cost[i+1+j] of the next max_len positions, relaxes the literal edge and
    every (candidate, length) match edge with static model costs, and
    records the local choice; a forward cover then follows the choices.
    This is the reference parser's graph relaxation (NLZM.cpp:1464-1651)
    restructured so every position's relaxation is dense vector math.

    Returns (choice_len [B, N] i32 (0 = literal), choice_cand [B, N] i32).
    """
    B, N, C = delta.shape
    if costs is None:
        costs = default_dp_costs()
    if costs.ndim == 1:
        costs = jnp.broadcast_to(costs, (B, 6))
    c_lit, c_cmd_m, c_len_base, c_len_slope, c_len_esc, c_dist_slot = (
        costs[:, 0], costs[:, 1], costs[:, 2], costs[:, 3], costs[:, 4], costs[:, 5]
    )  # each [B]
    lens = jnp.asarray([l for l in DP_LENS if l <= max_len], dtype=_I32)  # [L]

    def step(win, xs):
        d_t, l_t, i = xs  # [B, C], [B, C], scalar index
        active = i < n_valid  # [B]

        dv = jnp.maximum(d_t, 1) - 1
        nbits = 32 - jnp.clip(
            jax.lax.clz(jnp.maximum(dv, 1).astype(_U32)).astype(_I32), 0, 31
        )
        ab = jnp.where(dv >= 4, nbits - 2, 0)
        dist_c = (c_cmd_m + c_dist_slot)[:, None] + ab * 16  # [B, C]

        mmin = (
            2
            + (d_t > 0xFF).astype(_I32)
            + (d_t > 0xFFF).astype(_I32)
            + (d_t > 0xFFFFF).astype(_I32)
        )
        lv = lens[None, :, None] - mmin[:, None, :]  # [B, L, C]
        len_c = jnp.where(
            lv < 7,
            c_len_base[:, None, None] + jnp.maximum(lv, 0) * c_len_slope[:, None, None],
            c_len_esc[:, None, None],
        )
        tot = dist_c[:, None, :] + len_c + win[:, lens - 1, None]  # [B, L, C]
        valid = (
            (lv >= 0)
            & (lens[None, :, None] <= l_t[:, None, :])
            & (d_t[:, None, :] > 0)
        )
        tot = jnp.where(valid, tot, _DP_BIG)

        flat = tot.reshape(B, lens.shape[0] * C)
        am = jnp.argmin(flat, axis=1)
        mc = jnp.take_along_axis(flat, am[:, None], axis=1)[:, 0]
        best_len = lens[am // C]
        best_cand = am % C

        lit_c = c_lit + win[:, 0]  # both [B]
        use_match = mc < lit_c
        c = jnp.where(use_match, mc, lit_c)
        c = jnp.where(active, c, 0)
        choice_len = jnp.where(active & use_match, best_len, 0)
        win = jnp.concatenate([c[:, None], win[:, :-1]], axis=1)
        return win, (choice_len, best_cand.astype(_I32))

    win0 = jnp.zeros((B, max_len), _I32)
    xs = (
        delta.transpose(1, 0, 2),
        mlen.transpose(1, 0, 2),
        jnp.arange(N, dtype=_I32),
    )
    _, (choice_len, choice_cand) = jax.lax.scan(step, win0, xs, reverse=True)
    return choice_len.T, choice_cand.T


@partial(jax.jit, static_argnames=("num_steps",))
def dp_cover(
    data: jax.Array,
    delta: jax.Array,
    choice_len: jax.Array,
    choice_cand: jax.Array,
    n_valid: jax.Array,
    num_steps: int,
):
    """Follow the DP choices: one command per step per block (decoder's ys
    format, like greedy_cover)."""
    B, N, C = delta.shape
    data_i = data.astype(_I32)

    def step(pos, _):
        at = jnp.clip(pos, 0, N - 1)[:, None]
        l = jnp.take_along_axis(choice_len, at, axis=1)[:, 0]
        cand = jnp.take_along_axis(choice_cand, at, axis=1)[:, 0]
        cand_oh = jax.nn.one_hot(cand, C, dtype=_I32)
        d_all = jnp.take_along_axis(delta, at[:, :, None], axis=1)[:, 0, :]
        d = jnp.sum(cand_oh * d_all, axis=1)
        byte = jnp.take_along_axis(data_i, at, axis=1)[:, 0]
        active = pos < n_valid
        use = active & (l > 0)
        out_len = jnp.where(active, jnp.where(use, l, 0), -1)
        val = jnp.where(use, d, byte)
        pos = pos + jnp.where(active, jnp.maximum(l, 1), 0)
        return pos, (out_len, val)

    _, ys = jax.lax.scan(step, jnp.zeros((B,), _I32), None, length=num_steps)
    return ys


@jax.jit
def measure_costs(spans, op_len, op_val, op_rep):
    """Per-block empirical DP costs from an emitted command stream.

    The reference prices parse edges with its live adaptive model
    (NLZM.cpp:1208-1272). The batched equivalent is a second pass: measure
    each block's realized average cost per command family from pass 1's
    spans (exact -log2(freq/2^14) of every coded symbol) and feed them back
    into dp_parse as [B, 6] cost rows.
    """
    T, B, _ = spans.shape
    freq = (spans >> 16).astype(jnp.float32)
    bits16 = jnp.where(
        spans != 0, (14.0 - jnp.log2(jnp.maximum(freq, 1.0))) * 16.0, 0.0
    )  # [T, B, 6] in 1/16 bit

    is_lit = op_len == 0
    is_match = op_len > 0
    is_dict = is_match & (op_rep < 0)
    delta = jnp.maximum(op_val, 1)
    mmin = (
        2
        + (delta > 0xFF).astype(_I32)
        + (delta > 0xFFF).astype(_I32)
        + (delta > 0xFFFFF).astype(_I32)
    )
    esc = is_match & ((op_len - mmin) >= 7)

    def avg(total, mask, fallback):
        cnt = jnp.sum(mask.astype(jnp.float32), axis=0)
        s = jnp.sum(total * mask.astype(jnp.float32), axis=0)
        return jnp.where(cnt > 4, s / jnp.maximum(cnt, 1.0), float(fallback))

    lit_cost = avg(jnp.sum(bits16[:, :, 0:3], axis=2), is_lit, _C_LIT)
    cmd_m = avg(bits16[:, :, 0], is_match, _C_CMD_M)
    len_base = avg(bits16[:, :, 1], is_match & ~esc, _C_LEN_BASE)
    len_esc = avg(jnp.sum(bits16[:, :, 1:4], axis=2), esc, _C_LEN_ESC)
    dist_slot = avg(
        jnp.sum(bits16[:, :, 4:6], axis=2), is_dict, _C_DIST_SLOT
    )
    slope = jnp.full((B,), float(_C_LEN_SLOPE), jnp.float32)
    costs = jnp.stack([lit_cost, cmd_m, len_base, slope, len_esc, dist_slot], axis=1)
    return jnp.round(costs).astype(_I32)


# ---------------------------------------------------------------- E2b
@jax.jit
def repify(op_len: jax.Array, op_val: jax.Array):
    """Classify matches against the decoder's rep-distance table.

    Mirrors decode_v2's rep_tab semantics (NLZM.cpp:1154-1181): a match
    whose distance is live in the 4-slot table becomes a rep command
    (cmd=2, 2 raw index bits, no distance slots/extras) - strictly cheaper
    on the wire; a fresh distance stays a dict command and MTF-inserts.

    Returns op_rep [T, B] i32: -1 = not a rep, else slot index 0..3.
    """
    T, B = op_len.shape
    tab0 = jnp.broadcast_to(jnp.arange(1, 5, dtype=_I32), (B, 4))

    def step(tab, xs):
        L, V = xs
        is_match = L > 0
        eq = tab == V[:, None]  # [B, 4]
        present = is_match & jnp.any(eq, axis=1)
        idx = jnp.argmax(eq, axis=1).astype(_I32)
        op_rep = jnp.where(present, idx, -1)
        insert = is_match & ~present
        shifted = jnp.concatenate([V[:, None], tab[:, :3]], axis=1)
        tab = jnp.where(insert[:, None], shifted, tab)
        return tab, op_rep

    _, op_rep = jax.lax.scan(step, tab0, (op_len, op_val))
    return op_rep


# ---------------------------------------------------------------- E3
class _EmitState(NamedTuple):
    cmd_c: jax.Array
    lith_c: jax.Array
    litl_c: jax.Array
    lend_c: jax.Array
    lehi_c: jax.Array
    lelo_c: jax.Array
    dhi_c: jax.Array
    dlo_c: jax.Array
    nops: jax.Array  # [B] coded-item count (header num_ops)


def _fam_init(B, n, *shape):
    cells = jnp.asarray(_uniform_cells(n))
    return jnp.broadcast_to(cells, (B, *shape, 17)).astype(_I32)


def _span_of(row, y):
    y_oh = jax.nn.one_hot(y, 17, dtype=_I32)
    y1_oh = jax.nn.one_hot(y + 1, 17, dtype=_I32)
    start = jnp.sum(y_oh * row, axis=1)
    freq = jnp.sum(y1_oh * row, axis=1) - start
    return (freq.astype(_U32) << 16) | start.astype(_U32)


def _adapt(row, y, mix):
    m = mix[jnp.clip(y, 0, 15)]
    return row + ((m - row) >> 7)


def _fam_row(fam, idx, k):
    oh = jax.nn.one_hot(idx, k, dtype=fam.dtype)
    return jnp.einsum("bk,bkw->bw", oh, fam)


def _fam_set(fam, idx, new_row, old_row, pred, k):
    oh = jax.nn.one_hot(idx, k, dtype=_I32) * pred.astype(_I32)[:, None]
    return fam + oh[:, :, None] * (new_row - old_row)[:, None, :]


@partial(jax.jit, static_argnames=())
def emit_model(op_len: jax.Array, op_val: jax.Array, op_rep: jax.Array):
    """Model pass over step-aligned commands.

    op_rep [T, B]: -1 = literal/dict, else 0..3 rep slot (op_val still
    holds the actual distance for the length-min computation).

    Returns per (step, block): spans [T, B, 6] u32 ((freq<<16)|start, 0 =
    unused slot), bits_val [T, B], bits_nb [T, B], and num_ops [B].
    """
    T, B = op_len.shape
    mixin = jnp.asarray(mixin_tensor())
    mix4, mix8, mix16 = mixin[0], mixin[1], mixin[2]

    st = _EmitState(
        cmd_c=_fam_init(B, 4),
        lith_c=_fam_init(B, 16),
        litl_c=_fam_init(B, 16, 16),
        lend_c=_fam_init(B, 8),
        lehi_c=_fam_init(B, 16),
        lelo_c=_fam_init(B, 16, 16),
        dhi_c=_fam_init(B, 8, 4),
        dlo_c=_fam_init(B, 8, 32),
        nops=jnp.zeros((B,), _I32),
    )

    def step(s: _EmitState, xs):
        L, V, R = xs
        active = L >= 0
        is_lit = active & (L == 0)
        is_match = active & (L > 0)
        is_rep = is_match & (R >= 0)
        is_dict = is_match & (R < 0)

        delta = jnp.maximum(V, 1)
        mmin = (
            2
            + (delta > 0xFF).astype(_I32)
            + (delta > 0xFFF).astype(_I32)
            + (delta > 0xFFFFF).astype(_I32)
        )
        lv = jnp.maximum(L - mmin, 0)
        lc = jnp.minimum(lv, 3)
        esc = is_match & (lv >= 7)
        lv_sym = jnp.minimum(lv, 7)
        ext = jnp.maximum(lv - 7, 0)
        ehi, elo = ext >> 4, ext & 15

        hi_nib = jnp.where(is_lit, V >> 4, 0)
        lo_nib = V & 15

        # distance slot + extra bits
        dv = delta - 1
        nbits = jnp.clip(
            32 - jnp.clip(jax.lax.clz(jnp.maximum(dv, 1).astype(_U32)).astype(_I32), 0, 31),
            1,
            31,
        )  # bit length of dv
        big = dv >= 4
        ab = jnp.where(big, nbits - 2, 0)
        top = dv >> jnp.maximum(ab, 0)
        slot = jnp.where(big, ((nbits - 1) << 1) + (top & 1), dv)
        extra = dv & ((1 << jnp.maximum(ab, 0)) - 1)
        dhi, dlo = slot >> 3, slot & 7

        # slot 0: command (0 literal / 1 dict / 2 rep)
        cmd_y = jnp.where(is_lit, 0, jnp.where(is_rep, 2, 1))
        r = s.cmd_c
        sp0 = jnp.where(active, _span_of(r, cmd_y), 0)
        s_cmd = jnp.where(active[:, None], _adapt(r, cmd_y, mix4), r)

        # slot 1: lit_hi | len_direct
        r_lh = s.lith_c
        r_ld = s.lend_c
        row1 = jnp.where(is_lit[:, None], r_lh, r_ld)
        y1 = jnp.where(is_lit, hi_nib, lv_sym)
        sp1 = jnp.where(active, _span_of(row1, y1), 0)
        mix1 = jnp.where(is_lit[:, None], mix16[jnp.clip(y1, 0, 15)], mix8[jnp.clip(y1, 0, 7)])
        upd1 = row1 + ((mix1 - row1) >> 7)
        s_lith = jnp.where(is_lit[:, None], upd1, r_lh)
        s_lend = jnp.where(is_match[:, None], upd1, r_ld)

        # slot 2: lit_lo | len_ext_hi
        pred2 = is_lit | esc
        litl_row = _fam_row(s.litl_c, jnp.where(is_lit, hi_nib, 0), 16)
        row2 = jnp.where(is_lit[:, None], litl_row, s.lehi_c)
        y2 = jnp.where(is_lit, lo_nib, ehi)
        sp2 = jnp.where(pred2, _span_of(row2, y2), 0)
        upd2 = row2 + ((mix16[jnp.clip(y2, 0, 15)] - row2) >> 7)
        s_litl = _fam_set(s.litl_c, hi_nib, upd2, litl_row, is_lit, 16)
        s_lehi = jnp.where(esc[:, None], upd2, s.lehi_c)

        # slot 3: len_ext_lo
        lelo_row = _fam_row(s.lelo_c, jnp.where(esc, ehi, 0), 16)
        sp3 = jnp.where(esc, _span_of(lelo_row, elo), 0)
        upd3 = lelo_row + ((mix16[jnp.clip(elo, 0, 15)] - lelo_row) >> 7)
        s_lelo = _fam_set(s.lelo_c, ehi, upd3, lelo_row, esc, 16)

        # slot 4: dist hi (dict only; rep distances ride the rep table)
        dhi_row = _fam_row(s.dhi_c, jnp.where(is_dict, lc, 0), 4)
        sp4 = jnp.where(is_dict, _span_of(dhi_row, dhi), 0)
        upd4 = dhi_row + ((mix8[jnp.clip(dhi, 0, 7)] - dhi_row) >> 7)
        s_dhi = _fam_set(s.dhi_c, lc, upd4, dhi_row, is_dict, 4)

        # slot 5: dist lo
        dlo_idx = jnp.where(is_dict, (lc << 3) + dhi, 0)
        dlo_row = _fam_row(s.dlo_c, dlo_idx, 32)
        sp5 = jnp.where(is_dict, _span_of(dlo_row, dlo), 0)
        upd5 = dlo_row + ((mix8[jnp.clip(dlo, 0, 7)] - dlo_row) >> 7)
        s_dlo = _fam_set(s.dlo_c, dlo_idx, upd5, dlo_row, is_dict, 32)

        # raw-bit fields. Rep: a single 2-bit slot-index field (read by the
        # decoder before any other bit field in the command). Dict: extra
        # distance bits split into a high field (ab-4 bits, only when
        # ab > 4) and a low field (min(ab, 4) bits) for staging capacity.
        has_bits = is_dict & (ab > 0)
        nb_a = jnp.where(
            is_rep, 2, jnp.where(has_bits & (ab > 4), ab - 4, 0)
        )
        va = jnp.where(is_rep, R, jnp.where(nb_a > 0, extra >> 4, 0))
        nb_b = jnp.where(has_bits, jnp.minimum(ab, 4), 0)
        vb = jnp.where(has_bits, extra & ((1 << nb_b) - 1), 0)

        n_spans = (
            active.astype(_I32)
            + active.astype(_I32)  # slot1 always coded when active
            + pred2.astype(_I32)
            + esc.astype(_I32)
            + is_dict.astype(_I32) * 2
        )
        n_bit_ops = jnp.where(
            is_rep, 1, jnp.where(has_bits, 1 + (ab > 4).astype(_I32), 0)
        )
        nops = s.nops + n_spans + n_bit_ops

        spans = jnp.stack([sp0, sp1, sp2, sp3, sp4, sp5], axis=1)  # [B, 6]
        new = _EmitState(
            cmd_c=s_cmd, lith_c=s_lith, litl_c=s_litl, lend_c=s_lend,
            lehi_c=s_lehi, lelo_c=s_lelo, dhi_c=s_dhi, dlo_c=s_dlo, nops=nops,
        )
        return new, (spans, va, nb_a, vb, nb_b)

    st, ys = jax.lax.scan(step, st, (op_len, op_val, op_rep))
    spans, va, nb_a, vb, nb_b = ys
    return spans, (va, nb_a, vb, nb_b), st.nops


# ---------------------------------------------------------------- E4
@partial(jax.jit, static_argnames=("cap",))
def rans_backward(spans: jax.Array, cap: int):
    """4-lane interleaved rANS over the span stream, backward.

    spans: [T, B, 6] u32 ((freq<<16)|start; 0 = unused).
    Returns (stream [B, cap] u8 - 16 seed bytes then renorm pairs in decode
    order, rans_bytes [B] total length).
    """
    T, B, _ = spans.shape
    total = jnp.sum((spans != 0).astype(_I32), axis=(0, 2))  # [B] span count

    def step(carry, sp_t):
        states, cnt, pairs_acc = carry  # states [B,4] u32, cnt [B]
        outs = []
        flags = []
        for slot in range(5, -1, -1):
            sf = sp_t[:, slot]
            valid = sf != 0
            freq = (sf >> 16).astype(_U32)
            start = (sf & jnp.asarray(0xFFFF, _U32)).astype(_U32)
            cnt = cnt - valid.astype(_I32)
            lane = jnp.clip(cnt, 0, 1 << 30) & 3
            lane_oh = jax.nn.one_hot(lane, 4, dtype=_I32)
            x = jnp.sum(lane_oh * states.astype(_I32), axis=1).astype(_U32)

            fq = jnp.maximum(freq, 1)
            over = valid & (x >= (fq << 18))
            pair = (x & jnp.asarray(0xFFFF, _U32)).astype(_U32)
            x1 = jnp.where(over, x >> 16, x)
            x2 = ((x1 // fq) << 14) + (x1 % fq) + start
            x2 = jnp.where(valid, x2, x)
            states = jnp.where(
                valid[:, None] & (lane_oh > 0), x2[:, None], states.astype(_U32)
            ).astype(_U32)
            outs.append(jnp.where(over, pair, 0))
            flags.append(over)
        return (states, cnt, pairs_acc), (jnp.stack(outs, 1), jnp.stack(flags, 1))

    states0 = jnp.full((B, 4), 1 << 16, _U32)
    (states, cnt, _), (pairs, flags) = jax.lax.scan(
        step, (states0, total, None), spans, reverse=True
    )
    # pairs/flags: [T, B, 6] in scan-forward order; emission order was
    # (t desc, slot desc) and the forward stream is its reverse: (t asc,
    # slot asc) after seeds. flags order in stacked arrays: index s=0..5
    # corresponds to slot 5..0 - reverse the slot axis for forward order.
    pairs = pairs[:, :, ::-1]
    flags = flags[:, :, ::-1]

    fl = flags.transpose(1, 0, 2).reshape(B, T * 6)  # [B, K] forward order
    pr = pairs.transpose(1, 0, 2).reshape(B, T * 6)
    offs = jnp.cumsum(fl.astype(_I32), axis=1) - fl.astype(_I32)
    byte_off = 16 + 2 * offs
    barange = jnp.arange(B)[:, None]

    stream = jnp.zeros((B, cap), jnp.uint8)
    # 16 seed bytes: 4 states little-endian, lane 0 first
    for lane in range(4):
        for k in range(4):
            stream = stream.at[:, 4 * lane + k].set(
                ((states[:, lane] >> (8 * k)) & jnp.asarray(0xFF, _U32)).astype(jnp.uint8)
            )
    hi = (pr >> 8).astype(jnp.uint8)
    lo = (pr & jnp.asarray(0xFF, _U32)).astype(jnp.uint8)
    dst_hi = jnp.where(fl, byte_off, cap)
    dst_lo = jnp.where(fl, byte_off + 1, cap)
    stream = stream.at[barange, dst_hi].set(hi, mode="drop")
    stream = stream.at[barange, dst_lo].set(lo, mode="drop")
    rans_bytes = 16 + 2 * jnp.sum(fl.astype(_I32), axis=1)
    return stream, rans_bytes


@partial(jax.jit, static_argnames=("cap",))
def bits_forward(fields, cap: int):
    """Pack raw-bit fields MSB-first into the frame's bit section.

    fields: (va, nb_a, vb, nb_b), each [T, B] - two fields per command.
    Returns (bytes_out [B, cap] u8 including the 4 drain bytes, n_bytes [B]).
    """
    va, nb_a, vb, nb_b = fields
    T, B = nb_a.shape
    barange = jnp.arange(B)

    def put(word, wbits, nbytes, out, v, nb):
        nb = jnp.clip(nb, 0, 24)
        v = v.astype(_U32) & ((jnp.asarray(1, _U32) << nb.astype(_U32)) - 1)
        word = word | jnp.where(
            nb > 0, v << jnp.clip(32 - wbits - nb, 0, 31).astype(_U32), 0
        )
        wbits = wbits + nb
        for _ in range(3):  # wbits <= 7+24 = 31 -> at most 3 whole bytes
            can = wbits >= 8
            byte = (word >> 24).astype(jnp.uint8)
            dst = jnp.where(can, nbytes, cap)
            out = out.at[barange, dst].set(byte, mode="drop")
            word = jnp.where(can, word << 8, word)
            wbits = jnp.where(can, wbits - 8, wbits)
            nbytes = nbytes + can.astype(_I32)
        return word, wbits, nbytes, out

    def step(carry, xs):
        word, wbits, nbytes, out = carry
        a, na, b, nb = xs
        word, wbits, nbytes, out = put(word, wbits, nbytes, out, a, na)
        word, wbits, nbytes, out = put(word, wbits, nbytes, out, b, nb)
        return (word, wbits, nbytes, out), None

    out0 = jnp.zeros((B, cap), jnp.uint8)
    (word, wbits, nbytes, out), _ = jax.lax.scan(
        step,
        (jnp.zeros((B,), _U32), jnp.zeros((B,), _I32), jnp.zeros((B,), _I32), out0),
        (va, nb_a, vb, nb_b),
    )
    # 4 drain bytes
    for k in range(4):
        byte = (word >> 24).astype(jnp.uint8)
        out = out.at[barange, jnp.minimum(nbytes, cap - 1)].set(byte)
        word = word << 8
        nbytes = nbytes + 1
    return out, nbytes


# ---------------------------------------------------------------- driver
def _calibrated_parse(dj, nv, reach: int, num_steps: int):
    """Optimal device parse: 2-candidate matching + iterated per-block
    cost calibration (converges by pass 3: realized model costs feed the
    next parse, like the reference's live-model edge pricing but
    batched)."""
    delta, mlen = find_matches(dj, nv, reach, num_cands=3)
    costs = None
    for i in range(3):
        choice_len, choice_cand = dp_parse(delta, mlen, nv, costs)
        op_len, op_val = dp_cover(dj, delta, choice_len, choice_cand, nv, num_steps)
        if i < 2:
            op_rep = repify(op_len, op_val)
            spans, _, _ = emit_model(op_len, op_val, op_rep)
            costs = measure_costs(spans, op_len, op_val, op_rep)
    return op_len, op_val


def encode_pipeline(
    dj, nv, reach: int, num_steps: int, rans_cap: int, bits_cap: int, parser: str = "greedy"
):
    """Full device-side encode: blocks in, frame sections out (jittable)."""
    if parser == "optimal":
        op_len, op_val = _calibrated_parse(dj, nv, reach, num_steps)
    else:
        delta, mlen = find_matches(dj, nv, reach)
        op_len, op_val = greedy_cover(dj, delta, mlen, nv, num_steps)
    op_rep = repify(op_len, op_val)
    spans, fields, nops = emit_model(op_len, op_val, op_rep)
    stream, rans_bytes = rans_backward(spans, rans_cap)
    bits_bytes, bits_n = bits_forward(fields, bits_cap)
    ncmds = jnp.sum((op_len >= 0).astype(_I32), axis=0)
    return stream, rans_bytes, bits_bytes, bits_n, nops, ncmds


def _blocks_arrays(data: bytes, block_size: int):
    """Split bytes into [nblocks, N] zero-padded array + valid counts."""
    n = len(data)
    N = block_size
    nblocks = (n + N - 1) // N
    arr = np.zeros((nblocks, N), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for b in range(nblocks):
        seg = flat[b * N : (b + 1) * N]
        arr[b, : len(seg)] = seg
    n_valid = np.minimum(
        np.full(nblocks, N, np.int64), n - np.arange(nblocks) * N
    ).astype(np.int32)
    return arr, n_valid


def lift_deep_matches(op_len, op_val, cap: int = 15):
    """Bound every byte's literal-ancestor depth by rewriting deep matches.

    Any byte p inside a match command C at distance d_C satisfies
    out[p] == out[p - d_C] (that is the decode semantics, including
    self-overlap). So when a match's source span lies entirely inside one
    earlier command, adding that command's distance yields another valid
    encoding of the same bytes whose ancestors sit one command earlier.
    Matches whose chain depth would exceed `cap` are lifted until the
    depth fits (or the span straddles a command boundary). Bounded depth
    means the decoder's pointer-doubling expansion converges in
    ceil(log2(cap))+1 rounds - the decoder itself is unchanged.

    op_len/op_val: [T, B] numpy command arrays (modified in place).
    Returns per-block max chain depth like native.lift_deep.
    """
    T, B = op_len.shape
    out_depths = np.zeros(B, np.int32)
    for b in range(B):
        col = op_len[:, b]
        n = int(np.argmax(col < 0)) if (col < 0).any() else T
        if n == 0:
            continue
        lens = np.where(col[:n] == 0, 1, np.maximum(col[:n], 0))
        ends = np.cumsum(lens)
        starts = ends - lens
        N = int(ends[-1])
        depth = np.zeros(N, np.int32)
        cmd_at = np.zeros(N, np.int32)  # command index covering each byte
        for k in range(n):
            m, l = int(starts[k]), int(lens[k])
            if col[k] <= 0:
                cmd_at[m : m + l] = k
                continue
            d = int(op_val[k, b])
            # lift while too deep and the source span sits in one command;
            # only sound for non-overlapping matches (l <= d): an
            # overlap's tail references the match itself, outside the
            # verified source command (overlaps are depth-collapsed by
            # the decoder's modular parents anyway). Iteration cap 64
            # mirrors native nlzmx_lift_deep exactly (engine parity).
            lift_budget = 64
            while l <= d and lift_budget > 0:
                lift_budget -= 1
                src = m - d
                dd = depth[src : src + l]
                if dd.max() + 1 <= cap:
                    break
                c0 = cmd_at[src]
                if cmd_at[src + l - 1] != c0 or col[c0] <= 0:
                    break
                d2 = d + int(op_val[c0, b])
                mmin2 = 2 + (d2 > 0xFF) + (d2 > 0xFFF) + (d2 > 0xFFFFF)
                if d2 > m or l < mmin2:
                    break
                d = d2
            op_val[k, b] = d
            src = m - d
            span = min(d, l)
            dd = depth[src : src + span] + 1
            reps = -(-l // span)
            depth[m : m + l] = np.tile(dd, reps)[:l]
            cmd_at[m : m + l] = k
        if n:
            out_depths[b] = depth[: int(ends[-1])].max()
    return out_depths


def parse_blocks_device(data: bytes, block_size: int, hist_bits: int, parser: str = "optimal"):
    """Device parse only: blocks -> command arrays.

    Returns (op_len [T, Bn], op_val, op_rep) as numpy, where op_rep uses
    the rep-table replay rule (identical for the v1 and wide profiles:
    a present distance is emitted as rep and so never re-enters the
    table, which keeps the last-4-dicts window duplicate-free).
    """
    arr, n_valid = _blocks_arrays(data, block_size)
    if arr.shape[0] == 0:
        return (np.zeros((0, 0), np.int32),) * 3
    dj, nv = jnp.asarray(arr), jnp.asarray(n_valid)
    N = block_size
    num_steps = ((N + 255) // 256) * 256
    reach = (1 << hist_bits) - 1
    if parser == "optimal":
        op_len, op_val = _calibrated_parse(dj, nv, reach, num_steps)
    else:
        delta, mlen = find_matches(dj, nv, reach)
        op_len, op_val = greedy_cover(dj, delta, mlen, nv, num_steps)
    # explicit copies: np.asarray of a jax array is a READ-ONLY view of
    # the device buffer; the lift mutates op_val in place (the native
    # path writes through ctypes, which ignores the writeable flag - it
    # must never alias XLA's buffer)
    op_len_h = np.array(np.asarray(op_len), np.int32, order="C")
    op_val_h = np.array(np.asarray(op_val), np.int32, order="C")
    from .. import native

    if native.available():
        depths = native.lift_deep(op_len_h, op_val_h, block_size)
    else:
        if op_len_h.shape[1] > 1:
            import warnings

            warnings.warn(
                "native library not built: depth lifting falls back to "
                "per-byte Python loops (orders of magnitude slower on "
                f"{op_len_h.shape[1]} blocks); run `make -C native`",
                RuntimeWarning,
                stacklevel=2,
            )
        depths = lift_deep_matches(op_len_h, op_val_h)
    op_rep = repify(jnp.asarray(op_len_h), jnp.asarray(op_val_h))
    return op_len_h, op_val_h, np.asarray(op_rep), depths


def encode_blocks_device(
    data: bytes, block_size: int, hist_bits: int, mesh=None, parser: str = "greedy"
):
    """Encode blocks on the device; returns (payloads, reads, cmds) like
    native.encode_blocks. Each block is one NLZM frame. With a mesh, blocks
    shard data-parallel over its device axis."""
    from ..constants import chunk_size_for, frame_bits_for

    limit = chunk_size_for(frame_bits_for(hist_bits))
    if block_size > limit:
        raise ValueError(
            f"engine=device v1 blocks encode as one frame each: block_size "
            f"{block_size} exceeds the frame chunk capacity {limit} at "
            f"hist_bits {hist_bits} (use -blocks:{limit} or less, or the "
            f"native engine)"
        )
    n = len(data)
    nblocks = (n + block_size - 1) // block_size
    if nblocks == 0:
        return [], [], []

    N = block_size
    n_dev = 1 if mesh is None else mesh.devices.size
    pad_blocks = (-nblocks) % n_dev
    arr = np.zeros((nblocks + pad_blocks, N), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for b in range(nblocks):
        seg = flat[b * N : (b + 1) * N]
        arr[b, : len(seg)] = seg
    n_valid = np.zeros(nblocks + pad_blocks, np.int32)
    n_valid[:nblocks] = np.minimum(
        np.full(nblocks, N, np.int64), n - np.arange(nblocks) * N
    ).astype(np.int32)

    num_steps = ((N + 255) // 256) * 256  # worst case: all literals
    rans_cap = ((3 * N + 64 + 255) // 256) * 256
    bits_cap = ((N + 64 + 255) // 256) * 256
    reach = (1 << hist_bits) - 1

    fn = partial(
        encode_pipeline,
        reach=reach,
        num_steps=num_steps,
        rans_cap=rans_cap,
        bits_cap=bits_cap,
        parser=parser,
    )
    if mesh is None:
        fn = jax.jit(fn)
        dj, nv = jnp.asarray(arr), jnp.asarray(n_valid)
    else:
        from jax.sharding import NamedSharding, PartitionSpec as P

        shard = NamedSharding(mesh, P(mesh.axis_names[0]))
        fn = jax.jit(fn, in_shardings=(shard, shard))
        dj = jax.device_put(jnp.asarray(arr), shard)
        nv = jax.device_put(jnp.asarray(n_valid), shard)

    stream, rans_bytes, bits_bytes, bits_n, nops, ncmds_d = fn(dj, nv)

    stream_h = np.asarray(stream)
    rb = np.asarray(rans_bytes)
    bits_h = np.asarray(bits_bytes)
    bn = np.asarray(bits_n)
    nops_h = np.asarray(nops)
    ncmds = np.asarray(ncmds_d)

    payloads = []
    for b in range(nblocks):
        nb_bytes = 12 + int(bn[b])
        hdr = (
            int(nops_h[b]).to_bytes(4, "big")
            + nb_bytes.to_bytes(4, "big")
            + int(rb[b]).to_bytes(4, "big")
        )
        payloads.append(hdr + bits_h[b, : int(bn[b])].tobytes() + stream_h[b, : int(rb[b])].tobytes())
    return payloads, nops_h[:nblocks].tolist(), ncmds[:nblocks].tolist()
