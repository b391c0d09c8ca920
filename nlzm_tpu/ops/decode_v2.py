"""Batched device entropy decoder, v2: one LZ command per scan step, zero scatters.

Differences from the v1 FSM kernel (decode_ops.py):

- Step granularity is a whole command: up to 6 predicated CDF reads and 2
  raw-bit fields advance together, so scan overhead and emission amortize
  over ~3x more coded items.
- Model state lives in per-family tensors updated with masked dense math
  and one-hot FMAs - there is no scatter anywhere in the step (scatters
  dominated v1's runtime).
- Commands are emitted as scan outputs (ys), aligned one-per-step, so
  phase 2 (LZ expansion on device, or the native host runtime) consumes them
  directly with no compaction.
- The two distance extra-bit fields are read as one combined bit fetch
  (identical bit layout; valid while add_bits <= 24, i.e. window < 2^27).
- **Block-minor layout**: every model tensor keeps the block axis LAST
  ([..., 17, B] instead of [B, ..., 17]), so the minor (vectorized)
  dimension runs across blocks instead of across the 17 CDF fences.

Semantics parity: NLZM.cpp:1967-2012 (command loop), 666-731 (frame reads).
"""

from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CDF_SCALE_TOTAL
from .cdf_ops import mixin_tensor

_U32 = jnp.uint32
_I32 = jnp.int32


class V2State(NamedTuple):
    cmd_c: jax.Array  # [17, B]
    lith_c: jax.Array  # [17, B]
    litl_c: jax.Array  # [16, 17, B]
    lend_c: jax.Array  # [17, B]
    lehi_c: jax.Array  # [17, B]
    lelo_c: jax.Array  # [16, 17, B]
    dhi_c: jax.Array  # [4, 17, B]
    dlo_c: jax.Array  # [32, 17, B]
    rans: jax.Array  # [4, B] u32
    lane: jax.Array  # [B]
    rans_pos: jax.Array  # [B]
    bit_pos: jax.Array  # [B]
    word: jax.Array  # [B] u32
    word_bits: jax.Array  # [B]
    num_ops: jax.Array  # [B]
    frame_ptr: jax.Array  # [B]
    done: jax.Array  # [B] bool
    rep_tab: jax.Array  # [4, B]


def _uniform_cells(n: int) -> np.ndarray:
    step = CDF_SCALE_TOTAL // n
    return np.asarray(
        [i * step for i in range(n)] + [CDF_SCALE_TOTAL] * (17 - n), dtype=np.int32
    )


def _init_state(B: int) -> V2State:
    z = jnp.zeros((B,), _I32)

    def fam(n, *shape):
        cells = jnp.asarray(_uniform_cells(n))[:, None]  # [17, 1]
        return jnp.broadcast_to(cells, (*shape, 17, B)).astype(_I32)

    return V2State(
        cmd_c=fam(4),
        lith_c=fam(16),
        litl_c=fam(16, 16),
        lend_c=fam(8),
        lehi_c=fam(16),
        lelo_c=fam(16, 16),
        dhi_c=fam(8, 4),
        dlo_c=fam(8, 32),
        rans=jnp.zeros((4, B), _U32),
        lane=z,
        rans_pos=z,
        bit_pos=z,
        word=jnp.zeros((B,), _U32),
        word_bits=z,
        num_ops=z,
        frame_ptr=z,
        done=jnp.zeros((B,), bool),
        rep_tab=jnp.broadcast_to(jnp.arange(1, 5, dtype=_I32)[:, None], (4, B)),
    )


def _byte(data, pos):
    idx = jnp.clip(pos, 0, data.shape[1] - 1)
    return jnp.take_along_axis(data, idx[:, None], axis=1)[:, 0].astype(_I32)


def _byte2(data, pos):
    """Two consecutive bytes as (hi << 8) | lo."""
    return (_byte(data, pos) << 8) | _byte(data, pos + 1)


# mixin rows for classes 4/8/16, transposed to [3, 17, 16] so adaptation
# targets come out block-minor ([17, B])
def _mixin17() -> np.ndarray:
    m = mixin_tensor()  # [3, 16, 17]
    return np.ascontiguousarray(m.transpose(0, 2, 1))  # [3, 17, 16]


def _win_load(data32, pos, words: int):
    """Contiguous byte window starting at the u32 word containing `pos`:
    returns (win [words, B] u32-le, base byte offset [B])."""
    base = pos >> 2
    cols = [
        jnp.take_along_axis(data32, jnp.clip(base + k, 0, data32.shape[1] - 1)[:, None], axis=1)[:, 0]
        for k in range(words)
    ]
    return jnp.stack(cols, axis=0), base << 2


def _win_load2(data32, rans_pos, bit_pos):
    """Both per-step windows (4 renorm words + 3 bit words) in ONE gather.

    The step body is gather-call-bound on this chip (7 separate [B]
    take_along_axis calls were ~the whole 31 us/step); a single [B, 7]
    gather fetches the same words in one op."""
    rbase = rans_pos >> 2
    bbase = bit_pos >> 2
    idx = jnp.stack(
        [rbase, rbase + 1, rbase + 2, rbase + 3, bbase, bbase + 1, bbase + 2],
        axis=1,
    )  # [B, 7]
    w = jnp.take_along_axis(data32, jnp.clip(idx, 0, data32.shape[1] - 1), axis=1)
    rwin = w[:, :4].T  # [4, B]
    bwin = w[:, 4:].T  # [3, B]
    return rwin, rbase << 2, bwin, bbase << 2


def _win_byte(win, base, off):
    """Extract byte at absolute offset `off` from a window.

    Pure elementwise select tree - NO one-hot + reduce. The reduce
    variant was 65% of the whole decode step on hardware (534 -> 189
    ms/8MB without it): each of the ~15 calls per step lowered to its
    own reduction kernel instead of fusing into the step's elementwise
    body."""
    j = off - base
    k = jnp.clip(j >> 2, 0, win.shape[0] - 1)
    if win.shape[0] == 1:
        w = win[0]
    elif win.shape[0] == 2:
        w = jnp.where(k >= 1, win[1], win[0])
    else:
        hi = win[3] if win.shape[0] > 3 else win[2]
        a = jnp.where((k & 1) != 0, win[1], win[0])
        c = jnp.where((k & 1) != 0, hi, win[2])
        w = jnp.where((k & 2) != 0, c, a)
    sh = ((j & 3) << 3).astype(_U32)
    return ((w.astype(_U32) >> sh) & jnp.asarray(0xFF, _U32)).astype(_I32)


class _Rans(NamedTuple):
    rans: jax.Array  # [4, B]
    lane: jax.Array  # [B]
    rans_pos: jax.Array  # [B]
    reads: jax.Array  # cumulative read count this step [B]
    win: jax.Array  # [4, B] u32 window covering this step's renorm bytes
    win_base: jax.Array  # [B] byte offset of win[0]


def _cdf_read(row, pred, r: _Rans, data, mix_fn):
    """Predicated symbol read against per-block fence rows [17, B].

    mix_fn(y) -> [17, B] adaptation target rows for the decoded symbols.
    Returns (y [B], updated_row [17, B], new rans bundle). Blocks with
    pred=False keep their state and get y=0 semantics-free.
    """
    lane_oh = jax.nn.one_hot(r.lane, 4, dtype=_I32, axis=0)  # [4, B]
    x = jnp.sum(lane_oh * r.rans.astype(_I32), axis=0).astype(_U32)

    f = (x & jnp.asarray(0x3FFF, _U32)).astype(_I32)
    y = jnp.sum((f[None, :] >= row[1:]).astype(_I32), axis=0)
    y_oh = jax.nn.one_hot(y, 17, dtype=_I32, axis=0)  # [17, B]
    y1_oh = jax.nn.one_hot(y + 1, 17, dtype=_I32, axis=0)
    start = jnp.sum(y_oh * row, axis=0)
    freq = jnp.sum(y1_oh * row, axis=0) - start

    x2 = freq.astype(_U32) * (x >> 14) + (f - start).astype(_U32)
    renorm = x2 < jnp.asarray(1 << 16, _U32)
    b0 = _win_byte(r.win, r.win_base, r.rans_pos).astype(_U32)
    b1 = _win_byte(r.win, r.win_base, r.rans_pos + 1).astype(_U32)
    x3 = jnp.where(renorm, (x2 << 16) | (b0 << 8) | b1, x2)

    take = pred
    new_rans = jnp.where(
        (take[None, :]) & (lane_oh > 0), x3[None, :], r.rans.astype(_U32)
    ).astype(_U32)
    rans_pos = r.rans_pos + jnp.where(take & renorm, 2, 0)
    lane = jnp.where(take, (r.lane + 1) & 3, r.lane)

    # adaptation toward the mixin row for this (class, symbol)
    mix = mix_fn(jnp.clip(y, 0, 15))  # [17, B]
    upd = row + ((mix - row) >> 7)

    return y, upd, _Rans(
        new_rans, lane, rans_pos, r.reads + take.astype(_I32), r.win, r.win_base
    )


class _Bits(NamedTuple):
    word: jax.Array
    word_bits: jax.Array
    bit_pos: jax.Array
    win: jax.Array  # [3, B] u32 window covering this step's bit bytes
    win_base: jax.Array


def _bits_read(nb, pred, b: _Bits):
    """Predicated MSB-first read of nb bits (nb in [0,24]; nb=0 reads none
    but still counts when pred - callers pass nb>=1 whenever pred)."""
    word, word_bits, bit_pos = b.word, b.word_bits, b.bit_pos
    for _ in range(3):
        can = pred & (word_bits < 24)
        byte = _win_byte(b.win, b.win_base, bit_pos).astype(_U32)
        shift = jnp.clip(24 - word_bits, 0, 31).astype(_U32)
        word = jnp.where(can, word | (byte << shift), word)
        bit_pos = bit_pos + can.astype(_I32)
        word_bits = word_bits + jnp.where(can, 8, 0)
    nb = jnp.clip(nb, 0, 24)
    v = jnp.where(
        nb > 0, (word >> jnp.clip(32 - nb, 0, 31).astype(_U32)).astype(_I32), 0
    )
    v = jnp.where(pred, v, 0)
    word = jnp.where(pred, word << nb.astype(_U32), word)
    word_bits = word_bits - jnp.where(pred, nb, 0)
    return v, _Bits(word, word_bits, bit_pos, b.win, b.win_base)


def _family_update(fam, idx, upd_row, orig_row, pred, k):
    """fam[idx[b], :, b] <- upd_row[:, b] where pred, via one-hot FMA."""
    oh = jax.nn.one_hot(idx, k, dtype=_I32, axis=0) * pred.astype(_I32)[None, :]
    return fam + oh[:, None, :] * (upd_row - orig_row)[None, :, :]


def _row_of(fam, idx, k):
    oh = jax.nn.one_hot(idx, k, dtype=fam.dtype, axis=0)  # [k, B]
    return jnp.einsum("kb,kwb->wb", oh, fam)


def _frame_init(st: V2State, data):
    need = (~st.done) & (st.num_ops == 0)

    def do_init(_):
        def be32(pos):
            return (
                (_byte(data, pos) << 24)
                | (_byte(data, pos + 1) << 16)
                | (_byte(data, pos + 2) << 8)
                | _byte(data, pos + 3)
            )

        hdr_ops = be32(st.frame_ptr)
        nb_bytes = be32(st.frame_ptr + 4)
        nr_bytes = be32(st.frame_ptr + 8)
        becomes_done = need & (hdr_ops == 0)
        init = need & (hdr_ops != 0)

        rans_base = st.frame_ptr + nb_bytes

        def le32(pos):
            return (
                _byte(data, pos).astype(_U32)
                | (_byte(data, pos + 1).astype(_U32) << 8)
                | (_byte(data, pos + 2).astype(_U32) << 16)
                | (_byte(data, pos + 3).astype(_U32) << 24)
            )

        new_states = jnp.stack([le32(rans_base + 4 * k) for k in range(4)], axis=0)
        return (
            st.done | becomes_done,
            jnp.where(init, hdr_ops, st.num_ops),
            jnp.where(init, st.frame_ptr + 12, st.bit_pos),
            jnp.where(init, jnp.zeros((), _U32), st.word),
            jnp.where(init, 0, st.word_bits),
            jnp.where(init[None, :], new_states, st.rans),
            jnp.where(init, 0, st.lane),
            jnp.where(init, rans_base + 16, st.rans_pos),
            jnp.where(init, st.frame_ptr + nb_bytes + nr_bytes, st.frame_ptr),
        )

    def skip(_):
        return (
            st.done,
            st.num_ops,
            st.bit_pos,
            st.word,
            st.word_bits,
            st.rans,
            st.lane,
            st.rans_pos,
            st.frame_ptr,
        )

    return jax.lax.cond(jnp.any(need), do_init, skip, None)


def _step(data, data32, mixin, st: V2State, _):
    (done, num_ops, bit_pos, word, word_bits, rans, lane, rans_pos, frame_ptr) = _frame_init(
        st, data
    )
    active = ~done

    # one fused gather covers <= 12 renorm bytes + <= 6 bit bytes
    rwin, rbase, bwin, bbase = _win_load2(data32, rans_pos, bit_pos)
    r = _Rans(rans, lane, rans_pos, jnp.zeros_like(lane), rwin, rbase)
    b = _Bits(word, word_bits, bit_pos, bwin, bbase)

    mix4, mix8, mix16 = mixin[0], mixin[1], mixin[2]  # each [17, 16]

    def pick(tbl, y, k):
        oh = jax.nn.one_hot(jnp.clip(y, 0, k - 1), 16, dtype=_I32, axis=0)  # [16, B]
        return jnp.einsum("wk,kb->wb", tbl, oh)

    f4 = lambda y: pick(mix4, y, 4)
    f8 = lambda y: pick(mix8, y, 8)
    f16 = lambda y: pick(mix16, y, 16)

    # R0: command
    y0, upd, r = _cdf_read(st.cmd_c, active, r, data, f4)
    cmd_c = jnp.where(active[None, :], upd, st.cmd_c)
    is_lit = active & (y0 == 0)
    is_dict = active & (y0 == 1)
    is_rep = active & (y0 >= 2)
    is_match = is_dict | is_rep

    # B0: rep slot index
    rep_idx, b = _bits_read(jnp.full_like(y0, 2), is_rep, b)
    bits_reads = is_rep.astype(_I32)

    # R1: literal hi nibble | direct length (mixed 16/8-symbol classes)
    row1 = jnp.where(is_lit[None, :], st.lith_c, st.lend_c)
    fmix1 = lambda y: jnp.where(is_lit[None, :], pick(mix16, y, 16), pick(mix8, y, 8))
    y1, upd1, r = _cdf_read(row1, active, r, data, fmix1)
    lith_c = jnp.where(is_lit[None, :], upd1, st.lith_c)
    lend_c = jnp.where(is_match[None, :], upd1, st.lend_c)
    esc = is_match & (y1 == 7)
    lc = jnp.minimum(y1, 3)

    # R2: literal lo nibble | length-extension hi
    pred2 = is_lit | esc
    litl_row = _row_of(st.litl_c, jnp.where(is_lit, y1, 0), 16)
    row2 = jnp.where(is_lit[None, :], litl_row, st.lehi_c)
    y2, upd2, r = _cdf_read(row2, pred2, r, data, f16)
    litl_c = _family_update(st.litl_c, y1, upd2, litl_row, is_lit, 16)
    lehi_c = jnp.where(esc[None, :], upd2, st.lehi_c)

    # R3: length-extension lo
    lelo_row = _row_of(st.lelo_c, jnp.where(esc, y2, 0), 16)
    y3, upd3, r = _cdf_read(lelo_row, esc, r, data, f16)
    lelo_c = _family_update(st.lelo_c, y2, upd3, lelo_row, esc, 16)

    lv = jnp.where(esc, 7 + (y2 << 4) + y3, y1)

    # R4: distance slot hi (context = length class)
    dhi_row = _row_of(st.dhi_c, jnp.where(is_dict, lc, 0), 4)
    y4, upd4, r = _cdf_read(dhi_row, is_dict, r, data, f8)
    dhi_c = _family_update(st.dhi_c, lc, upd4, dhi_row, is_dict, 4)

    # R5: distance slot lo (context = length class * 8 + hi slot)
    dlo_idx = jnp.where(is_dict, (lc << 3) + y4, 0)
    dlo_row = _row_of(st.dlo_c, dlo_idx, 32)
    y5, upd5, r = _cdf_read(dlo_row, is_dict, r, data, f8)
    dlo_c = _family_update(st.dlo_c, dlo_idx, upd5, dlo_row, is_dict, 32)

    # distance reconstruction; both raw-bit fields fetched in one read
    dv_slot = (y4 << 3) + y5
    small = dv_slot < 4
    ab = jnp.clip((dv_slot >> 1) - 1, 0, 30)
    need_bits = is_dict & ~small
    extra, b = _bits_read(jnp.where(need_bits, ab, 0), need_bits, b)
    bits_reads = bits_reads + jnp.where(need_bits, 1 + (ab > 4).astype(_I32), 0)
    dv = jnp.where(small, dv_slot, ((2 + (dv_slot & 1)) << ab) + extra)

    # emit
    delta_dict = dv + 1
    rep_oh = jax.nn.one_hot(jnp.clip(rep_idx, 0, 3), 4, dtype=_I32, axis=0)  # [4, B]
    delta_rep = jnp.sum(rep_oh * st.rep_tab, axis=0)
    delta = jnp.where(is_rep, delta_rep, delta_dict)
    mmin = (
        2
        + (delta > 0xFF).astype(_I32)
        + (delta > 0xFFF).astype(_I32)
        + (delta > 0xFFFFF).astype(_I32)
    )
    out_len = jnp.where(is_match, lv + mmin, 0)
    out_val = jnp.where(is_lit, (y1 << 4) + y2, delta)
    out_len = jnp.where(active, out_len, -1)  # -1 marks "no command" (done)

    # rep MTF insert for fresh dict distances
    t = st.rep_tab  # [4, B]
    present = jnp.any(t == delta_dict[None, :], axis=0)
    shifted = jnp.concatenate([delta_dict[None, :], t[:3]], axis=0)
    rep_tab = jnp.where((is_dict & ~present)[None, :], shifted, t)

    num_ops = num_ops - r.reads - bits_reads

    new_st = V2State(
        cmd_c=cmd_c,
        lith_c=lith_c,
        litl_c=litl_c,
        lend_c=lend_c,
        lehi_c=lehi_c,
        lelo_c=lelo_c,
        dhi_c=dhi_c,
        dlo_c=dlo_c,
        rans=r.rans,
        lane=r.lane,
        rans_pos=r.rans_pos,
        bit_pos=b.bit_pos,
        word=b.word,
        word_bits=b.word_bits,
        num_ops=num_ops,
        frame_ptr=frame_ptr,
        done=done,
        rep_tab=rep_tab,
    )
    return new_st, (out_len, out_val)


@partial(jax.jit, static_argnames=("num_steps", "unroll"))
def fsm_decode_v2(data: jax.Array, num_steps: int, unroll: int = 1):
    """Entropy-decode B block streams, one command per step.

    data: [B, S] uint8 frames (zero-padded; zero header terminates).
    num_steps: >= max commands per block (+1 for the terminator step).
    unroll: scan unroll factor = commands decoded per while-loop trip
    (the "2 commands per step" experiment; semantics-free).

    Returns (op_len [T, B], op_val [T, B]): op_len < 0 marks steps past a
    block's end, 0 marks a literal (op_val = byte), else a match of length
    op_len at distance op_val.
    """
    B, S = data.shape
    pad = (-S) % 4
    if pad:
        data = jnp.pad(data, ((0, 0), (0, pad)))
    d32 = data.reshape(B, -1, 4).astype(_U32)
    data32 = d32[:, :, 0] | (d32[:, :, 1] << 8) | (d32[:, :, 2] << 16) | (d32[:, :, 3] << 24)
    mixin = jnp.asarray(_mixin17())
    st = _init_state(B)
    st, ys = jax.lax.scan(
        lambda s, x: _step(data, data32, mixin, s, x), st, None,
        length=num_steps, unroll=unroll,
    )
    return ys


def expand_host(op_len: np.ndarray, op_val: np.ndarray, block_size: int, total_len: int) -> bytes:
    """Phase 2 on the host via the native runtime: [T, B] op arrays -> bytes."""
    from .. import native

    T, B = op_len.shape
    out = bytearray()
    lens = op_len.T  # [B, T] views
    vals = op_val.T
    for b in range(B):
        lb = lens[b]
        n = int(np.argmax(lb < 0)) if (lb < 0).any() else T
        out += native.expand_ops(
            np.ascontiguousarray(lb[:n]), np.ascontiguousarray(vals[b][:n]), block_size
        )
    return bytes(out[:total_len])
