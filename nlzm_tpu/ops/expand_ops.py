"""Fully parallel LZ expansion via pointer doubling.

Sequential LZ reconstruction (each match copies earlier output) looks
inherently serial, but every output byte has a well-defined *literal
ancestor*: byte i of a match at distance d sources from i - d, recursively
until a literal. Chains are strictly decreasing, so log2(N) rounds of
batched pointer jumping resolve every byte's ancestor, and one final gather
fills the output. This replaces both the reference's byte-serial copy loop
(NLZM.cpp:1992-1996) and the per-command scatter kernel.

Two formulations of the per-round composition p <- p o p:

- packed path (block_size <= PACK_MAX = 32768): every gather by
  arbitrary index is restructured as sorts (ops/sort_gather.py): merge
  (source, query) records keyed by position into one packed i32 sort,
  forward-fill the latest source payload with a cummax (packed keys are
  monotone in position), and route results back to query order with a
  second packed sort. The prologue's command-attribute gathers collapse
  into a scatter + cummax fill.
- 2-operand path (big blocks, up to 128 KiB): same structure with
  (key, payload[, aux]) multi-operand sorts and associative take-latest
  fills - no position/payload bit budget, at a higher per-element cost.

Inputs are the step-aligned command arrays from fsm_decode_v2.
"""

from functools import partial

import jax
import jax.numpy as jnp

_I32 = jnp.int32

from .sort_gather import (
    PACK_MAX as _PACK_MAX,
    PB as _PB,
    gather_sorted as _gather_sorted,
    gather_sorted2 as _gather_sorted2,
    gather_sorted16 as _gather_sorted16,
)


def _sparse_fill2(src_pos, src_valid, src_pay, src_aux, qry_key, qry_pay, post):
    """Big-block sparse fill: (key, payload, aux) 3-operand unstable sort
    + two-value take-latest associative fill + 2-op route-back. Full i32
    positions/payloads (no packing budget). post(pay_f, aux_f, qpay) maps
    each query's filled source values + its own payload to the result;
    qry_pay must be iota (it routes the result back to position order).
    """
    B, Q = qry_key.shape
    BIG = jnp.iinfo(jnp.int32).max  # odd: never mistaken for a source key
    k1 = jnp.concatenate(
        [jnp.where(src_valid, src_pos * 2, BIG), qry_key * 2 + 1], axis=1
    )
    p1 = jnp.concatenate([src_pay, qry_pay], axis=1)
    a1 = jnp.concatenate([src_aux, jnp.zeros_like(qry_pay)], axis=1)
    ks, ps, as_ = jax.lax.sort((k1, p1, a1), dimension=1, num_keys=1, is_stable=False)
    is_src = (ks & 1) == 0

    def comb(x, y):
        return (
            x[0] | y[0],
            jnp.where(y[0], y[1], x[1]),
            jnp.where(y[0], y[2], x[2]),
        )

    _, pay_f, aux_f = jax.lax.associative_scan(
        comb,
        (is_src, jnp.where(is_src, ps, 0), jnp.where(is_src, as_, 0)),
        axis=1,
    )
    res = post(pay_f, aux_f, ps)
    key2 = jnp.where(~is_src & (ks != BIG), ps, BIG)
    _, out = jax.lax.sort((key2, res), dimension=1, num_keys=1, is_stable=False)
    return out[:, :Q]


_U32 = jnp.uint32
_PADKEY = jnp.uint32(0xFFFFFFFF)  # inert record: sorts last, never a query


def _sparse_fill(src_pos, src_valid, src_pay, qry_key, qry_pay, post, pay_bits=_PB):
    """Merged sort + cummax fill with SPARSE sources (u32 keys).

    Sources key (pos<<1)<<pay_bits | pay; queries ((key<<1)|1)<<pay_bits
    | pay. Invalid sources become _PADKEY (sort last, fill nothing,
    excluded from the route-back). `post(filled, qpay)` maps each query's
    filled source word + its own payload to a pay_bits-wide result, which
    one route-back sort returns in qry-payload order (payloads must be a
    permutation of 0..Q-1, i.e. iota). Replaces full-width scatter+cummax
    grids: sorts run ~2x faster than scatters here.

    pay_bits=15 (default): positions and payloads both 15-bit.
    pay_bits=16: payloads/results up to 16-bit (positions still 15-bit,
    query payloads <= 15-bit) - the dict-shifted parent space [0, D+N)
    with D + N <= 65536 rides this packing in the same u32 sorts.
    """
    B, Q = qry_key.shape
    pmask = jnp.uint32((1 << pay_bits) - 1)
    src_e = jnp.where(
        src_valid,
        ((src_pos.astype(_U32) << 1) << pay_bits) | src_pay.astype(_U32),
        _PADKEY,
    )
    qry_e = (((qry_key.astype(_U32) << 1) | 1) << pay_bits) | qry_pay.astype(_U32)
    s = jax.lax.sort(jnp.concatenate([src_e, qry_e], axis=1), dimension=1, is_stable=False)
    is_q = ((s >> pay_bits) & 1).astype(jnp.bool_) & (s != _PADKEY)
    filled = jax.lax.cummax(jnp.where(is_q | (s == _PADKEY), jnp.uint32(0), s), axis=1)
    res = post(filled, (s & pmask).astype(_I32))
    key2 = jnp.where(
        is_q,
        ((s & pmask) << pay_bits) | res.astype(_U32),
        _PADKEY,
    )
    s2 = jax.lax.sort(key2, dimension=1, is_stable=False)
    return (s2[:, :Q] & pmask).astype(_I32)


def _parent_fill_sorted(lens, starts, deltas, block_size):
    """Packed-path parent construction, scatter-free.

    One merged sort of (command records keyed by start, position queries)
    + cummax gives every position its covering command's (start, delta)
    packed in one word; the modular parent m - d + ((i - m) mod d) is
    computed IN MERGED ORDER (its result fits the 15-bit route-back
    payload, unlike the (start, delta) pair would).
    """
    B, T = lens.shape
    N = block_size
    iota_n = jnp.broadcast_to(jnp.arange(N, dtype=_I32), (B, N))

    def post(filled, qpay):
        m_at = (filled >> (_PB + 1)).astype(_I32)
        d_at = (filled & (_PACK_MAX - 1)).astype(_I32)
        d_safe = jnp.maximum(d_at, 1)
        par = jnp.where(d_at == 0, qpay, m_at - d_at + ((qpay - m_at) % d_safe))
        return jnp.clip(par, 0, N - 1)

    return _sparse_fill(starts, lens > 0, deltas, iota_n, iota_n, post)


def _parent_fill_sorted_dict(lens, starts, deltas, block_size, dict_len):
    """Parent construction in dict-SHIFTED coordinates (16-bit payloads).

    The container dictionary logically occupies positions [0, D) and the
    block [D, D+N); parents landing in the dict region are terminal
    (dictionary bytes are known literals). Deltas may reach D + pos, so
    payloads use the 16-bit packing (requires D + N <= 65536, N <= 32768).
    """
    B, T = lens.shape
    N, D = block_size, dict_len
    iota_n = jnp.broadcast_to(jnp.arange(N, dtype=_I32), (B, N))

    def post(filled, qpay):
        m_at = (filled >> 17).astype(_I32)
        d_at = (filled & 0xFFFF).astype(_I32)
        d_safe = jnp.maximum(d_at, 1)
        par = jnp.where(d_at == 0, qpay, m_at - d_at + ((qpay - m_at) % d_safe))
        return jnp.clip(par + D, 0, D + N - 1)

    return _sparse_fill(starts, lens > 0, deltas, iota_n, iota_n, post, pay_bits=16)


def _byte_fill_sorted(lens, starts, op_len_t, op_val_t, parent, block_size):
    """Packed-path final byte resolution with SPARSE sources.

    After the doubling rounds every parent is a literal position, so the
    byte gather's sources need only the literal commands - no dense
    lit_at array (and no scatter building it)."""
    B, T = lens.shape
    N = block_size
    iota_n = jnp.broadcast_to(jnp.arange(N, dtype=_I32), (B, N))
    is_lit = op_len_t == 0

    def post(filled, qpay):
        return (filled & jnp.uint32(0xFF)).astype(_I32)

    return _sparse_fill(
        starts, is_lit, jnp.where(is_lit, op_val_t, 0), parent, iota_n, post
    )


def _byte_fill_dict(is_lit, starts, op_val_t, parent, block_size, dict_arr):
    """Final byte resolution in dict-shifted coordinates: ONE merged fill.

    Sources are the dictionary bytes (positions [0, D)) plus the block's
    literal commands (positions D + start); queries are the N output
    positions keyed by parent. Positions use 16 bits, payloads 15 - the
    packing (pos << 1 | tag) << 15 | pay fills the u32 exactly, so the
    single maximal code word (pos = D+N-1 = 65535, tag 1, pay = 32767)
    would collide with the sort's pad key. That combination is exactly
    "the last block position is a literal rooted at itself"; it is
    excluded from the sort and patched afterwards from the command
    arrays (a static-index column fix, not a scatter).
    """
    B, N = parent.shape
    D = dict_arr.shape[0]
    iota_n = jnp.broadcast_to(jnp.arange(N, dtype=_I32), (B, N))

    def post_byte(filled, qpay):
        return (filled & jnp.uint32(0xFF)).astype(_I32)

    src_pos = jnp.concatenate(
        [jnp.broadcast_to(jnp.arange(D, dtype=_I32), (B, D)), D + starts], axis=1
    )
    src_valid = jnp.concatenate(
        [jnp.ones((B, D), bool), is_lit], axis=1
    )
    src_pay = jnp.concatenate(
        [jnp.broadcast_to(dict_arr.astype(_I32), (B, D)),
         jnp.where(is_lit, op_val_t, 0)], axis=1
    )
    qry_key = jnp.minimum(parent, D + N - 2)  # exclude the pad-colliding word
    out = _sparse_fill(src_pos, src_valid, src_pay, qry_key, iota_n, post_byte)
    # patch the excluded corner: position N-1 a literal rooted at itself
    last_lit = jnp.sum(
        jnp.where(is_lit & (starts == N - 1), op_val_t, 0), axis=1
    )
    corner = parent[:, N - 1] == D + N - 1
    fixed_last = jnp.where(corner, last_lit, out[:, N - 1])
    return jnp.concatenate([out[:, : N - 1], fixed_last[:, None]], axis=1)


@partial(jax.jit, static_argnames=("block_size",))
def lz_expand_parallel(op_len: jax.Array, op_val: jax.Array, block_size: int,
                       rounds_hint=None, dict_arr=None):
    """op_len/op_val: [T, B] (op_len<0 past end, 0 literal, else match len).

    rounds_hint: optional scalar = exact doubling rounds needed
    (ceil(log2(max chain depth)), known to the encoder and carried in the
    container). Without it the loop runs until a no-change round.

    dict_arr: optional [D] uint8 container-level shared dictionary; match
    distances may then reach D bytes before the block start (delta up to
    pos + D). Parents run in shifted coordinates [0, D+N): [0, D) =
    dictionary (terminal literals), [D, D+N) = block positions.

    Returns (out [B, block_size] uint8, produced [B]).
    """
    T, B = op_len.shape
    op_len_t = op_len.T
    op_val_t = op_val.T
    lens = jnp.where(op_len_t < 0, 0, jnp.where(op_len_t == 0, 1, op_len_t))  # [B, T]
    is_lit = op_len_t == 0
    deltas = jnp.where(is_lit, 0, op_val_t)  # [B, T]

    ends = jnp.cumsum(lens, axis=1)  # [B, T] exclusive-end of each command
    produced = ends[:, -1]
    pos = jnp.arange(block_size, dtype=_I32)[None, :]  # [1, N]

    D = 0 if dict_arr is None else dict_arr.shape[0]
    N = block_size
    use_sort = block_size <= _PACK_MAX and D + N <= (1 << 16)

    starts = ends - lens
    # parent pointer, scatter-free: literals root at themselves; for
    # matches the chain i -> i-d -> ... is periodic inside the command,
    # so the modular closed form m - d + ((i - m) mod d) lands strictly
    # before the command start in ONE hop - chain depth collapses to
    # command nesting depth. With a dictionary, parents run shifted by D
    # and dict-region parents are terminal.
    if use_sort:
        if D:
            parent = _parent_fill_sorted_dict(lens, starts, deltas, N, D)
        else:
            parent = _parent_fill_sorted(lens, starts, deltas, block_size)
    else:
        iota_n = jnp.broadcast_to(jnp.arange(N, dtype=_I32), (B, N))

        def post_parent(pay_f, aux_f, qpay):
            d_safe = jnp.maximum(pay_f, 1)
            par = jnp.where(
                pay_f == 0, qpay, aux_f - pay_f + ((qpay - aux_f) % d_safe)
            )
            return jnp.clip(par + D, 0, D + N - 1)

        parent = _sparse_fill2(
            starts, lens > 0, deltas, starts, iota_n, iota_n, post_parent
        )

    # pointer doubling with early exit: round k resolves chains <= 2^k
    rounds = max(1, (block_size - 1).bit_length())
    if D == 0:
        compose = _gather_sorted if use_sort else _gather_sorted2
    else:
        # dict parents (< D) are terminal: compose only in-block hops
        base_g = _gather_sorted16 if use_sort else _gather_sorted2

        def compose(p, _p=None):
            g = base_g(p, jnp.clip(p - D, 0, N - 1))
            return jnp.where(p >= D, g, p)

    if rounds_hint is None:

        def cond(state):
            k, p, changed = state
            return (k < rounds) & changed

        def body(state):
            k, p, _ = state
            p2 = compose(p, p)
            return k + 1, p2, jnp.any(p2 != p)

        _, parent, _ = jax.lax.while_loop(cond, body, (0, parent, True))
    else:
        bound = jnp.minimum(jnp.asarray(rounds_hint, _I32), rounds)

        def cond2(state):
            k, p = state
            return k < bound

        def body2(state):
            k, p = state
            return k + 1, compose(p, p)

        _, parent = jax.lax.while_loop(cond2, body2, (0, parent))

    if use_sort:
        if D:
            out = _byte_fill_dict(is_lit, starts, op_val_t, parent, N, dict_arr).astype(jnp.uint8)
        else:
            out = _byte_fill_sorted(lens, starts, op_len_t, op_val_t, parent, block_size).astype(jnp.uint8)
    else:
        iota_n = jnp.broadcast_to(jnp.arange(N, dtype=_I32), (B, N))
        out_a = _sparse_fill2(
            starts, is_lit, jnp.where(is_lit, op_val_t, 0),
            jnp.zeros_like(starts), jnp.clip(parent - D, 0, N - 1) if D else parent,
            iota_n, lambda pay_f, aux_f, qpay: pay_f,
        )
        if D:
            dict_pos = jnp.broadcast_to(jnp.arange(D, dtype=_I32), (B, D))
            dict_pay = jnp.broadcast_to(dict_arr.astype(_I32), (B, D))
            out_b = _sparse_fill2(
                dict_pos, jnp.ones((B, D), bool), dict_pay,
                jnp.zeros_like(dict_pos), jnp.clip(parent, 0, D - 1), iota_n,
                lambda pay_f, aux_f, qpay: pay_f,
            )
            out_a = jnp.where(parent < D, out_b, out_a)
        out = out_a.astype(jnp.uint8)
    # zero out past-end positions
    out = jnp.where(pos < produced[:, None], out, 0)
    return out, produced
