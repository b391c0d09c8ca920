"""Gather-via-sort primitives.

These helpers restructure batched gathers/compactions as packed
single-i32 sorts, for backends where XLA's gather lowering is much
slower per element than its sort (whether that holds on a given device
is a measured question; the decode path uses these everywhere):

- gather_sorted:  out[b, k] = src[b, idx[b, k]]   (2 sorts + cummax fill)
- gather_sorted16: same with 16-bit payloads via u32 keys
- compact_by_rank: out[b, r] = val[b, k] where rank[b, k] == r (1 sort)

All packed keys are unique (payload/iota fields disambiguate records),
so every sort runs is_stable=False (an unstable sort does less work).

Packing budget: position bits PB + tag bit + payload bits PB must stay
below 31, so PB=15 supports arrays up to 32768 wide with 15-bit payloads.
"""

import jax
import jax.numpy as jnp

_I32 = jnp.int32
PB = 15
PACK_MAX = 1 << PB


def gather_sorted(src_vals: jax.Array, queries: jax.Array) -> jax.Array:
    """out[b, k] = src_vals[b, queries[b, k]] via packed sort + cummax fill.

    src_vals values, queries, and query count must all fit in PB bits.
    """
    B, N = src_vals.shape
    Q = queries.shape[1]
    assert N <= PACK_MAX and Q <= PACK_MAX
    iota_n = jnp.arange(N, dtype=_I32)
    iota_q = jnp.arange(Q, dtype=_I32)
    # packed key: (pos << 1 | tag) << PB | payload; source tag 0 sorts
    # before queries at the same position
    src_e = jnp.broadcast_to(iota_n << (PB + 1), (B, N)) | src_vals
    qry_e = (queries << (PB + 1)) | (1 << PB) | iota_q[None, :]
    s = jax.lax.sort(jnp.concatenate([src_e, qry_e], axis=1), dimension=1, is_stable=False)
    is_q = (s >> PB) & 1
    # forward-fill the latest source record (monotone in pos -> cummax)
    filled = jax.lax.cummax(jnp.where(is_q == 0, s, -1), axis=1)
    val = filled & (PACK_MAX - 1)
    # route back to query order: queries first, keyed by their own index
    dest = jnp.where(is_q == 1, s & (PACK_MAX - 1), 0)
    key2 = ((1 - is_q) << (2 * PB)) | (dest << PB) | val
    s2 = jax.lax.sort(key2, dimension=1, is_stable=False)
    return s2[:, :Q] & (PACK_MAX - 1)


def gather_sorted16(src_vals: jax.Array, queries: jax.Array) -> jax.Array:
    """gather_sorted with 16-bit payloads via u32 packed keys.

    out[b, k] = src_vals[b, queries[b, k]]; src values may use 16 bits
    (positions and query count still capped at PB bits). Used for
    halfword-granular stream fetches (e.g. the raw-bit plane).
    """
    B, N = src_vals.shape
    Q = queries.shape[1]
    assert N <= PACK_MAX and Q <= PACK_MAX
    u32 = jnp.uint32
    iota_n = jnp.arange(N, dtype=_I32).astype(u32)
    iota_q = jnp.arange(Q, dtype=_I32).astype(u32)
    # key: pos(15) | tag(1) | payload(16); source tag 0 first at equal pos
    src_e = jnp.broadcast_to(iota_n << 17, (B, N)) | src_vals.astype(u32)
    qry_e = (queries.astype(u32) << 17) | jnp.asarray(1 << 16, u32) | iota_q[None, :]
    s = jax.lax.sort(jnp.concatenate([src_e, qry_e], axis=1), dimension=1, is_stable=False)
    is_q = (s >> 16) & jnp.asarray(1, u32)
    # the source array is dense (every position present), so a source
    # record always precedes each query at its position: 0 is a safe mask
    filled = jax.lax.cummax(jnp.where(is_q == 0, s, jnp.asarray(0, u32)), axis=1)
    val = filled & jnp.asarray(0xFFFF, u32)
    dest = jnp.where(is_q == 1, s & jnp.asarray(0xFFFF, u32), jnp.asarray(0, u32))
    key2 = ((jnp.asarray(1, u32) - is_q) << 31) | (dest << 16) | val
    s2 = jax.lax.sort(key2, dimension=1, is_stable=False)
    return (s2[:, :Q] & jnp.asarray(0xFFFF, u32)).astype(_I32)


def _fill_latest(flag: jax.Array, val: jax.Array):
    """Forward-fill val from the latest position with flag set (per row).

    Associative take-latest scan - the unbounded-width analog of the
    packed cummax fill (no position/payload bit budget)."""

    def comb(a, b):
        return (a[0] | b[0], jnp.where(b[0], b[1], a[1]))

    return jax.lax.associative_scan(comb, (flag, val), axis=1)[1]


def gather_sorted2(src_vals: jax.Array, queries: jax.Array) -> jax.Array:
    """gather_sorted for arbitrary widths/payloads via 2-operand sorts.

    out[b, k] = src_vals[b, queries[b, k]]. Positions and payloads are
    full i32 (no PACK_MAX cap) - used by the big-block (> 32 KiB) wide
    profile. ~1.8x the per-element cost of the packed single-i32 path,
    so the packed variant stays the default under the 15-bit budget.
    """
    B, N = src_vals.shape
    Q = queries.shape[1]
    iota_n = jnp.arange(N, dtype=_I32)
    iota_q = jnp.arange(Q, dtype=_I32)
    # key = pos*2 | tag: unique (one source per position, one query per slot)
    k1 = jnp.concatenate(
        [jnp.broadcast_to(iota_n * 2, (B, N)), queries * 2 + 1], axis=1
    )
    pay = jnp.concatenate([src_vals, jnp.broadcast_to(iota_q, (B, Q))], axis=1)
    k_s, p_s = jax.lax.sort((k1, pay), dimension=1, num_keys=1, is_stable=False)
    is_q = (k_s & 1) == 1
    val = _fill_latest(~is_q, jnp.where(is_q, 0, p_s))
    dest = jnp.where(is_q, p_s, jnp.iinfo(jnp.int32).max)  # sources sort last
    d_s, v_s = jax.lax.sort((dest, val), dimension=1, num_keys=1, is_stable=False)
    return v_s[:, :Q]


def compact_by_rank2(vals: jax.Array, rank: jax.Array, pred: jax.Array, out_width: int) -> jax.Array:
    """compact_by_rank for arbitrary widths/payloads (2-operand sort)."""
    B, K = vals.shape
    key = jnp.where(pred, rank, jnp.iinfo(jnp.int32).max)
    k_s, v_s = jax.lax.sort((key, vals), dimension=1, num_keys=1, is_stable=False)
    out = v_s[:, :out_width]
    valid = jnp.arange(out_width, dtype=_I32)[None, :] < jnp.sum(
        pred.astype(_I32), axis=1, keepdims=True
    )
    return jnp.where(valid, out, 0)


def compact_by_rank16(vals: jax.Array, rank: jax.Array, pred: jax.Array, out_width: int) -> jax.Array:
    """compact_by_rank with 16-bit payloads via u32 keys.

    vals may use 16 bits (ranks still capped at PB bits). Used for
    dict-reaching distances (delta < 2^16) in the wide assembly.
    """
    B, K = vals.shape
    assert K <= PACK_MAX and out_width <= PACK_MAX
    u32 = jnp.uint32
    key = jnp.where(pred, rank, PACK_MAX).astype(u32) << 16
    s = jax.lax.sort(key | vals.astype(u32), dimension=1, is_stable=False)
    out = (s[:, :out_width] & jnp.asarray(0xFFFF, u32)).astype(_I32)
    valid = jnp.arange(out_width, dtype=_I32)[None, :] < jnp.sum(
        pred.astype(_I32), axis=1, keepdims=True
    )
    return jnp.where(valid, out, 0)


def compact_by_rank(vals: jax.Array, rank: jax.Array, pred: jax.Array, out_width: int) -> jax.Array:
    """out[b, rank[b, k]] = vals[b, k] for pred; one packed sort.

    rank must be a bijection onto 0..count-1 over pred positions (e.g. an
    exclusive cumsum of pred). Slots past a block's count read 0.
    """
    B, K = vals.shape
    assert K <= PACK_MAX and out_width <= PACK_MAX
    key = jnp.where(pred, rank, PACK_MAX) << PB  # filler sorts after all ranks
    s = jax.lax.sort(key | vals, dimension=1, is_stable=False)
    out = s[:, :out_width] & (PACK_MAX - 1)
    # slots at/past count hold the PACK_MAX-1 filler key's payload; zero them
    valid = jnp.arange(out_width, dtype=_I32)[None, :] < jnp.sum(
        pred.astype(_I32), axis=1, keepdims=True
    )
    return jnp.where(valid, out, 0)
