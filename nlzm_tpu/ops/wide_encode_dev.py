"""Device (jit) wide-profile plane encoder.

Port of format/wide.py::_rans_encode_plane to the device: the forward pass
simulates the decoder's chunk-adaptive tables against KNOWN symbols
(same deterministic rebuild as ops/wide_decode.plane_scan, so encoder
and decoder tables agree by construction), recording each symbol's
(start, freq) span; the backward pass is a reverse lax.scan advancing L
interleaved rANS lanes per step, emitting 16-bit renorm pairs exactly
where the host encoder does. Payload bytes are byte-identical to the
host encoder's (tests diff them; the three-way host/native differential
becomes four-way).

The rANS state fits u32 throughout (the reference's 32-bit rANS,
NLZM.cpp:444-455); the renorm predicate x >= freq << 18 is evaluated as
(x >> 18) >= freq to avoid the u32 overflow at freq = 2^14.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import CDF_SCALE_BITS
from ..format.wide import PLANES, chunk_schedule
from .wide_decode import _build_cdf_jnp, _uniform_tables

_I32 = jnp.int32
_U32 = jnp.uint32


@partial(jax.jit, static_argnames=("plane_idx", "steps"))
def plane_encode(syms, rows, n_sym, plane_idx: int, steps: int, prior=None):
    """Encode one plane for all blocks.

    syms/rows: per read r, [B, steps*L] i32 symbol / context-row arrays;
    rows[r] may be None for single-row reads (no context; avoids
    shipping a same-shaped all-zero array to the device).
    n_sym: [B] symbol counts. prior: optional per-read [rows, 16] counts.
    Returns (seeds [B, L] u32 final lane states, pairs [B, steps*R*L]
    i32 renorm pair values in decode order, flags [B, steps*R*L] bool
    emission mask).
    """
    spec = PLANES[plane_idx]
    L, R = spec.lanes, spec.reads
    # symbols may arrive as uint8 (every plane alphabet fits a byte):
    # the staging path ships 1/4 of the i32 bytes and casts here
    syms = tuple(s.astype(_I32) for s in syms)
    B = syms[0].shape[0]
    f32 = jnp.float32
    PX = jax.lax.Precision.HIGHEST

    lane_iota = jnp.arange(L, dtype=_I32)
    t_iota = jnp.arange(steps, dtype=_I32)
    active_t = (
        (t_iota[:, None, None] * L + lane_iota[None, None, :]) < n_sym[None, :, None]
    )  # [steps, B, L]
    syms_t = [s.reshape(B, steps, L).transpose(1, 0, 2) for s in syms]
    rows_t = [
        jnp.zeros((steps, B, 1), _I32) if rows[r] is None
        else rows[r].reshape(B, steps, L).transpose(1, 0, 2)
        for r in range(R)
    ]

    def span_chunk(tables, rw_c, y_oh, acta, single_row):
        """(start, freq) for a whole chunk's symbols at once (tables are
        chunk-static, so no per-step scan is needed on the encode side -
        symbols are KNOWN; one fat contraction per chunk replaces clen
        thin per-step ops)."""
        tbl = tables.astype(f32)  # [B, rows, alph+1]
        cum, dt = tbl[:, :, :-1], tbl[:, :, 1:] - tbl[:, :, :-1]
        if single_row:
            st = jnp.einsum("tbls,bs->tbl", y_oh, cum[:, 0], precision=PX)
            fq = jnp.einsum("tbls,bs->tbl", y_oh, dt[:, 0], precision=PX)
            cnt = jnp.einsum("tbls,tbl->bs", y_oh, acta, precision=PX)[:, None, :]
        else:
            row_oh = jax.nn.one_hot(rw_c, tables.shape[1], dtype=f32)
            st = jnp.einsum("tblr,tbls,brs->tbl", row_oh, y_oh, cum, precision=PX)
            fq = jnp.einsum("tblr,tbls,brs->tbl", row_oh, y_oh, dt, precision=PX)
            cnt = jnp.einsum(
                "tblr,tbls,tbl->brs", row_oh, y_oh, acta, precision=PX
            )
        return st.astype(_I32), fq.astype(_I32), cnt.astype(_I32)

    def chunk_body(carry, xs):
        tables, carries = carry
        ys_c, rws_c, active_c = xs  # [clen, ...]
        acta = active_c.astype(f32)
        starts, freqs = [], []
        new_tables, new_carries = [], []
        for r in range(R):
            y_oh = jax.nn.one_hot(ys_c[r], spec.alphabets[r], dtype=f32)
            st, fq, cnt = span_chunk(
                tables[r], rws_c[r], y_oh, acta, spec.rows[r] == 1
            )
            starts.append(jnp.where(active_c, st, 0))
            freqs.append(jnp.where(active_c, fq, 1))
            carry_r = (carries[r] >> 1) + cnt
            new_carries.append(carry_r)
            new_tables.append(_build_cdf_jnp(carry_r, spec.alphabets[r]))
        return (tuple(new_tables), tuple(new_carries)), (
            jnp.stack(starts, 1),  # [clen, R, B, L]
            jnp.stack(freqs, 1),
        )

    if prior is None:
        tables0 = tuple(_uniform_tables(B, spec.rows[r], spec.alphabets[r]) for r in range(R))
        carries0 = tuple(
            jnp.zeros((B, spec.rows[r], spec.alphabets[r]), _I32) for r in range(R)
        )
    else:
        carries0 = tuple(
            jnp.broadcast_to(
                prior[r][None], (B, spec.rows[r], spec.alphabets[r])
            ).astype(_I32)
            for r in range(R)
        )
        tables0 = tuple(
            _build_cdf_jnp(carries0[r], spec.alphabets[r]) for r in range(R)
        )

    schedule = chunk_schedule(steps)
    runs = []
    for clen in schedule:
        if runs and runs[-1][0] == clen:
            runs[-1][1] += 1
        else:
            runs.append([clen, 1])

    carry = (tables0, carries0)
    st_parts, fq_parts = [], []
    t0 = 0
    for clen, count in runs:
        seg = slice(t0, t0 + clen * count)
        ys_x = tuple(s[seg].reshape(count, clen, B, L) for s in syms_t)
        rw_x = tuple(
            s[seg].reshape(count, clen, B, s.shape[2]) for s in rows_t
        )
        act_x = active_t[seg].reshape(count, clen, B, L)
        carry, (st_c, fq_c) = jax.lax.scan(chunk_body, carry, (ys_x, rw_x, act_x))
        st_parts.append(st_c.reshape(count * clen, R, B, L))
        fq_parts.append(fq_c.reshape(count * clen, R, B, L))
        t0 += clen * count

    starts = jnp.concatenate(st_parts, axis=0)  # [steps, R, B, L]
    freqs = jnp.concatenate(fq_parts, axis=0)

    # ---- backward rANS pass ----
    def bw_body(x, xs):
        st_t, fq_t, active = xs  # [R, B, L], [R, B, L], [B, L]
        pairs, flags = [], []
        for r in range(R - 1, -1, -1):
            fq = fq_t[r].astype(_U32)
            st = st_t[r].astype(_U32)
            over = active & ((x >> 18) >= fq)
            pairs.append((x & jnp.asarray(0xFFFF, _U32)).astype(_I32))
            flags.append(over)
            x1 = jnp.where(over, x >> 16, x)
            x2 = ((x1 // fq) << CDF_SCALE_BITS) + (x1 % fq) + st
            x = jnp.where(active, x2, x)
        # emitted r = R-1..0; reverse to r = 0..R-1 (decode order)
        return x, (jnp.stack(pairs[::-1], 0), jnp.stack(flags[::-1], 0))

    x0 = jnp.full((B, L), 1 << 16, _U32)
    x, (pairs, flags) = jax.lax.scan(
        bw_body, x0, (starts, freqs, active_t), reverse=True
    )
    # [steps, R, B, L] -> [B, steps*R*L] decode order
    pa = pairs.transpose(2, 0, 1, 3).reshape(B, steps * spec.reads * L)
    ma = flags.transpose(2, 0, 1, 3).reshape(B, steps * spec.reads * L)
    return x, pa, ma


def encode_planes_device(batched, priors=None):
    """Run every plane's device encode; returns per-plane
    (streams list[bytes], offsets [B, NC]) like _rans_encode_plane."""
    plane_streams, plane_offsets = [], []
    for i, spec in enumerate(PLANES):
        syms_p, rows_p, counts, _ = batched[spec.name]
        B, T_pad = syms_p[0].shape
        steps = T_pad // spec.lanes
        prior = None
        if priors is not None:
            prior = tuple(
                jnp.asarray(np.asarray(priors[spec.name][r], np.int32))
                for r in range(spec.reads)
            )
        seeds, pa, ma = plane_encode(
            tuple(jnp.asarray(s, _I32) for s in syms_p),
            tuple(
                None if spec.rows[r] == 1 else jnp.asarray(rows_p[r], _I32)
                for r in range(spec.reads)
            ),
            jnp.asarray(counts, _I32),
            i, steps, prior,
        )
        seeds = np.asarray(seeds)
        pa = np.asarray(pa)
        ma = np.asarray(ma)

        # chunk byte offsets (exclusive pair-count prefix x2) from the mask
        sched = chunk_schedule(steps)
        chunk_start_steps = np.cumsum((0,) + sched[:-1])
        pair_per_step = ma.reshape(B, steps, spec.reads * spec.lanes).sum(axis=2)
        cum = np.zeros((B, steps + 1), np.int64)
        np.cumsum(pair_per_step, axis=1, out=cum[:, 1:])
        offsets = 2 * cum[:, chunk_start_steps]

        seed_bytes = (
            np.ascontiguousarray(seeds).astype("<u4").view(np.uint8).reshape(B, 4 * spec.lanes)
        )
        streams = []
        for b in range(B):
            sel = pa[b][ma[b]].astype(">u2")
            streams.append(seed_bytes[b].tobytes() + sel.tobytes())
        plane_streams.append(streams)
        plane_offsets.append(offsets)
    return plane_streams, plane_offsets


def encode_pipeline_device(data: bytes, block_size: int, hist_bits: int = 15):
    """Timed device-encode pipeline for the bench: native forward-graph
    parse (host), vectorized plane batching + H2D staging, and a closure
    running the five on-chip plane encodes, ending in block_until_ready.

    Returns (run, parse_s, stage_fn, staging_first_s). The e2e rate the
    bench reports is parse_s + best_of(stage_fn) + best_of(run) -
    like-for-like against the reference encoder's single-core e2e
    (NLZM.cpp:1711-1910), with the first-touch staging cost reported
    separately (staging_first_ms).
    """
    import time

    from .. import native
    from ..format import wide as _wide

    t0 = time.time()
    op_len, op_val = native.parse_blocks(data, block_size, hist_bits)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    native.lift_deep(op_len, op_val, block_size)
    op_rep = native.classify_reps(op_len, op_val)
    parse_s = time.time() - t0

    staged = []

    def stage():
        """Host plane batching + H2D staging. First call pays numpy
        first-touch page faults; steady-state calls reuse freed arenas -
        the bench reports both, mirroring the decode side's staging_ms /
        staging_first_ms."""
        staged.clear()
        _pb, batched, _pc = _wide.batch_plane_arrays(op_len, op_val, op_rep)
        priors = _wide.build_priors_from_batched(batched)
        for i, spec in enumerate(_wide.PLANES):
            syms_p, rows_p, counts, _ = batched[spec.name]
            steps = syms_p[0].shape[1] // spec.lanes
            prior = tuple(
                jnp.asarray(np.asarray(priors[spec.name][r], np.int32))
                for r in range(spec.reads)
            )
            staged.append((
                # u8 upload: every plane symbol fits a byte (i32
                # would ship ~4 bytes/symbol, ~30 MB per 8 MB encoded)
                tuple(jnp.asarray(s.astype(np.uint8)) for s in syms_p),
                tuple(
                    None if spec.rows[r] == 1 else jnp.asarray(rows_p[r], jnp.int32)
                    for r in range(spec.reads)
                ),
                jnp.asarray(counts, jnp.int32), i, steps, prior))

    t0 = time.time()
    stage()
    staging_first_s = time.time() - t0

    def run():
        outs = [plane_encode(syms, rows, nsym, i, steps, prior)
                for syms, rows, nsym, i, steps, prior in staged]
        jax.block_until_ready(outs)

    return run, parse_s, stage, staging_first_s


def encode_wide_blocks_device(op_len, op_val, op_rep, with_priors: bool = True):
    """Device twin of format.wide.encode_wide_blocks (byte-identical).

    Host: command classification + payload assembly; device: the five
    plane table simulations + backward rANS passes (the dominant cost).
    """
    from ..format.wide import (
        assemble_payloads, batch_plane_arrays, build_priors_from_batched,
        serialize_priors,
    )

    per_block, batched, plane_counts = batch_plane_arrays(op_len, op_val, op_rep)
    priors, blob = None, b""
    if with_priors:
        priors = build_priors_from_batched(batched)
        blob = serialize_priors(priors)
    plane_streams, plane_offsets = encode_planes_device(batched, priors)
    return (
        assemble_payloads(per_block, plane_counts, plane_streams, plane_offsets),
        blob,
    )
