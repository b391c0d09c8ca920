"""Engine parity for depth lifting: Python fallback vs native lift_deep.

parse_blocks_device silently falls back to ops/encode_ops.py::
lift_deep_matches when the native library is absent; both claim identical
semantics (64-iteration lift budget, non-overlap-only lifting, command-
boundary stop). This pins op_val and depth outputs equal on identical
inputs.
"""

import numpy as np
import pytest

from nlzm_tpu import native
from nlzm_tpu.ops.encode_ops import lift_deep_matches

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib not built"
)


def _parse_real_blocks(n_bytes=131072, block_size=32768):
    from nlzm_tpu.utils.corpus import build_nonperiodic

    data = build_nonperiodic(n_bytes)
    op_len, op_val = native.parse_blocks(data, block_size, 15)
    return (
        np.ascontiguousarray(op_len, np.int32),
        np.ascontiguousarray(op_val, np.int32),
        block_size,
    )


def test_lift_parity_on_parsed_blocks():
    op_len, op_val, bs = _parse_real_blocks()
    ol_py, ov_py = op_len.copy(), op_val.copy()
    ol_nat, ov_nat = op_len.copy(), op_val.copy()
    d_py = lift_deep_matches(ol_py, ov_py, cap=15)
    d_nat = native.lift_deep(ol_nat, ov_nat, bs, cap=15, threads=1)
    np.testing.assert_array_equal(ov_py, ov_nat)
    np.testing.assert_array_equal(ol_py, ol_nat)
    np.testing.assert_array_equal(d_py, d_nat)


def test_lift_parity_aggressive_cap():
    op_len, op_val, bs = _parse_real_blocks(65536)
    ol_py, ov_py = op_len.copy(), op_val.copy()
    ol_nat, ov_nat = op_len.copy(), op_val.copy()
    d_py = lift_deep_matches(ol_py, ov_py, cap=4)
    d_nat = native.lift_deep(ol_nat, ov_nat, bs, cap=4, threads=1)
    np.testing.assert_array_equal(ov_py, ov_nat)
    np.testing.assert_array_equal(d_py, d_nat)


def test_fallback_warns_on_multiblock(monkeypatch):
    import warnings

    from nlzm_tpu.ops import encode_ops

    monkeypatch.setattr(native, "available", lambda: False)
    data = b"abcd" * 4096
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        encode_ops.parse_blocks_device(data, 4096, 12, "greedy")
    assert any("falls back" in str(x.message) for x in w)


def _expand_all(ol, ov, bs):
    out = bytearray()
    for b in range(ol.shape[1]):
        col = ol[:, b]
        n = int(np.argmax(col < 0)) if (col < 0).any() else ol.shape[0]
        out += native.expand_ops(
            np.ascontiguousarray(ol[:n, b]), np.ascontiguousarray(ov[:n, b]), bs
        )
    return bytes(out)


def test_strict_lift_roundtrip_and_invariant():
    """strict lift_split must (a) round-trip, (b) keep depth <= cap, and
    (c) satisfy the command-map invariant: every match's source image
    (span; the period for overlaps) is all-depth-0 OR within one source
    command and one period of it. Evidence artifact for the measured
    command-level-doubling postmortem (PARITY.md roadmap #1): the mode
    works but costs +9.6% compressed size on the bench mix, which kills
    the expansion win it was meant to buy."""
    from nlzm_tpu.utils.corpus import build_nonperiodic

    data = build_nonperiodic(200_000)
    bs = 16384
    op_len, op_val = native.parse_blocks(data, bs, 15)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    ol, ov, depths = native.lift_split(
        data, op_len.copy(), op_val.copy(), bs, cap=8, strict=True)
    assert depths.max() <= 8
    assert _expand_all(ol, ov, bs)[: len(data)] == data

    for b in range(ol.shape[1]):
        col, vals = ol[:, b], ov[:, b]
        n = int(np.argmax(col < 0)) if (col < 0).any() else ol.shape[0]
        pos = 0
        depth = np.zeros(bs, np.int64)
        cmd = np.full(bs, -1, np.int64)
        m_of = []
        for k in range(n):
            l, d = int(col[k]), int(vals[k])
            m_of.append(pos)
            if l == 0:
                cmd[pos] = k
                pos += 1
                continue
            s = pos - d
            w = min(l, d)
            assert s >= 0, "no dict in this test"
            span = range(s, s + w)
            dm = max(depth[j] for j in span)
            if dm > 0:
                c0 = cmd[s]
                ok = all(cmd[j] == c0 for j in span)
                if ok and col[c0] > 0 and col[c0] > vals[c0]:
                    m0, d0 = m_of[c0], int(vals[c0])
                    ok = (s - m0) // d0 == (s + w - 1 - m0) // d0
                assert ok, f"invariant violated at block {b} cmd {k}"
            for i in range(l):
                if pos + i >= bs:
                    break
                depth[pos + i] = depth[s + (i % w)] + 1
                cmd[pos + i] = k
            pos += l
