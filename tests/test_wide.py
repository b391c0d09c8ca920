"""Wide profile: host codec, device decoder, container round trips."""

import numpy as np
import pytest

from nlzm_tpu.format import wide
from nlzm_tpu.parallel.blocks import decode_container, encode_container


def _synthetic_cmds(T, seed=42):
    rng = np.random.default_rng(seed)
    op_len, op_val = [], []
    pos = 0
    for _ in range(T):
        if rng.random() < 0.55 or pos < 8:
            op_len.append(0)
            op_val.append(int(rng.integers(0, 256)))
            pos += 1
        else:
            d = int(rng.integers(1, min(pos, 5000)))
            mmin = int(wide.mmin_of(np.asarray([d]))[0])
            l = mmin + int(rng.integers(0, 80))
            op_len.append(l)
            op_val.append(d)
            pos += l
    return np.asarray(op_len), np.asarray(op_val)


def test_host_roundtrip_commands():
    op_len, op_val = _synthetic_cmds(2500)
    op_rep = wide.classify_reps_wide(op_len, op_val)
    payload = wide.encode_wide_block(op_len, op_val, op_rep)
    dl, dv = wide.decode_wide_block(payload)
    assert np.array_equal(dl, op_len)
    assert np.array_equal(dv, op_val)


def test_host_roundtrip_with_priors():
    """The host reference decoder must mirror the priors seeding exactly
    (format/wide.py is format-defining for all three implementations)."""
    op_len, op_val = _synthetic_cmds(2000, seed=7)
    op_rep = wide.classify_reps_wide(op_len, op_val)
    payloads, blob = wide.encode_wide_blocks(
        np.asarray(op_len)[:, None], np.asarray(op_val)[:, None],
        np.asarray(op_rep)[:, None], with_priors=True,
    )
    assert blob
    dl, dv = wide.decode_wide_block(payloads[0], blob)
    assert np.array_equal(dl, op_len)
    assert np.array_equal(dv, op_val)


@pytest.mark.parametrize("plane_idx", [1, 4])
def test_device_plane_matches_host_encoder(plane_idx):
    """Generic plane_scan vs the host encoder: lit (256-symbol joint
    alphabet) and dst (64 symbols); both single-row under wire v4. The
    multi-row machinery is pinned separately by
    test_generic_multirow_plane_machinery."""
    import jax.numpy as jnp

    from nlzm_tpu.ops.wide_decode import plane_scan

    rng = np.random.default_rng(3)
    spec = wide.PLANES[plane_idx]
    alph = spec.alphabets[0]
    n_rows = spec.rows[0]
    B = 3
    counts = np.array([700, 1023, 1])
    steps = wide.padded_steps(int(counts.max()), spec.lanes)
    T_pad = steps * spec.lanes
    syms0 = np.zeros((B, T_pad), np.int64)
    rows0 = np.zeros((B, T_pad), np.int64)
    for b in range(B):
        n = counts[b]
        syms0[b, :n] = rng.integers(0, alph, n)
        if n_rows > 1:
            rows0[b, :n] = rng.integers(0, n_rows, n)
    streams, offsets = wide._rans_encode_plane(
        spec, [syms0], [rows0], counts, B
    )

    from nlzm_tpu.ops.wide_decode import stage_plane

    seeds, wins = stage_plane(streams, list(offsets), plane_idx, steps)
    (y0,) = plane_scan(
        seeds,
        wins,
        jnp.asarray(counts, np.int32),
        jnp.asarray(rows0, jnp.int32),
        plane_idx,
        steps,
    )
    y0 = np.asarray(y0)
    for b in range(B):
        n = counts[b]
        assert np.array_equal(y0[b, :n], syms0[b, :n])


@pytest.mark.parametrize("name", ["text", "repetitive", "random", "zeros"])
def test_wide_container_roundtrip(corpus_samples, name):
    data = corpus_samples[name]
    c = encode_container(data, block_size=4096, parser="optimal", profile="wide")
    assert decode_container(c) == data


def test_wide_container_text(corpus_text):
    data = corpus_text(70000)
    c = encode_container(data, block_size=32768, parser="optimal", profile="wide")
    assert decode_container(c) == data
    # throughput profile still compresses text substantially (v2 lanes
    # carry ~1.7 KB/block of seeds - noticeable at this tiny size only)
    assert len(c) < len(data) * 0.58


def test_wide_empty():
    c = encode_container(b"", profile="wide", block_size=4096)
    assert decode_container(c) == b""


def test_wide_corruption_detected(corpus_text):
    from nlzm_tpu.parallel.blocks import IntegrityError, parse_container

    data = corpus_text(20000)
    c = bytearray(encode_container(data, block_size=4096, parser="optimal", profile="wide"))
    info = parse_container(bytes(c))
    # flip a byte mid-payload, inside a plane's renorm pairs: a byte near
    # the front can be a lane seed whose low bits never change a symbol,
    # which leaves the output (and its CRC) intact
    c[info.payload_off + info.comp_sizes[0] // 2] ^= 0xFF
    with pytest.raises(IntegrityError):
        decode_container(bytes(c))


def test_wide_deep_chains_rle():
    """Adversarial overlap/RLE data exercises deep ancestor chains, the
    modular-parent collapse, and the container's depth round budget."""
    data = (b"\x00" * 5000) + (b"ab" * 4000) + (b"xyz" * 3000) + b"tail" * 500
    c = encode_container(data, block_size=8192, parser="optimal", profile="wide")
    assert decode_container(c) == data


def test_wide_sharded_mesh_roundtrip(corpus_text):
    """Wide decode sharded over the virtual 8-device mesh (DP blocks,
    padded to the device count, container depth budget active)."""
    from nlzm_tpu.parallel.mesh import decode_wide_sharded, make_mesh

    data = corpus_text(30000)
    c = encode_container(data, block_size=4096, parser="optimal", profile="wide")
    mesh = make_mesh()
    assert decode_wide_sharded(c, mesh) == data


def test_wide_greedy_device_parse(corpus_samples):
    """The device-parse branch (greedy parser) must also produce valid
    wide containers (regression: depth meta was only set on the native
    path)."""
    data = corpus_samples["text"][:6000]
    c = encode_container(data, block_size=4096, parser="greedy", profile="wide")
    assert decode_container(c) == data


def test_three_way_differential_with_priors():
    """Host decoder and device decoder must produce identical command
    arrays from the same priors-bearing payloads (mirror-exactness of the
    three format implementations)."""
    import numpy as np

    from nlzm_tpu.ops.wide_decode import decode_wide_blocks

    T = 900
    cols = []
    for seed in (11, 12, 13):
        ol, ov = _synthetic_cmds(T, seed=seed)
        cols.append((ol, ov))
    # ragged: trim each block differently
    trims = (T, 700, 123)
    op_len = np.full((T, 3), -1, np.int64)
    op_val = np.zeros((T, 3), np.int64)
    for b, ((ol, ov), n) in enumerate(zip(cols, trims)):
        op_len[:n, b] = ol[:n]
        op_val[:n, b] = ov[:n]
        op_rep_b = wide.classify_reps_wide(ol[:n], ov[:n])
    op_rep = np.full((T, 3), -1, np.int64)
    for b, ((ol, ov), n) in enumerate(zip(cols, trims)):
        op_rep[:n, b] = wide.classify_reps_wide(ol[:n], ov[:n])

    payloads, blob = wide.encode_wide_blocks(op_len, op_val, op_rep, with_priors=True)

    # host mirror per block
    for b, n in enumerate(trims):
        dl, dv = wide.decode_wide_block(payloads[b], blob)
        assert np.array_equal(dl[:n], op_len[:n, b])
        assert np.array_equal(dv[:n], op_val[:n, b])

    # device path end-to-end: expand both ways and compare bytes
    from nlzm_tpu import native

    if native.available():
        N = 1 << 15
        outs = []
        for b, n in enumerate(trims):
            outs.append(
                native.expand_ops(
                    np.ascontiguousarray(op_len[:n, b].astype(np.int32)),
                    np.ascontiguousarray(op_val[:n, b].astype(np.int32)),
                    N,
                )
            )
        # device output is slotted at block_size boundaries
        expected = b"".join(o.ljust(N, b"\x00") for o in outs)
        got = decode_wide_blocks(payloads, N, 3 * N, blob)
        assert got == expected


@pytest.mark.slow
@pytest.mark.parametrize("bs", [65536, 131072])
def test_wide_big_block_roundtrip(corpus_text, bs):
    """Big-block wide profile (2-operand sort path, > PACK_MAX)."""
    data = corpus_text(3 * bs // 2 + 12345)  # one full + one short block
    c = encode_container(data, block_size=bs, parser="optimal", profile="wide")
    assert decode_container(c) == data
    # host decoders agree
    assert decode_container(c, engine="serial") == data


def test_device_plane_encoder_byte_identical():
    """The jit plane encoder (ops/wide_encode_dev.py) must produce
    payloads byte-identical to the host numpy encoder - the four-way
    differential (numpy / C++ / device encode, host / device decode)."""
    import numpy as np

    from nlzm_tpu import native
    from nlzm_tpu.ops.wide_encode_dev import encode_wide_blocks_device
    from nlzm_tpu.utils.corpus import build_nonperiodic

    if not native.available():
        pytest.skip("native lib not built")
    data = build_nonperiodic(200_000)
    op_len, op_val = native.parse_blocks(data, 32768, 15)
    op_len = np.ascontiguousarray(op_len, np.int32)
    op_val = np.ascontiguousarray(op_val, np.int32)
    native.lift_deep(op_len, op_val, 32768)
    op_rep = native.classify_reps(op_len, op_val)
    ph, bh = wide.encode_wide_blocks(op_len, op_val, op_rep)
    pd, bd = encode_wide_blocks_device(op_len, op_val, op_rep)
    assert bh == bd
    assert ph == pd


def test_generic_multirow_plane_machinery(monkeypatch):
    """Wire v4 made every live plane single-row, but plane_scan /
    _rans_encode_plane keep the general multi-row machinery (row-keyed
    tables selected per lane) for future wire revisions. Pin it with a
    synthetic 4-row 16-symbol spec: host encode -> device scan must
    return the exact symbols."""
    import jax.numpy as jnp

    from nlzm_tpu.format import wide
    from nlzm_tpu.ops import wide_decode

    spec = wide.PlaneSpec("dst", 8, 1, (16,), (4,))
    planes = wide.PLANES[:4] + (spec,)
    monkeypatch.setattr(wide, "PLANES", planes)
    monkeypatch.setattr(wide_decode, "PLANES", planes)

    rng = np.random.default_rng(11)
    B = 2
    counts = np.array([300, 41])
    steps = wide.padded_steps(int(counts.max()), spec.lanes)
    T_pad = steps * spec.lanes
    syms0 = np.zeros((B, T_pad), np.int64)
    rows0 = np.zeros((B, T_pad), np.int64)
    for b in range(B):
        n = counts[b]
        syms0[b, :n] = rng.integers(0, 16, n)
        rows0[b, :n] = rng.integers(0, 4, n)
    streams, offsets = wide._rans_encode_plane(spec, [syms0], [rows0], counts, B)
    seeds, wins = wide_decode.stage_plane(streams, list(offsets), 4, steps)
    (y0,) = wide_decode.plane_scan(
        seeds, wins, jnp.asarray(counts, np.int32),
        jnp.asarray(rows0, jnp.int32), 4, steps,
    )
    y0 = np.asarray(y0)
    for b in range(B):
        assert np.array_equal(y0[b, : counts[b]], syms0[b, : counts[b]])
