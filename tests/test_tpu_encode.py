"""Batched device encoder vs the other engines."""

import pytest

from nlzm_tpu import native
from nlzm_tpu.parallel.blocks import decode_container, encode_container


@pytest.mark.parametrize("name", ["text", "repetitive", "random", "zeros"])
def test_tpu_encode_cross_decodes(corpus_samples, name):
    data = corpus_samples[name]
    c = encode_container(data, block_size=4096, parser="greedy", engine="device")
    assert decode_container(c, engine="serial") == data
    assert decode_container(c, engine="device") == data


def test_tpu_encode_native_decode(corpus_text):
    if not native.available():
        pytest.skip("native lib not built")
    data = corpus_text(60000) + b"#"
    c = encode_container(data, block_size=8192, parser="greedy", engine="device")
    assert decode_container(c, engine="native") == data


@pytest.mark.parametrize("name", ["text", "repetitive", "random"])
def test_tpu_optimal_parse_cross_decodes(corpus_samples, name):
    data = corpus_samples[name]
    c = encode_container(data, block_size=4096, parser="optimal", engine="device")
    assert decode_container(c, engine="serial") == data
    assert decode_container(c, engine="device") == data


def test_tpu_optimal_parse_beats_greedy(corpus_text):
    data = corpus_text(49152)
    greedy = encode_container(data, block_size=8192, parser="greedy", engine="device")
    opt = encode_container(data, block_size=8192, parser="optimal", engine="device")
    assert decode_container(opt, engine="serial") == data
    assert len(opt) < len(greedy)


def test_tpu_encode_rep_commands():
    """Structured (fixed-stride) data: repify must convert recurring
    distances into rep commands, shrink the payload, and still
    cross-decode everywhere."""
    import jax.numpy as jnp

    from nlzm_tpu.ops import encode_ops as E

    recs = [b"%08d,SENSOR_%02d,%06d,OK;" % (i, i % 16, (i * 2654435761) % 999983) for i in range(2000)]
    data = b"".join(recs)[:48000]
    c = encode_container(data, block_size=8192, engine="device")
    assert decode_container(c, engine="serial") == data
    assert decode_container(c, engine="device") == data

    # rep conversion happens and is wire-cheaper on this corpus
    import numpy as np

    N, n = 8192, len(data)
    nb = (n + N - 1) // N
    arr = np.zeros((nb, N), np.uint8)
    flat = np.frombuffer(data, np.uint8)
    for b in range(nb):
        seg = flat[b * N : (b + 1) * N]
        arr[b, : len(seg)] = seg
    nv = np.minimum(N, n - np.arange(nb) * N).astype(np.int32)
    dj, nvj = jnp.asarray(arr), jnp.asarray(nv)
    delta, mlen = E.find_matches(dj, nvj, (1 << 13) - 1)
    op_len, op_val = E.greedy_cover(dj, delta, mlen, nvj, ((N + 255) // 256) * 256)
    op_rep = E.repify(op_len, op_val)
    assert int(jnp.sum(op_rep >= 0)) > 100

    sizes = {}
    for name, rep in [("norep", jnp.full_like(op_len, -1)), ("rep", op_rep)]:
        spans, fields, nops = E.emit_model(op_len, op_val, rep)
        _, rans_bytes = E.rans_backward(spans, 4096 * 8)
        _, bn = E.bits_forward(fields, 4096 * 4)
        sizes[name] = int(jnp.sum(rans_bytes) + jnp.sum(bn))
    assert sizes["rep"] < sizes["norep"]


def test_tpu_encode_empty():
    assert decode_container(encode_container(b"", engine="device"), engine="serial") == b""


def test_tpu_encode_single_frame_cap():
    # blocks must fit one frame in the device profile
    from nlzm_tpu.ops.encode_ops import encode_blocks_device

    with pytest.raises(ValueError):
        encode_blocks_device(b"x" * 100000, 65536, 14)


def test_device_parse_big_blocks():
    """Device parse above 32 KiB (2-operand sort grouping): 128 KiB wide
    blocks round-trip and land within 2% of the native parse's size."""
    from nlzm_tpu import native
    from nlzm_tpu.utils.corpus import build_nonperiodic

    if not native.available():
        pytest.skip("native lib not built")
    data = build_nonperiodic(262144)
    dev = encode_container(
        data, block_size=131072, parser="optimal", profile="wide", engine="device"
    )
    assert decode_container(dev, engine="native") == data
    nat = encode_container(
        data, block_size=131072, parser="optimal", profile="wide", engine="native"
    )
    assert len(dev) <= len(nat) * 1.02


def test_wide_engine_tpu_uses_device_emitter():
    """engine="device" wide encode is fully device-resident: device parse
    feeds the device plane encoder, whose payloads are byte-identical to
    the host encoder run on the same parsed ops."""
    from nlzm_tpu import native
    from nlzm_tpu.format.wide import encode_wide_blocks
    from nlzm_tpu.ops.encode_ops import parse_blocks_device
    from nlzm_tpu.parallel.blocks import block_payloads, parse_container
    from nlzm_tpu.utils.corpus import build_nonperiodic

    if not native.available():
        pytest.skip("native lib not built")
    data = build_nonperiodic(100_000)
    c = encode_container(
        data, block_size=32768, parser="optimal", profile="wide", engine="device"
    )
    assert decode_container(c, engine="serial") == data
    op_len, op_val, op_rep, _ = parse_blocks_device(data, 32768, 15, "optimal")
    host_payloads, _ = encode_wide_blocks(op_len, op_val, op_rep)
    assert block_payloads(c, parse_container(c)) == host_payloads
