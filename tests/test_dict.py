"""Container shared-dictionary tests (wide profile long-range reach).

The dictionary is sampled once per container (parallel/blocks.py::
sample_dict), preloaded into the native matchers per block at encode, and
resolved by the device expander via dict-shifted parent coordinates
(ops/expand_ops.py). These tests pin: all-engine round trips, the
device/native/serial agreement, the ratio benefit, depth bookkeeping, and
corruption behavior.
"""

import numpy as np
import pytest

from nlzm_tpu import native
from nlzm_tpu.parallel.blocks import (
    FLAG_DICT,
    decode_container,
    encode_container,
    parse_container,
    sample_dict,
)

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib not built"
)


@pytest.fixture(scope="module")
def drift_corpus():
    from nlzm_tpu.utils.corpus import build_nonperiodic

    return build_nonperiodic(400_000)


@pytest.fixture(scope="module")
def dict_container(drift_corpus):
    return encode_container(
        drift_corpus, block_size=32768, parser="optimal", profile="wide",
        dict_size=32768,
    )


def test_dict_flag_and_payload(dict_container):
    info = parse_container(dict_container)
    assert info.dictionary is not None and len(info.dictionary) == 32768
    assert info.wide


def test_dict_roundtrip_all_engines(drift_corpus, dict_container):
    assert decode_container(dict_container, engine="native") == drift_corpus
    assert decode_container(dict_container, engine="serial") == drift_corpus
    assert decode_container(dict_container, engine="device") == drift_corpus


def test_dict_improves_ratio(drift_corpus, dict_container):
    plain = encode_container(
        drift_corpus, block_size=32768, parser="optimal", profile="wide"
    )
    # measured -7.2% on this corpus class; guard half of it
    assert len(dict_container) < len(plain) * 0.97


def test_dict_depths_within_cap(dict_container):
    info = parse_container(dict_container)
    assert max(info.total_reads) <= 16  # encode-side lift-split cap


def test_dict_big_block_roundtrip(drift_corpus):
    c = encode_container(
        drift_corpus, block_size=65536, parser="optimal", profile="wide",
        dict_size=65536,
    )
    assert decode_container(c, engine="device") == drift_corpus
    assert decode_container(c, engine="native") == drift_corpus


def test_dict_corruption_detected(drift_corpus, dict_container):
    """A LIVE stream byte flip must fail the container CRC.

    The flip targets the first renorm pair of the tok plane: an early
    pair feeds lane states with thousands of active symbols still to
    decode, so the corruption always reaches the output. (Bytes near a
    plane's tail can land in lanes' FINAL refills - state consumed after
    the last active symbol and then discarded - where a flip provably
    cannot change any output byte; the CRC correctly passes there.)
    """
    from nlzm_tpu.format.wide import (
        HDR_BYTES, N_PLANES, PLANES, chunk_schedule, padded_steps,
    )
    from nlzm_tpu.parallel.blocks import IntegrityError, block_payloads

    info = parse_container(dict_container)
    payload = block_payloads(dict_container, info)[0]
    tables = 0
    for i in range(N_PLANES):
        sym_count = int.from_bytes(payload[8 * i : 8 * i + 4], "big")
        nc = len(chunk_schedule(padded_steps(sym_count, PLANES[i].lanes)))
        tables += 2 * (nc - 1)
    first_tok_pair = HDR_BYTES + tables + 4 * PLANES[0].lanes
    blob = bytearray(dict_container)
    blob[info.payload_off + first_tok_pair] ^= 0xFF
    with pytest.raises((IntegrityError, ValueError)):
        decode_container(bytes(blob), engine="device")


def test_sample_dict_deterministic(drift_corpus):
    d1 = sample_dict(drift_corpus, 32768)
    d2 = sample_dict(drift_corpus, 32768)
    assert d1 == d2 and len(d1) == 32768
    assert sample_dict(b"short", 32768) == b""  # input smaller than dict


def test_dict_requires_native_optimal(drift_corpus):
    with pytest.raises(ValueError):
        encode_container(
            drift_corpus, block_size=32768, parser="greedy", profile="wide",
            dict_size=32768, engine="device",
        )


def test_native_expand_dict_matches_device(drift_corpus, dict_container):
    """expand_ops (C++) and lz_expand_parallel (device) agree per block."""
    import jax.numpy as jnp

    from nlzm_tpu.format.wide import decode_wide_block
    from nlzm_tpu.ops.expand_ops import lz_expand_parallel
    from nlzm_tpu.parallel.blocks import block_payloads

    info = parse_container(dict_container)
    payload = block_payloads(dict_container, info)[1]
    ol, ov = decode_wide_block(payload, info.wide_priors)
    ol = np.asarray(ol, np.int32)
    ov = np.asarray(ov, np.int32)
    host = native.expand_ops(ol, ov, info.block_size, info.dictionary)
    out, _ = lz_expand_parallel(
        jnp.asarray(ol)[:, None], jnp.asarray(ov)[:, None], info.block_size,
        None, jnp.asarray(np.frombuffer(info.dictionary, np.uint8)),
    )
    assert np.asarray(out)[0, : len(host)].tobytes() == host
