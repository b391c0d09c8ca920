"""Moffat-Turpin canonical Huffman research codec."""

import numpy as np
import pytest

from nlzm_tpu.research import huff0


def test_code_lengths_kraft_and_limit(corpus_samples):
    for d in ["text", "random", "zeros"]:
        counts = np.bincount(np.frombuffer(corpus_samples[d], np.uint8), minlength=256)
        lengths = huff0.code_lengths(counts)
        assert lengths.max() <= huff0.CODE_LEN_LIMIT
        assert lengths.min() >= 1
        assert np.isclose(np.sum(2.0 ** -lengths.astype(np.float64)), 1.0)


def test_skewed_distribution_hits_limit():
    counts = np.ones(256, np.int64)
    counts[0] = 1 << 40  # would want a 1-bit code and push others past 14
    lengths = huff0.code_lengths(counts)
    assert lengths.max() <= huff0.CODE_LEN_LIMIT


@pytest.mark.parametrize("name", ["text", "random", "repetitive", "zeros", "tiny"])
def test_block_container_round_trip(corpus_samples, name):
    data = corpus_samples[name]
    c = huff0.encode(data, block_size=4096)
    assert huff0.decode(c) == data


def test_tpu_decode_matches_host(corpus_text):
    data = corpus_text(40000) + b"\x00\xff"
    c = huff0.encode(data, block_size=8192)
    assert huff0.decode(c, engine="device") == data


def test_adaptive_scheme_round_trip(corpus_text):
    data = corpus_text(50000)
    c = huff0.adaptive_encode(data)
    assert huff0.adaptive_decode(c) == data
    # semi-static adaptation should beat per-symbol-uniform 8 bits on text
    assert len(c) < len(data)


def test_empty():
    assert huff0.decode(huff0.encode(b"")) == b""
    assert huff0.adaptive_decode(huff0.adaptive_encode(b"")) == b""
