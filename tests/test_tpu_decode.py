"""Batched (device-kernel) decode vs the serial reference model."""

import pytest

from nlzm_tpu.parallel.blocks import decode_container, encode_container


@pytest.mark.parametrize("name", ["text", "repetitive", "random", "long_range", "zeros"])
def test_tpu_decode_matches_input(corpus_samples, name):
    data = corpus_samples[name]
    c = encode_container(data, block_size=4096, parser="greedy")
    assert decode_container(c, engine="serial") == data
    assert decode_container(c, engine="device") == data


def test_tpu_decode_multiblock_multiframe(corpus_text):
    # 100 KB over 16 KB blocks at hist_bits 14 (frame chunk 14848) => blocks
    # with 2 frames each, ragged last block
    data = corpus_text(100000) + b"tail"
    c = encode_container(data, block_size=16384, parser="greedy")
    assert decode_container(c, engine="device") == data


def test_tpu_decode_optimal_parser_blocks(corpus_text):
    data = corpus_text(30000)
    c = encode_container(data, block_size=8192, parser="optimal")
    assert decode_container(c, engine="device") == data


def test_tpu_decode_single_tiny_block():
    data = b"abcabcabcabc"
    c = encode_container(data, block_size=4096, parser="greedy")
    assert decode_container(c, engine="device") == data


def test_empty_container():
    c = encode_container(b"")
    assert decode_container(c, engine="device") == b""
    assert decode_container(c, engine="serial") == b""
