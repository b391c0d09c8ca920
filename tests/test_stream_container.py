"""Bounded-memory NLZP container streaming drivers (parallel/stream.py).

The streaming encoder/decoder must (a) round-trip, (b) interoperate both
directions with the in-memory container path, and (c) produce
byte-identical archives to the in-memory encoder whenever a single
bucket covers the file (multi-bucket wide archives differ only in the
priors source, by design). Mirrors the reference's fixed-buffer driver
behavior (/root/reference/NLZM.cpp:1870-1885, 2014-2018) at container
granularity.
"""


import pytest

from nlzm_tpu import native
from nlzm_tpu.parallel.blocks import decode_container, encode_container
from nlzm_tpu.parallel.stream import (
    decode_container_stream, encode_container_stream, read_container_head)


@pytest.fixture
def paths(tmp_path):
    return tmp_path / "in.bin", tmp_path / "out.nlzp", tmp_path / "rt.bin"


def _write(src, data):
    src.write_bytes(data)


def test_v1_stream_encode_byte_identical(corpus_text, paths):
    """v1 streaming encode (no priors) must produce the same archive as
    the in-memory encoder regardless of bucketing."""
    if not native.available():
        pytest.skip("native lib not built")
    src, dst, _ = paths
    data = corpus_text(150_000)
    _write(src, data)
    r = encode_container_stream(
        str(src), str(dst), 16384, parser="optimal", bucket_bytes=40_000)
    mem = encode_container(data, block_size=16384, parser="optimal")
    assert dst.read_bytes() == mem
    assert r["out"] == len(mem)


def test_wide_stream_single_bucket_byte_identical(corpus_text, paths):
    if not native.available():
        pytest.skip("native lib not built")
    src, dst, _ = paths
    data = corpus_text(120_000)
    _write(src, data)
    encode_container_stream(
        str(src), str(dst), 16384, parser="optimal", profile="wide",
        dict_size=8192)
    mem = encode_container(
        data, block_size=16384, parser="optimal", profile="wide",
        dict_size=8192)
    assert dst.read_bytes() == mem


def test_wide_stream_multibucket_roundtrip(corpus_text, paths):
    """Multi-bucket wide: priors come from bucket 0 only, so the archive
    differs from the in-memory one - but it must round-trip through BOTH
    the streaming and the in-memory decoders."""
    if not native.available():
        pytest.skip("native lib not built")
    src, dst, rt = paths
    data = corpus_text(200_000)
    _write(src, data)
    encode_container_stream(
        str(src), str(dst), 16384, parser="optimal", profile="wide",
        dict_size=8192, bucket_bytes=50_000)
    blob = dst.read_bytes()
    assert decode_container(blob) == data  # in-memory decode of streamed file
    r = decode_container_stream(str(dst), str(rt), bucket_bytes=50_000)
    assert rt.read_bytes() == data
    assert r["out"] == len(data)


def test_stream_decode_of_memory_archive(corpus_text, paths):
    """The streaming decoder consumes archives written by the in-memory
    encoder (same wire), v1 and wide, device and native engines."""
    if not native.available():
        pytest.skip("native lib not built")
    src, dst, rt = paths
    data = corpus_text(120_000)
    for kwargs, engines in (
        (dict(profile="wide", dict_size=8192), ("device", "native")),
        (dict(), ("device", "native")),
    ):
        blob = encode_container(
            data, block_size=16384, parser="optimal", **kwargs)
        dst.write_bytes(blob)
        for eng in engines:
            if rt.exists():
                rt.unlink()
            decode_container_stream(
                str(dst), str(rt), engine=eng, bucket_bytes=50_000)
            assert rt.read_bytes() == data, (kwargs, eng)
        dst.unlink()


def test_stream_head_matches_memory_parse(corpus_text, paths):
    from nlzm_tpu.parallel.blocks import parse_container

    if not native.available():
        pytest.skip("native lib not built")
    src, dst, _ = paths
    data = corpus_text(90_000)
    _write(src, data)
    encode_container_stream(
        str(src), str(dst), 16384, parser="optimal", profile="wide",
        dict_size=4096, bucket_bytes=30_000)
    blob = dst.read_bytes()
    info_mem = parse_container(blob)
    with open(dst, "rb") as f:
        info_st = read_container_head(f)
    assert info_st.payload_off == info_mem.payload_off
    assert info_st.comp_sizes == info_mem.comp_sizes
    assert info_st.num_cmds == info_mem.num_cmds
    assert info_st.crc32 == info_mem.crc32
    assert info_st.dictionary == info_mem.dictionary
    assert info_st.wide_priors == info_mem.wide_priors


def test_stream_test_mode_and_crc_failure(corpus_text, paths):
    """dst=None is the reference's `t` mode; a corrupted payload byte
    must surface as IntegrityError from the stored CRC."""
    from nlzm_tpu.parallel.blocks import IntegrityError

    if not native.available():
        pytest.skip("native lib not built")
    src, dst, _ = paths
    data = corpus_text(80_000)
    _write(src, data)
    encode_container_stream(str(src), str(dst), 16384, parser="optimal")
    r = decode_container_stream(str(dst), None)
    assert r["out"] == len(data)

    from nlzm_tpu.parallel.blocks import parse_container

    blob = bytearray(dst.read_bytes())
    info = parse_container(bytes(blob))
    blob[info.payload_off + info.comp_sizes[0] // 2] ^= 0x40  # mid-payload bit
    dst.write_bytes(bytes(blob))
    # either the native frame decoder rejects the stream outright
    # (RuntimeError) or the stored CRC catches it (IntegrityError)
    with pytest.raises((IntegrityError, ValueError, RuntimeError)):
        decode_container_stream(str(dst), None, engine="native")


def test_cli_streams_container_files(corpus_text, tmp_path):
    """CLI c/d with -blocks goes through the streaming drivers."""
    if not native.available():
        pytest.skip("native lib not built")
    from nlzm_tpu.cli import main

    data = corpus_text(100_000)
    src = tmp_path / "f.bin"
    dst = tmp_path / "f.nlzp"
    rt = tmp_path / "f.rt"
    src.write_bytes(data)
    assert main(["-blocks:16384", "c", str(src), str(dst)]) == 0
    assert main(["d", str(dst), str(rt)]) == 0
    assert rt.read_bytes() == data
    # wide profile with a dictionary through the flags
    dst2 = tmp_path / "g.nlzp"
    rt2 = tmp_path / "g.rt"
    assert main(["-blocks:16384", "-profile:wide", "-dict:4096",
                 "c", str(src), str(dst2)]) == 0
    assert main(["d", str(dst2), str(rt2)]) == 0
    assert rt2.read_bytes() == data
