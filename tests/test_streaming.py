"""Bounded-memory streaming drivers vs the whole-buffer paths.

The native streaming encoder/decoder must be BYTE-IDENTICAL to the
whole-buffer drivers (same chunk schedule, same window slides), and the
CLI file drivers must keep RSS at O(window) on inputs far larger than
memory would allow whole-buffer.
"""

import os
import subprocess
import sys
from pathlib import Path

import pytest

from nlzm_tpu import native

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native lib not built"
)

REPO = Path(__file__).resolve().parent.parent


def _stream_encode(data: bytes, hist_bits: int, parser: str, feed: int) -> bytes:
    enc = native.StreamEncoder(hist_bits, parser)
    out = bytearray()
    for i in range(0, len(data), feed):
        last = i + feed >= len(data)
        out += enc.feed(data[i : i + feed], final=last)
    if not data:
        out += enc.finish()
    enc.close()
    return bytes(out)


def _stream_decode(payload: bytes, hist_bits: int, feed: int) -> bytes:
    dec = native.StreamDecoder(hist_bits)
    out = bytearray()
    for i in range(0, len(payload), feed):
        out += dec.feed(payload[i : i + feed])
        if dec.done:
            break
    assert dec.done, "sentinel not reached"
    dec.close()
    return bytes(out)


@pytest.mark.parametrize("parser", ["optimal", "greedy"])
@pytest.mark.parametrize("feed", [4096, 1 << 20])
def test_stream_encode_matches_whole_buffer(corpus_text, parser, feed):
    # window 2^16 on a 512 KiB input: several window slides
    data = corpus_text(512 * 1024)
    hist_bits = 16
    whole, _, _ = native.encode_block(data, hist_bits, parser)
    streamed = _stream_encode(data, hist_bits, parser, feed)
    assert streamed == whole


def test_stream_encode_empty_and_tiny(corpus_samples):
    for name in ("empty", "one", "tiny"):
        data = corpus_samples[name]
        whole, _, _ = native.encode_block(data, 12, "optimal")
        assert _stream_encode(data, 12, "optimal", 7) == whole


@pytest.mark.parametrize("feed", [1000, 1 << 18])
def test_stream_decode_matches(corpus_text, feed):
    data = corpus_text(300_000)
    hist_bits = 16
    payload, _, _ = native.encode_block(data, hist_bits, "optimal")
    got = _stream_decode(payload + b"\x00\x00\x00\x00", hist_bits, feed)
    assert got == data


def test_stream_decode_reference_archive(oracle_runner, corpus_text):
    # streamed decode of an archive produced by the reference binary
    data = corpus_text(200_000)
    archive = oracle_runner.compress(data, window_bits=16)
    hist_bits = int.from_bytes(archive[0:2], "big")
    got = _stream_decode(archive[4:], hist_bits, 4096)
    assert got == data


def test_cli_file_roundtrip(tmp_path, corpus_text):
    src = tmp_path / "in.bin"
    arc = tmp_path / "out.nlzm"
    dst = tmp_path / "out.bin"
    data = corpus_text(400_000)
    src.write_bytes(data)
    from nlzm_tpu.codec import decode_file, encode_bytes, encode_file

    r = encode_file(src, arc, 16, parser="optimal")
    assert r["in"] == len(data)
    # identical to the whole-buffer API
    assert arc.read_bytes() == encode_bytes(data, 16, parser="optimal")
    r2 = decode_file(arc, dst)
    assert dst.read_bytes() == data
    assert r2["crc32"] == r["crc32"]
    # test mode (no output file)
    r3 = decode_file(arc, None)
    assert r3["crc32"] == r["crc32"] and r3["out"] == len(data)


@pytest.mark.slow
def test_cli_flat_rss_on_large_file(tmp_path):
    """Encode a file larger than any sane whole-buffer budget and assert
    the CLI's peak RSS stays O(window + IO chunk), not O(file)."""
    src = tmp_path / "big.bin"
    block = (b"the quick brown fox jumps over the lazy dog 0123456789 " * 1024)[: 48 << 10]
    n_mb = 192
    with open(src, "wb") as f:
        for i in range((n_mb << 20) // len(block)):
            f.write(block[:8] + i.to_bytes(4, "big") + block[12:])
    flen = os.stat(src).st_size
    assert flen >= (n_mb - 1) << 20

    arc = tmp_path / "big.nlzm"
    # the subprocess baseline RSS includes the interpreter and imports
    # before any codec work; assert the DELTA stays far below the 192 MB
    # file size
    prologue = (
        "import resource, sys\n"
        "from nlzm_tpu.cli import main\n"
        "base = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "print('BASE_KB', base)\n"
    )
    epilogue = (
        "peak = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
        "print('PEAK_KB', peak)\n"
        "sys.exit(rc)\n"
    )

    def run_cli(args):
        code = (
            prologue
            + f"sys.argv = ['cli'] + {args!r}\n"
            + "rc = main()\n"
            + epilogue
        )
        r = subprocess.run(
            [sys.executable, "-c", code], cwd=REPO, capture_output=True,
            text=True, timeout=600,
        )
        assert r.returncode == 0, r.stderr[-2000:]
        base = int(r.stdout.split("BASE_KB")[1].split()[0])
        peak = int(r.stdout.split("PEAK_KB")[1].split()[0])
        return base, peak

    base, peak = run_cli(["-window:16", "-parser:greedy", "c", str(src), str(arc)])
    assert peak - base < 60_000, (
        f"encode RSS grew {peak - base} KB on a {n_mb} MB file - not O(window)"
    )

    # and the streamed archive round-trips through the streaming decoder
    dst = tmp_path / "big.out"
    base2, peak2 = run_cli(["d", str(arc), str(dst)])
    assert peak2 - base2 < 60_000, (
        f"decode RSS grew {peak2 - base2} KB - not O(window)"
    )
    import filecmp

    assert filecmp.cmp(src, dst, shallow=False)
