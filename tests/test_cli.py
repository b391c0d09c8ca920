"""CLI surface tests (mirrors the reference CLI, NLZM.cpp:2165-2171).

Covers the flag grammar (flags accepted before OR after the command),
the c/d/t/h commands, refuse-overwrite, and the block-container profiles
through the serial engine (the device path is covered by test_tpu_decode).
"""

from pathlib import Path

import numpy as np
import pytest

from nlzm_tpu.cli import main
from nlzm_tpu.utils.crc32 import crc32


@pytest.fixture
def sample(tmp_path, corpus_text):
    data = corpus_text(50000)
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    return data, src, tmp_path


def _roundtrip(src, dst, out, flags):
    assert main(flags + ["c", str(src), str(dst)]) == 0
    assert main(["-engine:serial", "d", str(dst), str(out)]) == 0
    return out.read_bytes()


def test_cli_single_stream(sample):
    data, src, d = sample
    assert _roundtrip(src, d / "a.nlzm", d / "a.out", ["-window:18"]) == data


def test_cli_flags_after_command(sample):
    """Flags are position-independent (the reference puts them first;
    users put them anywhere)."""
    data, src, d = sample
    dst, out = d / "b.nlzp", d / "b.out"
    assert main(["c", str(src), str(dst), "-profile:wide", "-blocks"]) == 0
    assert dst.read_bytes()[:4] == b"NLZP"
    assert main(["d", str(dst), str(out), "-engine:serial"]) == 0
    assert out.read_bytes() == data


def test_cli_blocks_v1_profile(sample):
    data, src, d = sample
    got = _roundtrip(src, d / "c.nlzp", d / "c.out", ["-blocks:32768"])
    assert got == data


def test_cli_refuse_overwrite(sample):
    _, src, d = sample
    dst = d / "d.nlzm"
    dst.write_bytes(b"existing")
    assert main(["c", str(src), str(dst)]) == 1
    assert dst.read_bytes() == b"existing"


def test_cli_crc_and_test_mode(sample, capsys):
    data, src, d = sample
    assert main(["h", str(src)]) == 0
    assert f"{crc32(data):X}" in capsys.readouterr().out
    dst = d / "e.nlzm"
    assert main(["c", str(src), str(dst)]) == 0
    capsys.readouterr()
    assert main(["-engine:serial", "t", str(dst)]) == 0
    assert f"{crc32(data):X}" in capsys.readouterr().out


def test_cli_bad_flag_and_usage(sample):
    _, src, _ = sample
    assert main(["-bogus:1", "c", str(src), "x"]) == 1
    assert main([]) == 1
    assert main(["c", str(src)]) == 1  # missing output operand


def test_cli_auto_decodes_container_on_native_without_gpu(sample, capsys):
    """`auto` picks the device engine on a GPU backend; on the CPU a v1
    container decodes on the native engine (device without the library,
    which then says so)."""
    from nlzm_tpu import cli, native

    data, src, d = sample
    dst, out = d / "f.nlzp", d / "f.out"
    assert main(["-blocks:16384", "c", str(src), str(dst)]) == 0
    capsys.readouterr()
    expect = "native" if native.available() else "device"
    assert cli._container_engine("auto", wide=False) == expect
    assert cli._container_engine("device", wide=False) == "device"
    assert cli._container_engine("serial", wide=True) == "serial"
    assert main(["d", str(dst), str(out)]) == 0
    said = "Engine: device (jax backend cpu)" in capsys.readouterr().out
    assert said == (expect == "device")
    assert out.read_bytes() == data


def test_cli_auto_keeps_wide_container_on_device_engine(sample, capsys):
    """Wide containers have no native plane decoder: on the CPU `auto`
    keeps them on the device engine's streaming path and says so."""
    from nlzm_tpu import cli

    data, src, d = sample
    dst, out = d / "w.nlzp", d / "w.out"
    assert main(["-profile:wide", "-blocks:16384", "c", str(src), str(dst)]) == 0
    capsys.readouterr()
    assert cli._container_engine("auto", wide=True) == "device"
    assert main(["d", str(dst), str(out)]) == 0
    assert "Engine: device (jax backend cpu)" in capsys.readouterr().out
    assert out.read_bytes() == data


def test_cli_device_engine_says_where_it_runs(sample, capsys):
    data, src, d = sample
    dst, out = d / "g.nlzp", d / "g.out"
    assert main(["-blocks:16384", "c", str(src), str(dst)]) == 0
    assert main(["-engine:device", "d", str(dst), str(out)]) == 0
    assert "Engine: device (jax backend cpu)" in capsys.readouterr().out
    assert out.read_bytes() == data


def test_cli_rejects_unknown_engine(sample, capsys):
    """The old engine name and typos fail instead of picking an engine."""
    _, src, d = sample
    dst, out = d / "h.nlzp", d / "h.out"
    assert main(["-blocks:16384", "c", str(src), str(dst)]) == 0
    capsys.readouterr()
    assert main(["-engine:tpu", "d", str(dst), str(out)]) == 1
    assert "unknown engine tpu" in capsys.readouterr().out
    assert not out.exists()
    assert main(["-engine:devise", "c", str(src), str(d / "i.nlzp")]) == 1
    assert not (d / "i.nlzp").exists()


@pytest.mark.parametrize("call", ["decode_container", "decode_container_stream",
                                  "encode_container", "huff0_decode"])
def test_api_rejects_unknown_engine(sample, call):
    from nlzm_tpu.parallel.blocks import decode_container, encode_container
    from nlzm_tpu.parallel.stream import decode_container_stream
    from nlzm_tpu.research import huff0

    data, src, d = sample
    c = encode_container(data, block_size=16384)
    arc = d / "j.nlzp"
    arc.write_bytes(c)
    run = {
        "decode_container": lambda: decode_container(c, engine="tpu"),
        "decode_container_stream": lambda: decode_container_stream(
            str(arc), str(d / "j.out"), engine="tpu"),
        "encode_container": lambda: encode_container(data, engine="tpu"),
        "huff0_decode": lambda: huff0.decode(huff0.encode(data), engine="tpu"),
    }[call]
    with pytest.raises(ValueError, match="unknown engine 'tpu'"):
        run()
    assert not (d / "j.out").exists()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from nlzm_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.compile_cache_dir() == str(tmp_path)
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: the helper sets no directory of its own
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_default_is_in_checkout(monkeypatch):
    import jax

    from nlzm_tpu.utils import compile_cache

    repo = Path(compile_cache.__file__).resolve().parents[2]
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    fixed = str(repo / ".build" / "jaxcache")
    assert compile_cache.compile_cache_dir() == fixed
    before = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == fixed
        assert jax.config.jax_compilation_cache_dir == fixed
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
