"""Test configuration.

Tests run on a virtual 8-device CPU mesh so multi-device sharding logic is
exercised without a GPU. Tests marked `gpu` need a real card and skip here;
`python chip_smoke.py` covers that path on the card.
"""

import os
import subprocess
from pathlib import Path

# Tests run on a virtual 8-device CPU mesh, never a GPU. jax may already
# have been imported (and JAX_PLATFORMS read) before this file runs, so
# jax.config.update after import is the reliable override.
os.environ["JAX_PLATFORMS"] = "cpu"  # for any subprocesses we spawn
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_platforms", "cpu")

import pytest

REPO = Path(__file__).resolve().parent.parent
ORACLE_SRC = Path("/root/reference/NLZM.cpp")
ORACLE_BIN = REPO / ".build" / "nlzm_oracle"


@pytest.fixture(autouse=True)
def _compile_cache_off_checkout(monkeypatch, tmp_path_factory):
    """Set after jax's import, the variable makes the compile-cache helper
    leave JAX's configuration alone, so the entry points under test (CLI
    device engine, chip_smoke) write no CPU cache entries into the
    checkout's .build/jaxcache."""
    monkeypatch.setenv(
        "JAX_COMPILATION_CACHE_DIR", str(tmp_path_factory.getbasetemp() / "jaxcache")
    )


def _ensure_oracle() -> Path:
    if ORACLE_BIN.exists():
        return ORACLE_BIN
    ORACLE_BIN.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        ["g++", "-O2", "-o", str(ORACLE_BIN), str(ORACLE_SRC)],
        check=True,
        capture_output=True,
    )
    return ORACLE_BIN


@pytest.fixture(scope="session")
def oracle():
    """Path to the compiled reference binary (CPU oracle)."""
    if not ORACLE_SRC.exists():
        pytest.skip("reference source not available")
    return _ensure_oracle()


class OracleRunner:
    def __init__(self, binary: Path, workdir: Path):
        self.binary = binary
        self.workdir = workdir

    def _run(self, *args: str) -> str:
        r = subprocess.run(
            [str(self.binary), *args],
            cwd=self.workdir,
            check=True,
            capture_output=True,
            text=True,
        )
        return r.stdout

    def compress(self, data: bytes, window_bits: int | None = None) -> bytes:
        src = self.workdir / "o_in.bin"
        dst = self.workdir / "o_out.nlzm"
        if dst.exists():
            dst.unlink()
        src.write_bytes(data)
        args = ["c", str(src), str(dst)]
        if window_bits is not None:
            args = [f"-window:{window_bits}"] + args
        self._run(*args)
        return dst.read_bytes()

    def decompress(self, data: bytes) -> bytes:
        src = self.workdir / "o_in.nlzm"
        dst = self.workdir / "o_out.bin"
        if dst.exists():
            dst.unlink()
        src.write_bytes(data)
        self._run("d", str(src), str(dst))
        return dst.read_bytes()


@pytest.fixture
def oracle_runner(oracle, tmp_path):
    return OracleRunner(oracle, tmp_path)


def _corpus_text(n: int) -> bytes:
    parts = []
    for p in sorted(REPO.glob("*.md")) + sorted((REPO / "nlzm_tpu").rglob("*.py")):
        parts.append(p.read_bytes())
    blob = b"\n".join(parts)
    while len(blob) < n:
        blob += blob
    return blob[:n]


@pytest.fixture(scope="session")
def corpus_text():
    """Realistic compressible text (repo sources)."""
    return _corpus_text


@pytest.fixture(scope="session")
def corpus_samples(corpus_text):
    """A spread of small inputs covering edge cases."""
    import random

    rng = random.Random(0xC0DEC)
    rand = bytes(rng.randrange(256) for _ in range(4096))
    rep = (b"abcabcabd" * 600)[:4000]
    longrep = (corpus_text(2048) * 6)[:10000]
    return {
        "empty": b"",
        "one": b"x",
        "tiny": b"hello hello hello world",
        "text": corpus_text(20000),
        "random": rand,
        "repetitive": rep,
        "long_range": longrep,
        "zeros": bytes(5000),
    }
