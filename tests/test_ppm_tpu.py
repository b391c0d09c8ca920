"""Batched device PPM-class codec (segment-parallel, v3 container prior) round trips."""

import pytest

from nlzm_tpu.research import ppm_tpu


@pytest.mark.parametrize("name", ["tiny", "repetitive", "zeros", "empty"])
def test_roundtrip_small(corpus_samples, name):
    data = corpus_samples[name]
    blob = ppm_tpu.compress(data, block_size=4096)
    assert ppm_tpu.decompress(blob) == data


def test_roundtrip_noise_regression():
    """Uniform-ish tables make every fence a multiple of 993 - NOT
    bf16-representable. The decode einsums must run at HIGHEST precision
    or the table select silently rounds 993 -> 992 and every symbol
    whose rANS bits land in the gap mis-decodes (this exact input caught
    the missing precision= on the real chip AND on XLA:CPU's fast-dot
    path; text fixtures flaked past it)."""
    import random

    rng = random.Random(1)
    noise = bytes(rng.randrange(256) for _ in range(3000))
    blob = ppm_tpu.compress(noise, block_size=16384)
    assert ppm_tpu.decompress(blob) == noise


def test_roundtrip_text_multiblock(corpus_text):
    data = corpus_text(20000)
    blob = ppm_tpu.compress(data, block_size=8192)
    assert ppm_tpu.decompress(blob) == data
    # context mixing compresses text despite lane parallelism
    assert len(blob) < len(data) * 0.8


def test_roundtrip_random(corpus_samples):
    data = corpus_samples["random"][:3000]
    blob = ppm_tpu.compress(data, block_size=4096)
    assert ppm_tpu.decompress(blob) == data
    assert len(blob) < len(data) * 1.15


def test_mesh_sharded_decode(corpus_text):
    """NLZC v4 (with shipped prior) decodes block-sharded on the virtual device mesh."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    from nlzm_tpu.research import ppm_tpu

    data = corpus_text(130000)  # 4 blocks + a short tail block
    blob = ppm_tpu.compress(data, block_size=32768)
    mesh = Mesh(np.asarray(jax.devices()), ("blocks",))
    assert ppm_tpu.decompress(blob, mesh=mesh) == data
