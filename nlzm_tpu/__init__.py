"""nlzm_tpu: an NLZM-class lossless compression framework in JAX.

Implements the NLZM bitstream (sliding-window LZ + forward-graph optimal
parsing + chunked 4-lane rANS over adaptive nibble CDFs) with three engines:

- serial host reference model (pure Python; nlzm_tpu.codec)
- native C++ host runtime (nlzm_tpu.native)
- batched device engine: blocks decoded/encoded SIMD-across-streams as
  jit-compiled JAX programs (plain jax.numpy/lax, no hand-written
  kernels), data-parallel over a device mesh (nlzm_tpu.ops,
  nlzm_tpu.parallel)
"""

__version__ = "0.1.0"

from .codec import decode_bytes, encode_bytes

__all__ = ["decode_bytes", "encode_bytes", "__version__"]
