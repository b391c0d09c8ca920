"""Device-mesh sharding for block-parallel codec work.

The codec's scaling axis is the block (SURVEY.md §2.5/§5.8): blocks are
independent streams, so the mesh is 1-D ("blocks") and every state tensor
shards on its leading block dimension. Decode needs no collectives until the
ordered gather at the end; sizes are all-gathered and offsets computed by
exclusive scan, which is the variable-length analog the encoder uses too.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

BLOCK_AXIS = "blocks"


def make_mesh(devices=None) -> Mesh:
    devices = devices if devices is not None else jax.devices()
    return Mesh(np.asarray(devices), (BLOCK_AXIS,))


def _pad_blocks(arr: np.ndarray, multiple: int):
    b = arr.shape[0]
    pad = (-b) % multiple
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)], axis=0)
    return arr, b


def sharded_rows_to_bytes(rows, info, n_blocks: int) -> bytes:
    """Block rows [B_pad, N] -> the container's plain bytes, CRC-verified."""
    from .blocks import _verified

    if not n_blocks:
        return _verified(b"", info)
    out_np = np.asarray(rows)[:n_blocks].reshape(-1)
    return _verified(out_np.tobytes()[: info.total_len], info)


def decode_container_sharded_rows(data: bytes, mesh: Mesh):
    """v1 block decode under a device mesh -> (rows, info, n_blocks).

    Streams shard over the block axis; the FSM decode and LZ expansion run
    SPMD with zero cross-device traffic; per-block byte counts are
    all-gathered (the ordered-gather collective). rows is the [B_pad, N]
    u8 output, still sharded over the mesh; rows past n_blocks are padding
    (rows is None for a container with no blocks).
    """
    from .blocks import pack_streams, parse_container
    from ..ops.decode_v2 import fsm_decode_v2
    from ..ops.expand_ops import lz_expand_parallel

    info = parse_container(data)
    if not info.comp_sizes:
        return None, info, 0
    n_dev = mesh.devices.size
    streams, n_blocks = _pad_blocks(pack_streams(data, info), n_dev)

    num_steps = ((max(info.num_cmds) + 1 + 255) // 256) * 256
    block_size = info.block_size

    sharding = NamedSharding(mesh, P(BLOCK_AXIS))

    @partial(jax.jit, out_shardings=(sharding, NamedSharding(mesh, P())))
    def pipeline(streams_dev):
        op_len, op_val = fsm_decode_v2(streams_dev, num_steps)
        out, produced = lz_expand_parallel(op_len, op_val, block_size)
        # ordered gather: every device learns every block's byte count
        sizes = jax.lax.with_sharding_constraint(produced, NamedSharding(mesh, P()))
        return out, sizes

    streams_dev = jax.device_put(jnp.asarray(streams), sharding)
    out, _sizes = pipeline(streams_dev)
    return out, info, n_blocks


def decode_container_sharded(data: bytes, mesh: Mesh) -> bytes:
    """Full block-parallel v1 decode under a device mesh, in stream order
    (CRC-verified when the container carries one)."""
    return sharded_rows_to_bytes(*decode_container_sharded_rows(data, mesh))


def decode_wide_sharded_rows(data: bytes, mesh: Mesh):
    """Wide-profile block decode sharded over the mesh's block axis ->
    (rows, info, n_blocks), rows as in decode_container_sharded_rows.

    Plane scans, assembly sorts, and expansion are all batched over the
    leading block dimension, so sharding the staged arrays makes the whole
    pipeline SPMD with no cross-device traffic on the hot path. The shared
    dictionary, when the container has one, is replicated on every device.
    """
    from .blocks import block_payloads, parse_container
    from ..format.wide import empty_payload
    from ..ops.wide_decode import decode_wide_staged, prepare_wide, rounds_hint_of

    info = parse_container(data)
    assert info.wide
    if not info.comp_sizes:
        return None, info, 0

    payloads = block_payloads(data, info)
    n_dev = mesh.devices.size
    # pad with zero-command blocks so B divides the mesh
    n_blocks = len(payloads)
    payloads += [empty_payload()] * ((-n_blocks) % n_dev)

    staged = prepare_wide(payloads, info.wide_priors)
    staged["rounds_hint"] = rounds_hint_of(max(info.total_reads, default=0))
    sharding = NamedSharding(mesh, P(BLOCK_AXIS))
    staged["n_sym"] = [jax.device_put(a, sharding) for a in staged["n_sym"]]
    for key in ("seeds_cat", "hw_cat", "offs", "ends", "bit_half"):
        staged[key] = jax.device_put(staged[key], sharding)
    if info.dictionary:
        staged["dict_arr"] = jax.device_put(
            np.frombuffer(info.dictionary, np.uint8), NamedSharding(mesh, P()))

    out, _produced = decode_wide_staged(staged, info.block_size)
    return out, info, n_blocks


def decode_wide_sharded(data: bytes, mesh: Mesh) -> bytes:
    """Wide-profile decode sharded over the mesh, in stream order
    (CRC-verified when the container carries one)."""
    return sharded_rows_to_bytes(*decode_wide_sharded_rows(data, mesh))
