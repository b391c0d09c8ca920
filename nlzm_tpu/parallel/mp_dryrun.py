"""Multi-PROCESS dry run: process-boundary semantics of the sharded decode.

The virtual 8-device mesh in `__graft_entry__.dryrun_multichip` validates
SPMD compilation, but a real pod also needs process boundaries:
`jax.distributed` initialization, per-process data feeding
(`jax.make_array_from_process_local_data` — each process uploads only the
rows its local devices own), cross-process collectives (gloo on CPU), and
a host-side ordered write where every process persists only its
addressable output shards. This module is one such process; the spawner
(dryrun_multichip, or a manual pair of shells) runs N of them against one
coordinator.

Manual 2-process run:
    python -m nlzm_tpu.parallel.mp_dryrun --procs 2 --pid 0 \
        --coord localhost:9911 --local-devices 4 --outdir /tmp/mp &
    python -m nlzm_tpu.parallel.mp_dryrun --procs 2 --pid 1 \
        --coord localhost:9911 --local-devices 4 --outdir /tmp/mp

Reference parity note: the reference is a single-process CPU program; this
is the distribution layer the blocks container exists for (SURVEY.md §5.8).
"""

import argparse
import os
import sys


def _setup_env(local_devices: int) -> None:
    # XLA_FLAGS is read lazily at backend creation, so setting it here
    # works; JAX_PLATFORMS is read when jax is imported, so the platform
    # override goes through jax.config.update in run() instead.
    flags = [
        f for f in os.environ.get("XLA_FLAGS", "").split()
        if not f.startswith("--xla_force_host_platform_device_count")
    ]
    flags.append(f"--xla_force_host_platform_device_count={local_devices}")
    os.environ["XLA_FLAGS"] = " ".join(flags)


def run(pid: int, procs: int, coord: str, outdir: str, block_size: int = 2048) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=coord, num_processes=procs, process_id=pid
    )
    assert jax.process_count() == procs, (jax.process_count(), procs)

    import numpy as np
    from jax.experimental import multihost_utils
    from jax.sharding import NamedSharding, PartitionSpec as P

    from .blocks import block_payloads, encode_container, parse_container
    from .mesh import BLOCK_AXIS, make_mesh
    from ..format.wide import empty_payload
    from ..ops.wide_decode import (
        decode_wide_staged, prepare_wide, rounds_hint_of)

    n_dev = len(jax.devices())
    mesh = make_mesh(jax.devices())
    sharding = NamedSharding(mesh, P(BLOCK_AXIS))

    # deterministic corpus -> every process computes an identical container
    # (a real pod would broadcast archive bytes or read shared storage)
    import random

    rng = random.Random(4321)
    words = [
        bytes(rng.randrange(97, 123) for _ in range(rng.randrange(3, 9)))
        for _ in range(50)
    ]
    data = b" ".join(words[rng.randrange(50)] for _ in range(3 * n_dev * block_size // 5))
    data = data[: (2 * n_dev + 1) * block_size + 17]  # ragged on purpose

    container = encode_container(
        data, block_size=block_size, parser="optimal", profile="wide")
    # cross-process agreement check on the encoded bytes
    import zlib

    crcs = multihost_utils.process_allgather(
        np.asarray([zlib.crc32(container)], np.uint32))
    assert int(crcs.min()) == int(crcs.max()), "container bytes diverged across processes"

    info = parse_container(container)
    payloads = block_payloads(container, info)
    n_blocks = len(payloads)
    while len(payloads) % n_dev:
        payloads.append(empty_payload())

    staged = prepare_wide(payloads, info.wide_priors)
    staged["rounds_hint"] = rounds_hint_of(max(info.total_reads, default=0))

    # per-process feeding: slice THIS process's rows out of the host-staged
    # arrays and build each global array from process-local data only
    def feed(arr):
        arr = np.asarray(arr)
        b = arr.shape[0]
        lo = pid * b // procs
        hi = (pid + 1) * b // procs
        return jax.make_array_from_process_local_data(
            sharding, arr[lo:hi], arr.shape)

    staged["n_sym"] = [feed(a) for a in staged["n_sym"]]
    for key in ("seeds_cat", "hw_cat", "offs", "ends", "bit_half"):
        staged[key] = feed(staged[key])

    out, produced = decode_wide_staged(staged, info.block_size)

    # host-side ordered write: each process writes ONLY its addressable
    # shards, tagged with their global row ranges; process 0 assembles
    # after the barrier
    os.makedirs(outdir, exist_ok=True)
    rows, datas = [], []
    for shard in out.addressable_shards:
        sl = shard.index[0]
        rows.append((sl.start or 0, sl.stop))
        datas.append(np.asarray(shard.data))
    np.savez(
        os.path.join(outdir, f"part{pid}.npz"),
        rows=np.asarray(rows, np.int64),
        **{f"d{i}": d for i, d in enumerate(datas)},
    )
    multihost_utils.sync_global_devices("nlzm_mp_write_done")

    if pid == 0:
        full = np.zeros((len(payloads), info.block_size), np.uint8)
        for p in range(procs):
            z = np.load(os.path.join(outdir, f"part{p}.npz"))
            for i, (lo, hi) in enumerate(z["rows"]):
                full[lo:hi] = z[f"d{i}"]
        got = full[:n_blocks].reshape(-1).tobytes()[: info.total_len]
        assert got == data, "multi-process sharded decode mismatch"
        print(
            f"mp_dryrun ok: {procs} processes x {n_dev // procs} devices, "
            f"{len(data)} bytes wide-decoded with per-process feeding + "
            f"ordered write", flush=True,
        )
    multihost_utils.sync_global_devices("nlzm_mp_exit")
    jax.distributed.shutdown()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--procs", type=int, required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--coord", required=True)
    ap.add_argument("--local-devices", type=int, default=4)
    ap.add_argument("--outdir", required=True)
    args = ap.parse_args(argv)
    _setup_env(args.local_devices)
    run(args.pid, args.procs, args.coord, args.outdir)


if __name__ == "__main__":
    main()
