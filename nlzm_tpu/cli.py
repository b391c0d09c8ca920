"""Command-line interface.

Mirrors the reference CLI (NLZM.cpp:2165-2171) and extends it with the
block-parallel profile:

    python -m nlzm_tpu.cli [flags] c <input> <output>   compress
    python -m nlzm_tpu.cli d <input> <output>           decompress
    python -m nlzm_tpu.cli t <input>                    decompress in memory
    python -m nlzm_tpu.cli h <input>                    CRC32

Flags:
    -window:bits    window size in bits (15..28, default 22)
    -parser:name    greedy | optimal (default optimal)
    -blocks[:size]  use the NLZP block-parallel container (device engine path);
                    optional uncompressed block size in bytes
    -profile:name   block profile: v1 (NLZM-compatible frames, default)
                    | wide (lane-parallel device-first planes)
    -engine:name    engine: auto | serial | native | device
                    (auto decodes containers on the device engine when
                    JAX's backend is a GPU; elsewhere v1 containers on
                    native, wide ones on the device engine, which
                    prints its backend)
    -dict:size      wide profile: shared-dictionary bytes sampled from the
                    input (0 = off)
    -v              verbose: memory budget + per-stage timing report

Both the single-stream format and the NLZP container stream through
bounded buffers: container files encode/decode bucket-at-a-time
(parallel/stream.py), so RSS stays O(window + bucket) at any file size.
"""

import sys
import time

from .constants import DEFAULT_HIST_BITS
from .utils.crc32 import crc32


def _fail(msg: str) -> int:
    print(f"Error: {msg}")
    return 1

def _usage() -> int:
    print(__doc__)
    return 1


def _use_device() -> None:
    """Set up the device engine: compile cache, and say where it runs."""
    import jax

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    print(f"Engine: device (jax backend {jax.default_backend()})")


def _container_engine(engine: str, wide: bool) -> str:
    """Resolve `auto` for NLZP containers. Off a GPU backend, v1
    containers go to the threaded native decoder. Wide containers have no
    native plane decoder (the host one is the Python reference), so they,
    and every container when the library is absent, stay on the device
    engine, which says which backend it runs on."""
    if engine != "auto":
        return engine
    import jax

    from . import native

    if jax.default_backend() != "gpu" and not wide and native.available():
        return "native"
    return "device"


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    print("nlzm-tpu 0.1 - NLZM-class codec with a JAX device engine")

    window_bits = DEFAULT_HIST_BITS
    parser = "optimal"
    block_size = 0  # 0 => single-stream NLZM format
    profile = "v1"
    engine = "auto"
    dict_size = 0
    verbose = False

    # flags are accepted anywhere in argv (before or after the command)
    flags = [a for a in argv if a.startswith("-")]
    argv = [a for a in argv if not a.startswith("-")]
    for raw in flags:
        arg = raw.lstrip("-").lower()
        if arg == "v":
            verbose = True
        elif arg.startswith("window:"):
            window_bits = max(15, min(28, int(arg[7:])))
            print(f"Window bits: {window_bits}")
        elif arg.startswith("parser:"):
            parser = arg[7:]
        elif arg == "blocks":
            from .parallel.blocks import DEFAULT_BLOCK_SIZE

            block_size = DEFAULT_BLOCK_SIZE
        elif arg.startswith("blocks:"):
            block_size = int(arg[7:])
        elif arg.startswith("profile:"):
            profile = arg[8:]
        elif arg.startswith("engine:"):
            engine = arg[7:]
        elif arg.startswith("dict:"):
            dict_size = int(arg[5:])
        else:
            return _fail(f"unrecognized flag {arg}")
    from .parallel.blocks import ENGINES

    if engine not in ENGINES:
        return _fail(f"unknown engine {engine} (expected {' | '.join(ENGINES)})")

    # flag-order-independent profile/block validation
    if profile == "wide":
        from .parallel.blocks import DEFAULT_BLOCK_SIZE, WIDE_MAX_BLOCK

        if not block_size:
            # default to the fast 32 KiB profile (packed sorts); bigger
            # blocks (to WIDE_MAX_BLOCK) trade ~20% decode for ~4-6% ratio
            block_size = min(DEFAULT_BLOCK_SIZE, 32768)
        elif block_size > WIDE_MAX_BLOCK:
            return _fail(
                f"-profile:wide caps blocks at {WIDE_MAX_BLOCK} (got {block_size})"
            )

    if not argv:
        return _usage()
    cmd = argv.pop(0).lower()

    if cmd == "h" and len(argv) == 1:
        with open(argv[0], "rb") as f:
            print(f"{crc32(f.read()):X}")
        return 0

    if cmd == "c" and len(argv) == 2:
        src, dst = argv
        import os

        if os.path.exists(dst):
            return _fail(f"{dst} already exists")
        flen = os.stat(src).st_size
        if verbose:
            from .utils.metrics import memory_report

            if block_size:
                from .parallel.blocks import hist_bits_for_block

                nb = (flen + block_size - 1) // block_size
                print(memory_report(hist_bits_for_block(block_size), block_size, nb))
            else:
                print(memory_report(window_bits))
        from .utils.metrics import Metrics, ProgressLine

        m = Metrics()
        prog = ProgressLine(flen)
        from . import native

        stream_ok = (
            not block_size
            and engine in ("auto", "native")
            and native.available()
        )
        if engine == "device":
            _use_device()
        with m.stage("encode", flen):
            if stream_ok:
                # bounded-memory streaming driver: RSS stays O(window)
                # however large the file (reference NLZM.cpp:1870-1885)
                from .codec import encode_file

                r = encode_file(src, dst, window_bits, parser=parser, progress=prog)
            elif block_size and (
                profile != "wide"
                or (native.available() and parser == "optimal" and engine != "device")
            ):
                # bucket-at-a-time container streaming: O(window + bucket)
                # RSS at any file size (parallel/stream.py)
                from .parallel.stream import encode_container_stream

                r = encode_container_stream(
                    src, dst, block_size, parser=parser, engine=engine,
                    profile=profile, dict_size=dict_size, progress=prog,
                )
            elif block_size:
                data = open(src, "rb").read()
                from .parallel.blocks import encode_container

                out = encode_container(
                    data, block_size=block_size, parser=parser, engine=engine,
                    profile=profile, dict_size=dict_size, progress=prog,
                )
                open(dst, "wb").write(out)
                r = {"in": len(data), "out": len(out), "crc32": crc32(data)}
            else:
                data = open(src, "rb").read()
                from .codec import encode_bytes

                out = encode_bytes(data, window_bits, parser=parser, engine=engine, progress=prog)
                open(dst, "wb").write(out)
                r = {"in": len(data), "out": len(out), "crc32": crc32(data)}
        prog.finish()
        print(
            f"{r['in']} -> {r['out']} bytes "
            f"(input CRC32 {r['crc32']:X}, {m.stages['encode'].seconds:.2f} sec)"
        )
        if verbose:
            print(m.report())
        return 0

    if cmd in ("d", "t") and len(argv) in (1, 2):
        src = argv[0]
        dst = argv[1] if len(argv) == 2 else None
        if cmd == "d" and dst is None:
            return _usage()
        import os

        if dst and os.path.exists(dst):
            return _fail(f"{dst} already exists")
        from . import native
        from .parallel.blocks import _HDR, FLAG_WIDE, MAGIC
        from .utils.metrics import ProgressLine

        with open(src, "rb") as f:
            head = f.read(_HDR.size)
        magic = head[:4]
        flen = os.stat(src).st_size
        t0 = time.time()
        if magic == MAGIC:
            # header byte 7 holds the container flags (blocks._HDR)
            wide = len(head) > 7 and bool(head[7] & FLAG_WIDE)
            engine = _container_engine(engine, wide)
        if engine == "device":
            _use_device()
        if (
            magic[:4] != MAGIC
            and engine in ("auto", "native")
            and native.available()
        ):
            # single-stream format: bounded-memory streaming decode
            from .codec import decode_file

            prog = ProgressLine(flen)
            r = decode_file(src, dst, progress=prog)
            prog.finish()
            n_in, n_out, crc = r["in"], r["out"], r["crc32"]
        elif magic[:4] == MAGIC and engine in ("device", "native"):
            # NLZP container: bucket-at-a-time streaming decode
            from .parallel.stream import decode_container_stream

            prog = ProgressLine(flen)
            r = decode_container_stream(src, dst, engine=engine, progress=prog)
            prog.finish()
            n_in, n_out, crc = r["in"], r["out"], r["crc32"]
        else:
            data = open(src, "rb").read()
            out = _decode_any(data, engine)
            if dst:
                open(dst, "wb").write(out)
            n_in, n_out, crc = len(data), len(out), crc32(out)
        print(f"{n_in} -> {n_out} bytes (output CRC32 {crc:X}, {time.time() - t0:.2f} sec)")
        return 0

    return _usage()


def _decode_any(data: bytes, engine: str) -> bytes:
    from .parallel.blocks import MAGIC, decode_container

    if data[:4] == MAGIC:
        # main() has resolved `auto` for containers already
        return decode_container(data, engine=engine)
    from . import native
    from .codec import decode_bytes

    if engine == "native" or (engine == "auto" and native.available()):
        return decode_bytes(data, engine="native")
    return decode_bytes(data)


if __name__ == "__main__":
    sys.exit(main())
