"""Smoke run of the codec's device engine on one GPU, end to end.

    python chip_smoke.py                 # phases 1-6 on one card
    python chip_smoke.py --four-cards    # sharded decode over four cards only

Drives the codec through the entry points a user calls (encode_container,
decode_container, the CLI's `c`/`d`/`t`) at real file sizes on a seeded
non-periodic corpus, and checks every result byte for byte against the
input, the container CRC and the native host engine. Everything runs in
this one process: a second JAX process could not get the card's memory.

Phases (one line each, with input size, wall time, compressed size, result):

1. device: nvidia-smi name and power limit, JAX platform/kind/count;
2. wide profile, shipping config (32 KiB blocks + 32 KiB shared dictionary,
   native optimal-parse encode), 64 MiB: device decode_container, then the
   CLI's streaming `d` on the device engine; peak device memory;
3. v1 profile (CLI default `-blocks`), 16 MiB: device FSM decode, and the
   CLI's `t`;
4. frontier config (128 KiB blocks + 128 KiB dictionary, depth cap 12),
   16 MiB: the two-operand sort path;
5. device encode, 16 MiB: v1 greedy and optimal, wide without dictionary,
   each decoded by the native engine; device plane encode byte-identical
   to the host plane encoder on the same ops;
6. research codecs (NLZC and huff0), 4 MiB each, device decode.

With --four-cards only the sharded decodes run: the phase-2 container
through decode_wide_sharded and the phase-3 container through
decode_container_sharded, over a 4-device mesh, each compared with the
input and with the one-card decode.

The last stdout line is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}},
printed only when every phase passed. Without a GPU (or with
JAX_PLATFORMS naming another platform) the script exits non-zero first.
"""

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
MIB = 1 << 20
SEED = 0x5EED
SIZES = {"wide": 64 * MIB, "v1": 16 * MIB, "frontier": 16 * MIB,
         "encode": 16 * MIB, "research": 4 * MIB}


class SmokeFailure(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(line: str) -> None:
    print(line, flush=True)


# ------------------------------------------------------------ bookkeeping
class CompileLog:
    """Seconds JAX spent tracing, lowering and compiling, per function."""

    EVENTS = ("/jax/core/compile/jaxpr_trace_duration",
              "/jax/core/compile/jaxpr_to_mlir_module_duration",
              "/jax/core/compile/backend_compile_duration")

    def __init__(self):
        self.secs = {}

    def __call__(self, event, duration, **kw):
        if event in self.EVENTS:
            name = str(kw.get("fun_name", "?"))
            if name.startswith("jit(") and name.endswith(")"):
                name = name[4:-1]
            self.secs[name] = self.secs.get(name, 0.0) + duration

    def snapshot(self) -> dict:
        return dict(self.secs)

    def since(self, snap: dict) -> dict:
        return {k: v - snap.get(k, 0.0) for k, v in self.secs.items()
                if v - snap.get(k, 0.0) > 0}


_COMPILES = None


def compile_log() -> CompileLog:
    global _COMPILES
    if _COMPILES is None:
        import jax

        _COMPILES = CompileLog()
        jax.monitoring.register_event_duration_secs_listener(_COMPILES)
    return _COMPILES


class Phase:
    """Times one phase and prints its line; long-scan compiles get their own."""

    LONG_SCANS = ("plane_scan_fused", "fsm_decode_v2")

    def __init__(self, label: str, n_in: int):
        self.label, self.n_in = label, n_in
        self.fields = {}

    def __enter__(self):
        self.snap = compile_log().snapshot()
        self.t0 = time.perf_counter()
        return self

    def timed(self, key: str, fn, *args, **kw):
        t = time.perf_counter()
        out = fn(*args, **kw)
        self.fields[key] = f"{time.perf_counter() - t:.3f}s"
        return out

    def __exit__(self, exc_type, exc, tb):
        wall = time.perf_counter() - self.t0
        comp = compile_log().since(self.snap)
        for name in self.LONG_SCANS:
            if name in comp:
                say(f"compile {self.label}: {name} first compile {comp[name]:.3f}s")
        top = sorted(comp.items(), key=lambda kv: -kv[1])[:3]
        if top:
            say(f"compile {self.label}: most in " + ", ".join(
                f"{name} {secs:.3f}s" for name, secs in top))
        extra = " ".join(f"{k}={v}" for k, v in self.fields.items())
        result = "byte-exact OK" if exc_type is None else f"FAILED ({exc_type.__name__})"
        say(f"phase {self.label}: in={self.n_in} B wall={wall:.3f}s "
            f"compile={sum(comp.values()):.3f}s {extra} -> {result}")
        return False


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats()
    return None if stats is None else stats.get("peak_bytes_in_use")


def corpus(n: int, seed: int) -> bytes:
    from nlzm_tpu.utils.corpus import build_nonperiodic

    return build_nonperiodic(n, seed)


def _decode_verified(container: bytes, data: bytes, engine: str) -> None:
    from nlzm_tpu.parallel.blocks import decode_container, parse_container
    from nlzm_tpu.utils.crc32 import crc32

    check(parse_container(container).crc32 == crc32(data),
          "container CRC does not match the input")
    # decode_container raises IntegrityError when the stored CRC disagrees
    check(decode_container(container, engine=engine) == data,
          f"{engine} decode differs from the input")


def _cli(args) -> None:
    from nlzm_tpu import cli

    check(cli.main(list(args)) == 0, f"cli {' '.join(args)} failed")


# ------------------------------------------------------------ phases
def phase_device(require_gpu: bool = True) -> dict:
    """Phase 1: the card and JAX's view of it."""
    import jax

    from nlzm_tpu.utils.device import card_lines

    say("card (nvidia-smi name, power.limit):")
    for line in card_lines() or ["nvidia-smi unavailable"]:
        say(line)
    try:
        devs = jax.devices()
    except Exception as e:
        raise SmokeFailure(
            f"no JAX device for platforms {jax.config.jax_platforms!r}: "
            f"{type(e).__name__} {e}") from e
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    say(f"phase 1 device: jax platform={dev['platform']} "
        f"kind={dev['kind']} count={dev['count']}")
    if require_gpu:
        check(dev["platform"] == "gpu",
              f"JAX platform is {dev['platform']!r}, not 'gpu'")
    return dev


def encode_wide(data: bytes, block_size: int = 32768, dict_size: int = 32768,
                depth_cap: int = 8) -> bytes:
    """Shipping-style wide container on the native host encoder."""
    from nlzm_tpu.parallel.blocks import encode_container

    return encode_container(
        data, block_size=block_size, dict_size=dict_size, parser="optimal",
        profile="wide", depth_cap=depth_cap, engine="native")


def phase_wide(data: bytes, workdir: Path, block_size: int = 32768,
               dict_size: int = 32768) -> bytes:
    """Phase 2: shipping wide config, device decode in memory and via CLI."""
    with Phase("2 wide", len(data)) as ph:
        c = ph.timed("encode", encode_wide, data, block_size, dict_size)
        ph.fields["comp"] = f"{len(c)}B"
        ph.timed("decode_cold", _decode_verified, c, data, "device")
        ph.timed("decode_warm", _decode_verified, c, data, "device")
        arc, out = workdir / "wide.nlzp", workdir / "wide.out"
        arc.write_bytes(c)
        ph.timed("cli_d", _cli, ["-engine:device", "d", str(arc), str(out)])
        check(out.read_bytes() == data, "CLI device decode differs from the input")
        ph.fields["peak_bytes_in_use"] = peak_bytes()
    return c


def encode_v1_cli(data: bytes, workdir: Path, block_flag: str = "-blocks") -> bytes:
    """v1 container through the CLI's default block profile (native)."""
    src, arc = workdir / "v1.in", workdir / "v1.nlzp"
    src.write_bytes(data)
    _cli([block_flag, "c", str(src), str(arc)])
    return arc.read_bytes()


def phase_v1(data: bytes, workdir: Path, block_flag: str = "-blocks") -> bytes:
    """Phase 3: CLI-encoded v1 container, device FSM decode + CLI `t`."""
    with Phase("3 v1", len(data)) as ph:
        c = ph.timed("encode", encode_v1_cli, data, workdir, block_flag)
        ph.fields["comp"] = f"{len(c)}B"
        ph.timed("decode", _decode_verified, c, data, "device")
        ph.timed("cli_t", _cli, ["-engine:device", "t", str(workdir / "v1.nlzp")])
        ph.fields["peak_bytes_in_use"] = peak_bytes()
    return c


def phase_frontier(data: bytes, block_size: int = 131072,
                   dict_size: int = 131072) -> None:
    """Phase 4: frontier config, the two-operand sort path."""
    with Phase("4 frontier", len(data)) as ph:
        c = ph.timed("encode", encode_wide, data, block_size, dict_size, 12)
        ph.fields["comp"] = f"{len(c)}B"
        ph.timed("decode", _decode_verified, c, data, "device")
        ph.fields["peak_bytes_in_use"] = peak_bytes()


def _plane_parity(data: bytes, block_size: int) -> None:
    import numpy as np

    from nlzm_tpu import native
    from nlzm_tpu.format.wide import encode_wide_blocks
    from nlzm_tpu.ops.wide_encode_dev import encode_wide_blocks_device
    from nlzm_tpu.parallel.blocks import hist_bits_for_block

    ol, ov = native.parse_blocks(data, block_size, hist_bits_for_block(block_size))
    ol = np.ascontiguousarray(ol, np.int32)
    ov = np.ascontiguousarray(ov, np.int32)
    native.lift_deep(ol, ov, block_size)
    orp = native.classify_reps(ol, ov)
    check(encode_wide_blocks(ol, ov, orp) == encode_wide_blocks_device(ol, ov, orp),
          "device wide plane encode differs from the host encoder")


def phase_device_encode(data: bytes, v1_block: int = 8192,
                        wide_block: int = 32768) -> None:
    """Phase 5: device encode, native decode; plane-encode parity."""
    from nlzm_tpu.parallel.blocks import encode_container

    with Phase("5 device-encode", len(data)) as ph:
        for label, kw in (
            ("v1_greedy", dict(block_size=v1_block, parser="greedy")),
            ("v1_optimal", dict(block_size=v1_block, parser="optimal")),
            ("wide", dict(block_size=wide_block, parser="optimal", profile="wide")),
        ):
            c = ph.timed(f"{label}_encode", encode_container, data,
                         engine="device", **kw)
            ph.fields[f"{label}_comp"] = f"{len(c)}B"
            _decode_verified(c, data, "native")
        ph.timed("plane_parity", _plane_parity, data, wide_block)
        ph.fields["peak_bytes_in_use"] = peak_bytes()


def phase_research(data: bytes, nlzc_block: int = 16384) -> None:
    """Phase 6: NLZC and huff0 device decode."""
    from nlzm_tpu.research import huff0, ppm_tpu

    with Phase("6 research", len(data)) as ph:
        blob = ph.timed("nlzc_encode", ppm_tpu.compress, data, block_size=nlzc_block)
        ph.fields["nlzc_comp"] = f"{len(blob)}B"
        out = ph.timed("nlzc_decode", ppm_tpu.decompress, blob)
        check(out == data, "NLZC device decode differs from the input")
        h = ph.timed("huff0_encode", huff0.encode, data)
        ph.fields["huff0_comp"] = f"{len(h)}B"
        out = ph.timed("huff0_decode", huff0.decode, h, engine="device")
        check(out == data, "huff0 device decode differs from the input")


def _shards(rows) -> str:
    return ", ".join(f"{s.device}:{tuple(s.data.shape)}" for s in rows.addressable_shards)


def phase_four_cards(wide_data: bytes, v1_data: bytes, workdir: Path,
                     n_cards: int = 4) -> None:
    """Sharded decodes over n_cards devices vs the input and one card."""
    import jax

    from nlzm_tpu.parallel.blocks import decode_container
    from nlzm_tpu.parallel.mesh import (
        decode_container_sharded, decode_container_sharded_rows,
        decode_wide_sharded, decode_wide_sharded_rows, make_mesh,
        sharded_rows_to_bytes)

    devs = jax.devices()
    check(len(devs) >= n_cards, f"need {n_cards} devices, JAX sees {len(devs)}")
    mesh = make_mesh(devs[:n_cards])
    for label, data, encode, rows_fn, full_fn in (
        ("wide", wide_data, encode_wide, decode_wide_sharded_rows, decode_wide_sharded),
        ("v1", v1_data, lambda d: encode_v1_cli(d, workdir), decode_container_sharded_rows,
         decode_container_sharded),
    ):
        with Phase(f"{n_cards}-card {label}", len(data)) as ph:
            c = ph.timed("encode", encode, data)
            ph.fields["comp"] = f"{len(c)}B"
            one = ph.timed("decode_1card", decode_container, c, engine="device")
            check(one == data, f"one-card {label} decode differs from the input")
            rows, info, n_blocks = ph.timed("decode_sharded_cold", rows_fn, c, mesh)
            shards = rows.addressable_shards
            check(len({s.device for s in shards}) == n_cards
                  and all(s.data.shape[0] * n_cards == rows.shape[0] for s in shards),
                  f"{label} output is not split evenly over {n_cards} devices")
            say(f"shards {label}: blocks={n_blocks} rows={tuple(rows.shape)} "
                f"-> {_shards(rows)}")
            check(sharded_rows_to_bytes(rows, info, n_blocks) == data,
                  f"sharded {label} decode differs from the input")
            got = ph.timed("decode_sharded_warm", full_fn, c, mesh)
            check(got == one, f"sharded {label} decode differs from the one-card decode")


# ------------------------------------------------------------ driver
def _require_checkout() -> None:
    check((REPO / "nlzm_tpu" / "__init__.py").is_file(),
          f"{REPO} is not a checkout of the codec (nlzm_tpu/ missing)")


def _setup_jax() -> None:
    """CUDA unless JAX_PLATFORMS says otherwise (then the platform check
    in phase 1 decides), the compile cache, and the compile log."""
    from nlzm_tpu.utils.compile_cache import enable_compile_cache
    from nlzm_tpu.utils.device import insist_on_cuda

    insist_on_cuda()
    say(f"compile cache: {enable_compile_cache()}")
    compile_log()


def run(args) -> dict:
    _require_checkout()
    _setup_jax()
    dev = phase_device()
    t = time.perf_counter()
    data = corpus(SIZES["wide"], SEED)
    say(f"corpus: {len(data)} B seeded non-periodic text (seed {SEED:#x}) "
        f"in {time.perf_counter() - t:.3f}s")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        workdir = Path(tmp)
        if args.four_cards:
            phase_four_cards(data, data[: SIZES["v1"]], workdir)
            return dev
        phase_wide(data, workdir)
        phase_v1(data[: SIZES["v1"]], workdir)
        phase_frontier(data[: SIZES["frontier"]])
        phase_device_encode(data[: SIZES["encode"]])
        phase_research(data[: SIZES["research"]])
    return dev


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded decodes, over four cards")
    args = ap.parse_args(argv)
    try:
        dev = run(args)
    except Exception as e:  # every failure ends the run without a result
        print(f"chip_smoke: FAILED: {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        return 1
    say(json.dumps({"ok": True, "device": dev}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
