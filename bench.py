"""Benchmark: block-parallel device decode and encode throughput on one GPU.

Prints one JSON line per metric; the primary metric (wide-profile device
decode, with per-stage breakdown + e2e keys) is emitted FIRST and then
RE-EMITTED after every optional section, so the last line always carries
it even if a later section is cut short. Optional sections (device
encode, v1 profile, frontier config) each have a wall-clock budget and
are skipped with a stderr note when the run is over budget.

Every line is stamped with the device as JAX reports it (platform,
device_kind, device_count) and with the card's name and power limit from
nvidia-smi. The bench runs only on a GPU: without one it exits non-zero
before measuring anything.

Measures the wide-profile device decode pipeline (lane-parallel plane
scans + scan-free assembly + sort-based LZ expansion) with streams
pre-staged in device memory; every timed call ends in block_until_ready,
and correctness is verified separately with a full output comparison.
Baseline: the reference NLZM decodes enwik8 at ~123 MB/s on its benchmark
machine (README.md:4) - vs_baseline = our MB/s / 123. Every metric is
best-of-N within ONE process.
"""

import json
import os
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

BLOCK_SIZE = int(os.environ.get("NLZM_BENCH_BLOCK", str(32768)))
CORPUS_MB = int(os.environ.get("NLZM_BENCH_MB", "8"))
DICT_SIZE = int(os.environ.get("NLZM_BENCH_DICT", str(32768)))
REPS = int(os.environ.get("NLZM_BENCH_REPS", "5"))
# Whole-run wall budget; optional sections are skipped once exceeded.
BUDGET_S = float(os.environ.get("NLZM_BENCH_BUDGET", "1500"))

_T0 = time.time()


def build_corpus(n: int) -> bytes:
    """Deterministic enwik-like mix, independent of repo file contents
    (stable cache keys): Zipf-ish word text, XML-ish markup, tabular
    records, and a slice of incompressible noise."""
    import random

    rng = random.Random(0xBEEF)
    import itertools

    words = [
        "".join(rng.choice("abcdefghijklmnopqrstuvwxyz") for _ in range(rng.randrange(2, 10)))
        for _ in range(4000)
    ]
    cum = list(itertools.accumulate(1.0 / (i + 1) for i in range(len(words))))
    pick = lambda: rng.choices(words, cum_weights=cum)[0]
    base = bytearray()
    while len(base) < 1 << 20:
        kind = rng.random()
        if kind < 0.55:  # prose
            sent = " ".join(pick() for _ in range(rng.randrange(6, 18)))
            base += (sent.capitalize() + ". ").encode()
        elif kind < 0.75:  # markup
            w = pick()
            base += f"<{w} id=\"{rng.randrange(10**6)}\">{pick()}</{w}>\n".encode()
        elif kind < 0.95:  # records
            base += (
                f"{rng.randrange(10**8):08d},{pick()},"
                f"{rng.randrange(10**6):06d},OK;\n"
            ).encode()
        else:  # noise
            base += bytes(rng.randrange(256) for _ in range(rng.randrange(40, 200)))
    base = bytes(base)
    out = bytearray()
    while len(out) < n:
        chunk = bytearray(base)
        for _ in range(len(chunk) // 256):
            chunk[rng.randrange(len(chunk))] = rng.randrange(32, 127)
        out += chunk
    return bytes(out[:n])


STAMP = {}  # device + card fields every line carries (set in main)


def emit(metric, value, unit, vs_baseline, **extra):
    line = {"metric": metric, "value": round(value, 2), "unit": unit,
            "vs_baseline": round(vs_baseline, 3)}
    line.update(extra)
    line.update(STAMP)
    print(json.dumps(line), flush=True)


def best_of(fn, reps=REPS):
    times = []
    for _ in range(reps):
        t0 = time.time()
        fn()
        times.append(time.time() - t0)
    return min(times)


def over_budget(section: str, est_s: float) -> bool:
    """True (and logs) when `section` would not fit the remaining budget."""
    left = BUDGET_S - (time.time() - _T0)
    if left < est_s:
        print(f"bench: skipping {section}: {left:.0f}s left < ~{est_s:.0f}s "
              f"estimated (budget {BUDGET_S:.0f}s)", file=sys.stderr, flush=True)
        return True
    return False


def device_stamp() -> dict:
    """The GPU this run measures; exits when JAX has none."""
    import jax

    from nlzm_tpu.utils.device import card_lines

    devs = jax.devices()
    if devs[0].platform != "gpu":
        sys.exit(f"bench: JAX platform is {devs[0].platform!r}, not 'gpu'; "
                 "not benching")
    cards = card_lines()
    name, _, limit = (cards[0] if cards else "unknown, unknown").partition(", ")
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs), "card": name, "power_limit": limit}


def main() -> None:
    from nlzm_tpu.utils.compile_cache import enable_compile_cache
    from nlzm_tpu.utils.device import insist_on_cuda

    insist_on_cuda()
    import jax

    STAMP.update(device_stamp())
    enable_compile_cache()
    import jax.numpy as jnp
    import numpy as np

    from nlzm_tpu.ops.wide_decode import (
        decode_wide_staged, prepare_wide_bucketed, rounds_hint_of)
    from nlzm_tpu.parallel.blocks import block_payloads, encode_container, parse_container

    data = build_corpus(CORPUS_MB * 1_000_000)
    n = len(data)
    N_BUCKETS = int(os.environ.get("NLZM_BENCH_BUCKETS", "2"))

    # ---- shared wide-profile plumbing (primary + frontier use this) ----
    def stage_all(container, info):
        payloads = block_payloads(container, info)
        buckets = prepare_wide_bucketed(
            payloads, info.wide_priors, n_buckets=N_BUCKETS)
        dict_arr = (
            jnp.asarray(np.frombuffer(info.dictionary, np.uint8))
            if info.dictionary else None
        )
        for staged, idx in buckets:
            staged["rounds_hint"] = rounds_hint_of(
                max((info.total_reads[b] for b in idx), default=0))
            staged["dict_arr"] = dict_arr
        return buckets, dict_arr

    def verify_buckets(info, buckets, label):
        """Warmup/compile + full correctness check (untimed). An
        AssertionError here must propagate - a decode mismatch is a
        correctness regression, not a skippable bench hiccup."""
        full = np.empty(len(info.comp_sizes) * info.block_size, np.uint8)
        for staged, idx in buckets:
            out, _produced = decode_wide_staged(staged, info.block_size)
            out_np = np.asarray(out)
            for row, b in enumerate(idx):
                full[b * info.block_size : (b + 1) * info.block_size] = out_np[row]
        assert full.tobytes()[: info.total_len] == data, f"{label} decode mismatch"

    def make_run(info, buckets):
        def run():
            jax.block_until_ready(
                [decode_wide_staged(staged, info.block_size) for staged, _ in buckets])
        return run

    # ---- build the primary container (host encode timing comes free) ----
    t0 = time.time()
    container = encode_container(
        data, block_size=BLOCK_SIZE, parser="optimal", profile="wide",
        dict_size=DICT_SIZE,
    )
    enc_secs = time.time() - t0

    # ---- PRIMARY metric: wide-profile staged decode, emitted first ----
    t_stage0 = time.time()
    info = parse_container(container)
    buckets, dict_arr = stage_all(container, info)
    staging_first = time.time() - t_stage0

    verify_buckets(info, buckets, "device wide")
    run_full = make_run(info, buckets)
    best = best_of(run_full)
    mbs = n / best / 1e6

    # stage breakdown: cumulative sync points (scan -> +assembly ->
    # +expansion); informational, measured with the same best-of
    from nlzm_tpu.ops.wide_decode import (
        PLANES, assemble_ops, plane_scan_fused, stage_windows_of)
    from nlzm_tpu.ops.expand_ops import lz_expand_parallel
    from nlzm_tpu.ops.sort_gather import PACK_MAX

    NP = len(PLANES)

    def run_stages(upto):
        outs = []
        for staged, _ in buckets:
            n_sym, steps = staged["n_sym"], staged["steps"]
            priors = staged.get("priors")
            big = info.block_size > PACK_MAX
            cap15 = (lambda a: a) if big else (
                lambda a: a[:, : min(a.shape[1], 1 << 15)])
            wins = stage_windows_of(staged)
            seeds_f = staged["seeds_cat"]
            nsyms_f = jnp.stack([n_sym[i] for i in range(NP)], axis=1)
            priors_f = None
            if priors:
                priors_f = tuple(priors[PLANES[p].name][0] for p in range(NP))
            ys = plane_scan_fused(seeds_f, wins, nsyms_f, steps[0], priors_f)
            tok_y, lit_y, len_y, lex_y, slot_y = map(cap15, ys)
            if upto == "scans":
                outs.append(ys)
                continue
            op_len, op_val = assemble_ops(
                tok_y, len_y, lex_y, lit_y, slot_y, staged["bit_half"],
                n_sym[0], big, wide_delta=dict_arr is not None)
            if upto == "assembly":
                outs.append((op_len, op_val))
                continue
            outs.append(lz_expand_parallel(
                op_len, op_val, info.block_size, staged["rounds_hint"], dict_arr))
        jax.block_until_ready(outs)

    run_stages("scans")  # warm the stage-split graphs
    run_stages("assembly")
    t_scans = best_of(lambda: run_stages("scans"))
    t_asm = best_of(lambda: run_stages("assembly"))

    # e2e: the FULL pipeline per rep - container bytes -> host parse +
    # compact staging -> H2D upload -> device decode -> checksum fetch.
    # Host staging of bucket k overlaps device compute of bucket k-1
    # (dispatch is async). Steady-state best-of, same as every metric.
    def run_e2e():
        info2 = parse_container(container)
        buckets2, _ = stage_all(container, info2)
        jax.block_until_ready(
            [decode_wide_staged(staged, info2.block_size) for staged, _ in buckets2])

    e2e_best = best_of(run_e2e)
    staging_best = best_of(lambda: (parse_container(container), stage_all(
        container, info)))

    def emit_primary():
        emit(
            "device_block_parallel_decode_throughput", mbs, "MB/s", mbs / 123.0,
            dict_kib=(len(info.dictionary) // 1024 if info.dictionary else 0),
            ratio=round(len(container) / n, 4),
            stage_scans_ms=round(t_scans * 1e3, 1),
            stage_assembly_ms=round(max(t_asm - t_scans, 0.0) * 1e3, 1),
            stage_expansion_ms=round(max(best - t_asm, 0.0) * 1e3, 1),
            staging_ms=round(staging_best * 1e3, 1),
            staging_first_ms=round(staging_first * 1e3, 1),
            e2e_mbs=round(n / e2e_best / 1e6, 2),
        )

    emit_primary()

    # ---- host encode metric (timing already paid above) ----
    emit("host_wide_encode_throughput", n / enc_secs / 1e6, "MB/s",
         (n / enc_secs / 1e6) / 1.8)
    emit_primary()

    # ---- device wide plane encode (ops/wide_encode_dev.py) ----
    # e2e framing (like-for-like vs the reference's 1.8 MB/s e2e):
    # host parse+lift+classify, plane staging, then the on-chip plane
    # encode. Byte-parity of the full device payloads vs the host
    # encoder is asserted untimed on a 1 MiB slice (tests/test_wide.py
    # holds the full four-way differential).
    from nlzm_tpu import native as _native

    if _native.available() and not over_budget("device encode", 180):
        try:
            from nlzm_tpu.ops.wide_encode_dev import (
                encode_pipeline_device, encode_wide_blocks_device)

            run_enc, enc_parse, stage_enc, enc_staging_first = encode_pipeline_device(
                data, BLOCK_SIZE)
            run_enc()  # compile
            small = data[: 1 << 20]
            from nlzm_tpu.format import wide as _wide
            ol2, ov2 = _native.parse_blocks(small, BLOCK_SIZE, 15)
            ol2 = np.ascontiguousarray(ol2, np.int32)
            ov2 = np.ascontiguousarray(ov2, np.int32)
            _native.lift_deep(ol2, ov2, BLOCK_SIZE)
            or2 = _native.classify_reps(ol2, ov2)
            ph, bh = _wide.encode_wide_blocks(ol2, ov2, or2)
            pd, bd = encode_wide_blocks_device(ol2, ov2, or2)
            assert ph == pd and bh == bd, "device wide encode parity mismatch"
            enc_best = best_of(run_enc)
            enc_staging = best_of(stage_enc, reps=3)  # steady state
            enc_e2e = enc_parse + enc_staging + enc_best
            emit("device_wide_encode_throughput", n / enc_e2e / 1e6, "MB/s",
                 (n / enc_e2e / 1e6) / 1.8,
                 stage_only_mbs=round(n / enc_best / 1e6, 2),
                 parse_ms=round(enc_parse * 1e3, 1),
                 staging_ms=round(enc_staging * 1e3, 1),
                 staging_first_ms=round(enc_staging_first * 1e3, 1))
        except AssertionError:
            raise  # encode parity regression: fail the bench loudly
        except Exception as e:  # pragma: no cover - diagnostics only
            print(f"bench: device encode section failed: {e!r}",
                  file=sys.stderr, flush=True)
        emit_primary()

    # ---- v1 FSM profile decode (the reference-compatible block profile) ----
    if not over_budget("v1 profile", 150):
        from nlzm_tpu.parallel.blocks import decode_v1_staged, stage_v1_buckets

        v1c = encode_container(data, block_size=BLOCK_SIZE, parser="optimal")
        v1info = parse_container(v1c)
        v1buckets = stage_v1_buckets(v1c, v1info)

        def run_v1():
            jax.block_until_ready([
                decode_v1_staged(streams, num_steps, v1info.block_size)
                for streams, num_steps, _ in v1buckets])

        # warmup + correctness
        v1_full = np.empty(len(v1info.comp_sizes) * v1info.block_size, np.uint8)
        for streams, num_steps, idx in v1buckets:
            out_np = np.asarray(
                decode_v1_staged(streams, num_steps, v1info.block_size)[0])
            for row, b in enumerate(idx):
                v1_full[b * v1info.block_size : (b + 1) * v1info.block_size] = (
                    out_np[row])
        assert v1_full.tobytes()[: v1info.total_len] == data, "device v1 decode mismatch"
        v1_best = best_of(run_v1)
        emit("device_v1_decode_throughput", n / v1_best / 1e6, "MB/s",
             (n / v1_best / 1e6) / 123.0)
        emit_primary()

    # ---- NLZC (device PPM-class) decode: research codec, NOT headline ----
    # Off by default: its ratio (0.566 vs the reference PPMd var.I's 0.337
    # on this mix) puts it far behind. Set NLZM_BENCH_NLZC=1 to measure it.
    if os.environ.get("NLZM_BENCH_NLZC") == "1" and not over_budget("NLZC", 150):
        from nlzm_tpu.research import ppm_tpu

        nlzc_data = data[: 4 << 20]
        nlzc_blob = ppm_tpu.compress(nlzc_data, block_size=16384)
        words_c, seg_c, prior_c, steps_c, seg_np, tot_c, B_c = ppm_tpu.stage_container(
            nlzc_blob)
        # warmup + correctness
        assert ppm_tpu.decompress(nlzc_blob) == nlzc_data, "NLZC decode mismatch"

        def run_nlzc():
            jax.block_until_ready(
                ppm_tpu._decode_blocks(words_c, seg_c, prior_c, steps_c))

        nlzc_best = best_of(run_nlzc)
        emit("device_nlzc_decode_throughput", len(nlzc_data) / nlzc_best / 1e6, "MB/s",
             (len(nlzc_data) / nlzc_best / 1e6) / 3.42,
             blocks=B_c, ratio=round(len(nlzc_blob) / len(nlzc_data), 4),
             ppmd_ref_ratio=0.337)
        emit_primary()

    # ---- frontier config: 128 KiB blocks + 128 KiB dict + depth 12 ----
    # The best measured ratio point (round-5 A/B on the 16 MiB
    # non-periodic corpus: 1.137x oracle-w20 vs 1.192x for the old
    # 64 KiB-dict/cap-8 frontier; dict and cap contribute ~3.5% and
    # ~2.2%). Costs one extra doubling round (cap 12 -> 4 rounds) on the
    # 2-operand sort path. Ratio anchor: oracle-w20 = 0.3687 on the
    # non-periodic corpus (tests/test_ratio_guard.py). Any failure here,
    # compile or memory included, fails the bench.
    if not over_budget("frontier config", 180):
        fcont = encode_container(
            data, block_size=131072, parser="optimal", profile="wide",
            dict_size=131072, depth_cap=12,
        )
        finfo = parse_container(fcont)
        fbuckets, _fdict = stage_all(fcont, finfo)
        emit("wide_frontier_ratio", len(fcont) / n, "ratio",
             (len(fcont) / n) / (len(container) / n), block_kib=128,
             dict_kib=128, depth_cap=12,
             headline_ratio=round(len(container) / n, 4))
        verify_buckets(finfo, fbuckets, "frontier")
        f_best = best_of(make_run(finfo, fbuckets))
        emit("device_wide_frontier_decode_throughput",
             n / f_best / 1e6, "MB/s",
             (n / f_best / 1e6) / 123.0, block_kib=128,
             dict_kib=128, depth_cap=12,
             ratio=round(len(fcont) / n, 4))
        emit_primary()

    # ---- primary metric re-emitted as the guaranteed last line ----
    emit_primary()


if __name__ == "__main__":
    main()
