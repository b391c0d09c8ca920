"""chip_smoke.py's phases at tiny sizes on the CPU backend.

Each phase runs its real code path (device engine under jit, here on the
CPU) with byte-exact checks; the sizes are cut so the whole file stays
quick. main() itself must refuse to report success without a GPU.
"""

import pytest

import chip_smoke
from nlzm_tpu import native
from nlzm_tpu.utils.corpus import build_nonperiodic


@pytest.fixture(scope="module")
def data():
    return build_nonperiodic(160_000, seed=chip_smoke.SEED)


@pytest.fixture(autouse=True)
def _need_native():
    if not native.available():
        pytest.skip("native lib not built")


def _phase_ok(out: str, label: str) -> bool:
    return any(ln.startswith(f"phase {label}:") and ln.endswith("byte-exact OK")
               for ln in out.splitlines())


def test_main_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    assert '"ok": true' not in capsys.readouterr().out


def test_phase_device_reports_platform(capsys):
    dev = chip_smoke.phase_device(require_gpu=False)
    assert dev == {"platform": "cpu", "kind": "cpu", "count": 8}
    assert "phase 1 device: jax platform=cpu" in capsys.readouterr().out
    with pytest.raises(chip_smoke.SmokeFailure, match="not 'gpu'"):
        chip_smoke.phase_device()


def test_phase_wide(data, tmp_path, capsys):
    c = chip_smoke.phase_wide(data, tmp_path, block_size=16384, dict_size=8192)
    assert c[:4] == b"NLZP" and (tmp_path / "wide.out").read_bytes() == data
    assert _phase_ok(capsys.readouterr().out, "2 wide")


def test_phase_v1(data, tmp_path, capsys):
    c = chip_smoke.phase_v1(data, tmp_path, block_flag="-blocks:32768")
    assert c[:4] == b"NLZP"
    assert _phase_ok(capsys.readouterr().out, "3 v1")


def test_phase_frontier_two_operand_path(data, capsys):
    from nlzm_tpu.ops.sort_gather import PACK_MAX

    block = 65536
    assert block > PACK_MAX  # the two-operand sort path
    chip_smoke.phase_frontier(data, block_size=block, dict_size=block)
    assert _phase_ok(capsys.readouterr().out, "4 frontier")


def test_phase_device_encode(data, capsys):
    chip_smoke.phase_device_encode(data[:40_000], v1_block=4096, wide_block=8192)
    assert _phase_ok(capsys.readouterr().out, "5 device-encode")


def test_phase_research(data, capsys):
    chip_smoke.phase_research(data[:40_000], nlzc_block=4096)
    assert _phase_ok(capsys.readouterr().out, "6 research")


def test_phase_four_cards_on_virtual_mesh(data, tmp_path, capsys):
    wide = data[:100_000]
    chip_smoke.phase_four_cards(wide, data[:60_000], tmp_path, n_cards=4)
    out = capsys.readouterr().out
    assert _phase_ok(out, "4-card wide") and _phase_ok(out, "4-card v1")
    shard_lines = [ln for ln in out.splitlines() if ln.startswith("shards ")]
    assert len(shard_lines) == 2 and all(ln.count("TFRT_CPU_") == 4 for ln in shard_lines)


def test_phase_failure_is_reported(capsys):
    with pytest.raises(chip_smoke.SmokeFailure):
        with chip_smoke.Phase("x", 1):
            chip_smoke.check(False, "boom")
    line = capsys.readouterr().out.splitlines()[-1]
    assert line.startswith("phase x: in=1 B") and line.endswith("FAILED (SmokeFailure)")


def test_compile_log_names_jitted_functions():
    import jax
    import jax.numpy as jnp

    log = chip_smoke.compile_log()
    snap = log.snapshot()

    @jax.jit
    def smoke_probe_fn(x):
        return x * 3 + 1

    smoke_probe_fn(jnp.arange(5))
    assert "smoke_probe_fn" in log.since(snap)
