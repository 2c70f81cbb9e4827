"""chip_smoke.py's phases at a tiny size on the CPU platform.

The phases drive `./siga` subprocesses; here they run with JAX_PLATFORMS=cpu
and check the same byte-equalities the card run checks."""
import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

TINY = chip_smoke.Sizes(
    genome_bp=20_000,
    coverage=20,
    parity_coverage=6,
    parity_min_chars=100_000,
    subset_genome_bp=6_000,
    subset_coverage=10,
    check_metrics=False,
)


def _cpu_env(devices=1):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = f"--xla_force_host_platform_device_count={devices}"
    return env


def test_parity_phase_on_cpu(tmp_path):
    runner = chip_smoke.Runner(str(tmp_path), _cpu_env())
    out = chip_smoke.parity(runner, TINY, platform="cpu")
    assert out["index"]["equal"] and out["index"]["chars"] >= 100_000
    assert out["overlap"]["equal"] and out["overlap"]["edges"] > 0
    assert out["rmdup"]["equal"]
    assert [s.builder() for s in runner.stages if s.name.startswith("parity_index")] == [
        "device", "numpy"]


def test_pipeline_phase_on_cpu(tmp_path):
    runner = chip_smoke.Runner(str(tmp_path), _cpu_env())
    out = chip_smoke.main_path(runner, TINY, platform="cpu")
    assert out["native_loaded"]
    assert list(out["stage_sec"]) == [n for n, _a in chip_smoke._recipe().pipeline("p")]
    assert set(out["index_builder"].values()) == {"device"}
    m = out["contig_metrics"]
    assert int(m["contig_number"]) > 0 and m["unmatched_contig"] == "0"


def test_four_device_phase_on_cpu(tmp_path):
    runner = chip_smoke.Runner(str(tmp_path), _cpu_env())
    sizes = chip_smoke.Sizes(genome_bp=20_000, four_coverage=6)
    out = chip_smoke.four_cards(
        runner, sizes, multi_env={"XLA_FLAGS": _cpu_env(4)["XLA_FLAGS"]},
        single_env={}, platform="cpu",
    )
    for cmd in ("overlap", "rmdup"):
        assert out[cmd]["equal"] and out[cmd]["lane_devices"] == [0, 1, 2, 3]


def test_device_check_refuses_cpu(tmp_path):
    with pytest.raises(chip_smoke.SmokeError, match="not 'gpu'"):
        chip_smoke.device_check(str(tmp_path), env=_cpu_env())
    assert chip_smoke.device_check(str(tmp_path), "cpu", _cpu_env())["count"] == 1


def test_main_exits_nonzero_without_gpu(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    # a host without nvidia-smi, and one whose JAX finds only the CPU
    monkeypatch.setattr(chip_smoke, "card_line", lambda: "Fake Card, 700.00 W")
    rc = chip_smoke.main(["--workdir", str(tmp_path / "w")])
    out = capsys.readouterr().out
    assert rc != 0
    assert '"ok"' not in out
    monkeypatch.undo()
    monkeypatch.setenv("PATH", str(tmp_path))  # no nvidia-smi on the path
    rc = chip_smoke.main(["--workdir", str(tmp_path / "w")])
    assert rc != 0 and '"ok"' not in capsys.readouterr().out


@pytest.mark.gpu
def test_chip_smoke_on_gpu(gpu, tmp_path):
    import subprocess

    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--workdir", str(tmp_path / "w")],
        env=env, capture_output=True, text=True, timeout=1500,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
