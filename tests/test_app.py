"""End-to-end smoke test of the application CLI (src/main.cu's surface:
argument handling, frame loop, golden benchmark, log.txt + metrics.jsonl
— SURVEY §1 L6).  The reference has no tests at all; this drives the
whole L6 layer the way a user invokes it."""

import json

import pytest

from nrc_hpm.app import main


@pytest.mark.slow
def test_app_cli_mc_smoke(tmp_path):
    out = tmp_path / "run"
    rc = main(["--renderer", "mc", "--frames", "2", "--width", "96",
               "--height", "54", "--platform", "cpu", "--out", str(out)])
    assert rc == 0
    # log.txt exists but carries only NRC benchmark lines
    # (main.cu:140-150 logs the NRC compare); an MC-only run leaves it
    # empty, matching the reference's LogFile usage
    assert (out / "log.txt").exists()
    # metrics.jsonl: one record per frame with the
    # Reference::Compare-derived MC stats and frame timings
    metrics = [json.loads(l) for l in
               (out / "metrics.jsonl").read_text().splitlines()]
    frames = [m for m in metrics if "frame" in m]
    assert len(frames) == 2
    for i, rec in enumerate(frames):
        assert rec["frame"] == i
        assert rec["frame_time_ms"] > 0
        mc = rec["mc"]
        assert 0.0 <= mc["mse"] < 10.0
        assert abs(mc["rel_bias"]) < 1.5
        assert mc["cv"] > 0.0


@pytest.mark.slow
def test_app_cli_defaults_parse_17_args(tmp_path):
    """The 17 positional args parse into the same config the defaults
    load (AppConfig.from_argv round-trip through the CLI layer)."""
    from nrc_hpm.config import DEFAULT_ARGV, AppConfig

    cfg = AppConfig.from_argv(DEFAULT_ARGV)
    assert cfg.scene.id == 4
    assert cfg.train_ray_length == 32
    assert len(DEFAULT_ARGV) == 17


def test_app_cli_seeded_cloud(tmp_path):
    """--seeded-cloud renders the seeded stand-in volume, so the app runs
    without the scene's VDB; golden comparisons are off then."""
    out = tmp_path / "run"
    rc = main(["--renderer", "mc", "--frames", "2", "--width", "32",
               "--height", "18", "--platform", "cpu", "--seeded-cloud", "0",
               "--out", str(out)])
    assert rc == 0
    metrics = [json.loads(l) for l in
               (out / "metrics.jsonl").read_text().splitlines()]
    frames = [m for m in metrics if "frame" in m]
    assert [m["frame"] for m in frames] == [0, 1]
    assert all(m["frame_time_ms"] > 0 and "mc" not in m for m in frames)


def test_platform_gpu_exits_nonzero_without_gpu(capsys):
    """--platform gpu (the default) refuses to run when JAX finds no GPU,
    instead of falling back to the CPU."""
    rc = main(["--renderer", "mc", "--frames", "1", "--platform", "gpu"])
    assert rc != 0
    assert "no GPU" in capsys.readouterr().err
