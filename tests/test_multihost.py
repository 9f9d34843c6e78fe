"""Multi-host (multi-process) execution test.

Spawns TWO OS processes, each contributing 4 virtual CPU devices to one
8-device mesh via jax.distributed, runs the sharded NRC renderer for two
training steps, and checks the gathered image against the single-process
8-device run — the per-shard computation is a pure function of global
coordinates, so the two topologies must agree to float tolerance (the
gradient psum may reassociate across DCN).

New capability: the reference is single-GPU single-process (SURVEY §5).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.slow
def test_two_process_matches_single_process(tmp_path):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    outs = [str(tmp_path / f"img{i}.npy") for i in range(2)]

    env_base = dict(os.environ)
    env_base.pop("XLA_FLAGS", None)
    env_base["JAX_PLATFORMS"] = "cpu"

    procs = []
    for pid in range(2):
        cmd = [sys.executable, "-m", "nrc_hpm.parallel.multihost",
               "--coordinator", coord, "--num-processes", "2",
               "--process-id", str(pid), "--local-devices", "4",
               "--platform", "cpu", "--steps", "2",
               "--width", "64", "--height", "32", "--out", outs[pid]]
        procs.append(subprocess.Popen(
            cmd, cwd=REPO, env=env_base,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    rcs = [p.wait(timeout=900) for p in procs]
    logs = [p.stdout.read().decode() for p in procs]
    assert rcs == [0, 0], f"worker failed:\n{logs[0]}\n---\n{logs[1]}"
    img2 = np.load(outs[0])

    # single-process 8-device reference
    cmd = [sys.executable, "-m", "nrc_hpm.parallel.multihost",
           "--coordinator", f"127.0.0.1:{_free_port()}",
           "--num-processes", "1", "--process-id", "0",
           "--local-devices", "8", "--platform", "cpu", "--steps", "2",
           "--width", "64", "--height", "32",
           "--out", str(tmp_path / "img_single.npy")]
    r = subprocess.run(cmd, cwd=REPO, env=env_base, capture_output=True,
                       timeout=900)
    assert r.returncode == 0, r.stdout.decode() + r.stderr.decode()
    img1 = np.load(tmp_path / "img_single.npy")

    assert img2.shape == img1.shape
    np.testing.assert_allclose(img2, img1, atol=1e-5, rtol=1e-5)
