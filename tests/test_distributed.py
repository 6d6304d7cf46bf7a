"""Real multi-process jax.distributed integration test.

Launches 2 separate Python processes (tests/distributed_worker.py), each
with 2 virtual CPU devices, connected through `jax.distributed.initialize`
via the framework's DistributedConfig path (parallel/distributed.py). The
sharded window solve then runs over the 4-device global mesh with each
process owning half the windows — the actual multi-host execution model of
a GPU cluster (SURVEY.md §2.3 "collective comms backend").
"""

import json
import os
import socket
import subprocess
import sys

import pytest


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_sharded_solve(n_proc: int):
    port = _free_port()
    coord = f"127.0.0.1:{port}"
    worker = os.path.join(os.path.dirname(__file__), "distributed_worker.py")

    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    flags = [
        f
        for f in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in f
    ]
    flags.append("--xla_force_host_platform_device_count=2")
    env["XLA_FLAGS"] = " ".join(flags).strip()
    # the worker inserts the repo root into sys.path itself

    procs = [
        subprocess.Popen(
            [sys.executable, worker, coord, str(n_proc), str(pid)],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.PIPE,
            text=True,
        )
        for pid in range(n_proc)
    ]
    try:
        outs = [p.communicate(timeout=540) for p in procs]
    finally:
        # one worker dying leaves the other blocked at the distributed
        # barrier — never leak it past the test
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, f"worker failed:\n{err[-4000:]}"

    result = json.loads(outs[0][0].strip().splitlines()[-1])
    assert result["n_processes"] == n_proc
    assert result["n_devices"] == 2 * n_proc
    assert result["local_devices"] == 2
    assert result["finite"]


def test_two_process_sharded_solve():
    _run_sharded_solve(2)


@pytest.mark.slow
def test_four_process_sharded_solve():
    """4 processes x 2 virtual devices = 8-device global mesh (VERDICT r4
    item 5) — the pod-slice shape of the multi-host execution model."""
    _run_sharded_solve(4)
