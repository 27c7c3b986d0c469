"""True multi-process jax.distributed test: 2 OS processes x 4 virtual CPU
devices form one 8-device global mesh over local TCP (the multi-host analogue;
SURVEY.md §5 'distributed communication backend'). Each process runs the
same sharded bank step; the worker asserts process_count==2 and that the
globally-sharded solve matches a process-local reference."""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.slow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "dist_worker.py")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_global_mesh():
    port = _free_port()
    procs = []
    for pid in range(2):
        env = dict(os.environ)
        env.update(
            JAX_PLATFORMS="cpu",
            XLA_FLAGS="--xla_force_host_platform_device_count=4",
            JAX_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
            JAX_NUM_PROCESSES="2",
            JAX_PROCESS_ID=str(pid),
            PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""),
        )
        procs.append(
            subprocess.Popen(
                [sys.executable, WORKER],
                env=env,
                stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT,
                text=True,
            )
        )
    outputs = []
    for p in procs:
        out, _ = p.communicate(timeout=240)
        outputs.append(out)
    for pid, (p, out) in enumerate(zip(procs, outputs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out}"
        assert "DIST_OK" in out, f"worker {pid} no DIST_OK:\n{out}"
        assert '"process_count": 2' in out
        assert '"global_devices": 8' in out
