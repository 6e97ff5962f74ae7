"""Multi-host validation without a cluster: two localhost jax.distributed
processes, 4 virtual CPU devices each, one global 8-device mesh running the
sharded pipeline (SURVEY.md Sec. 4 / 5.8)."""

import os
import socket
import subprocess
import sys
from pathlib import Path


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_sharded_topk():
    port = _free_port()
    driver = Path(__file__).parent / "multihost_driver.py"
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    env["JAX_NUM_CPU_DEVICES"] = "4"
    procs = [
        subprocess.Popen([sys.executable, str(driver), str(i), "2",
                          str(port)],
                         env=env, cwd=str(Path(__file__).parent.parent),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True)
        for i in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            p.kill()
            out, err = p.communicate()
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err[-2000:]}"
    assert "MULTIHOST_OK" in outs[0][1], outs[0]
