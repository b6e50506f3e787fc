"""A run of the port's mesh across two processes on the CPU: two
``herdsman_tpu_torch.mesh._dcn_check`` processes join through
``torch.distributed`` (gloo) on a free local port, four CPU positions
each, and run the sharded gate step, a limb-sum bootstrap, map + reduce
plans, a sharded PBS and ``mega13``'s batch parallelism across the process
boundary; each checks that the outputs decrypt exactly and prints its
``MULTIPROCESS OK`` line (the JAX package's ``tests/test_multiprocess.py``
for the port).  Subprocesses, so that this process's torch stays
single-process; each has its own timeout, so that a hung collective fails
the test instead of holding the suite.
"""

import os
import pathlib
import socket
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_two_process_mesh_on_cpu():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()

    # one intra-op thread a process: two processes with a pool each run
    # many times slower beside the suite's other workers
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT) + os.pathsep
               + os.environ.get("PYTHONPATH", ""))
    procs = [
        subprocess.Popen(
            [sys.executable, "-m", "herdsman_tpu_torch.mesh._dcn_check",
             "--coordinator", f"localhost:{port}", "--num-processes", "2",
             "--process-id", str(i), "--local-devices", "4",
             "--device", "cpu"],
            cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=env)
        for i in range(2)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, (
            f"process {i} failed (rc={p.returncode}):\n{out[-4000:]}")
        assert f"MULTIPROCESS OK: process {i}/2, 8 positions" in out, \
            out[-2000:]
        assert "mesh (4, 2) over gloo" in out
        assert ("herd step + limb-sum bootstrap on conv_i8 + map/reduce "
                "plan [SEQUENCED + PARALLEL_FULL] + sharded PBS + mega13 DP"
                ) in out
