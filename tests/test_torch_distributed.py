"""The port's ``torch.distributed`` path in two processes (gloo on the
CPU): ``tests/test_distributed.py`` for ``pathtracer_tpu_torch``.

``tests/_torch_distributed_worker.py`` runs in each process, one CPU
shard each: a 16x16 sharded render and one sharded gradient step, held by
rank 0 against the single-device results.  A misconfigured launch (``
WORLD_SIZE`` without ``RANK``) raises and names the missing variable.
"""

import tests.torch_threads  # noqa: F401  (first: one torch thread per xdist worker)
import os
import socket
import subprocess
import sys

import pytest
import torch

from pathtracer_tpu_torch.parallel.mesh import initialize_distributed
from tests.test_bounce_grad import MINI_SCENE

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(argv, world: int, timeout: float = 240, extra_env=None) -> list:
    """Run ``argv`` in ``world`` processes with torchrun's variables set;
    returns their ``(returncode, output)``, killing all of them on a
    timeout."""
    port = free_port()
    procs = []
    for rank in range(world):
        env = dict(os.environ)
        env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), WORLD_SIZE=str(world),
                   RANK=str(rank), LOCAL_RANK=str(rank), OMP_NUM_THREADS="1",
                   PYTHONPATH=ROOT + os.pathsep + env.get("PYTHONPATH", ""), **(extra_env or {}))
        procs.append(subprocess.Popen(argv, env=env, cwd=ROOT, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    for p in procs:
        try:
            outs.append((p.communicate(timeout=timeout)[0], p))
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            for q in procs:
                q.communicate()
            pytest.fail("a distributed process timed out")
    return [(p.returncode, out) for out, p in outs]


def test_two_process_sharded_render_and_gradient():
    worker = os.path.join(ROOT, "tests", "_torch_distributed_worker.py")
    results = launch([sys.executable, worker], 2, extra_env={"PT_MINI_SCENE": MINI_SCENE})
    for rank, (rc, out) in enumerate(results):
        assert rc == 0, f"process {rank} failed:\n{out}"
        assert f"DIST_OK {rank}" in out, out
    # both ranks saw the same all-reduced ray count and loss
    tails = [out.split(f"DIST_OK {r} ")[1].split()[:2] for r, (_, out) in enumerate(results)]
    assert tails[0] == tails[1]


def test_world_size_without_rank_names_rank(monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.delenv("RANK", raising=False)
    with pytest.raises(RuntimeError, match="RANK is missing"):
        initialize_distributed("cpu")
    assert not torch.distributed.is_initialized()
