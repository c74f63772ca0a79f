"""Multi-process init and the cross-process data-parallel step of the port
(larvanet_tpu_torch/parallel/distributed.py, mesh.py), the counterpart of
tests/test_distributed.py: two CPU worker processes joined by gloo over
127.0.0.1 on a free port. The workers run in subprocesses (a process joins
one default group), and a hung worker is killed at its timeout."""

import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 180

INIT_WORKER = r"""
import sys
import torch
import torch.distributed as dist
from larvanet_tpu_torch.parallel.distributed import init_distributed, is_primary, world_size

rank = int(sys.argv[2])
assert init_distributed(coordinator_address=sys.argv[1], num_processes=2, process_id=rank)
assert dist.get_backend() == "gloo" and world_size() == 2
assert is_primary() == (rank == 0)
got = [torch.zeros(1) for _ in range(2)]
dist.all_gather(got, torch.tensor([float(rank)]))
assert [float(t) for t in got] == [0.0, 1.0], got
dist.destroy_process_group()
print("WORKER_OK", rank)
"""

TRAIN_WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.parallel.distributed import init_distributed
from larvanet_tpu_torch.parallel.mesh import make_dp_train_step, make_mesh

torch.set_num_threads(1)
rank = int(sys.argv[2])
assert init_distributed(sys.argv[1], 2, rank)

def edsr(seed):
    m = get_model("edsr")
    m.parse_args(["--edsr_res_blocks", "1", "--edsr_conv_features", "8", "--packed_trunk", "0"])
    m.prepare([4], device="cpu", seed=seed, is_training=True)
    return m

# the same seed on both workers: each can form the global batch, and takes
# its half over its 2-device mesh; rank 1 starts from other weights, which
# the step's broadcast replaces with rank 0's
rng = np.random.default_rng(0)
x = torch.from_numpy(rng.uniform(0, 255, (8, 12, 12, 3)).astype(np.float32))
y = torch.from_numpy(rng.uniform(0, 255, (8, 48, 48, 3)).astype(np.float32))
model = edsr(seed=rank)
step = make_dp_train_step(model, make_mesh((2,), ("data",), [torch.device("cpu")] * 2))
loss = float(step(x[rank * 4:(rank + 1) * 4], y[rank * 4:(rank + 1) * 4], 1e-4))

ref = edsr(seed=0)  # the single-device step on the whole global batch
ref_loss = float(ref._optimizer_step(x, y, 1e-4))
assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss), (loss, ref_loss)
err = max(float((a - b).detach().abs().max())
          for a, b in zip(model.module.parameters(), ref.module.parameters()))
assert err <= 1e-5, err
dist.destroy_process_group()
print("TRAIN_WORKER_OK %d loss=%.6f ref=%.6f err=%.3g" % (rank, loss, ref_loss, err))
"""


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _run_workers(script, marker):
    coord = "127.0.0.1:%d" % _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    for key in ("COORDINATOR", "NUM_PROCESSES", "PROCESS_ID"):
        env.pop(key, None)
    procs = [subprocess.Popen([sys.executable, "-c", script, coord, str(i)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                              env=env, cwd=REPO)
             for i in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, "worker %d failed:\n%s" % (i, out)
        assert "%s %d" % (marker, i) in out
    return outs


def test_two_process_init_primary_and_all_gather():
    _run_workers(INIT_WORKER, "WORKER_OK")


def test_two_processes_of_two_devices_dp_step_equals_the_single_device_step():
    """2 processes x 2 virtual devices: the 4-way step (each device's shard
    mean, then gloo's all-reduce) equals one single-device step on the
    global batch: loss rel 1e-5, parameters 1e-5."""
    outs = _run_workers(TRAIN_WORKER, "TRAIN_WORKER_OK")
    print("".join(line for out in outs for line in out.splitlines(True)
                  if "TRAIN_WORKER_OK" in line))


def test_init_distributed_is_a_noop_without_coordinator(monkeypatch):
    from larvanet_tpu_torch.parallel import distributed

    monkeypatch.delenv("COORDINATOR", raising=False)
    assert distributed.init_distributed() is False
    assert distributed.is_primary() is True and distributed.world_size() == 1


def test_process_id_zero_is_not_taken_from_the_environment(monkeypatch):
    """process_id=0, the primary, is falsy: `or` with PROCESS_ID would make
    it the environment's rank (JAX's distributed.py:54-57)."""
    import torch.distributed as dist

    from larvanet_tpu_torch.parallel import distributed

    calls = []
    monkeypatch.setattr(dist, "init_process_group", lambda *a, **k: calls.append((a, k)))
    monkeypatch.setenv("PROCESS_ID", "1")
    monkeypatch.setenv("NUM_PROCESSES", "3")
    assert distributed.init_distributed("127.0.0.1:1234", process_id=0, backend="gloo")
    (args, kwargs), = calls
    assert args == ("gloo",) and kwargs == {"init_method": "tcp://127.0.0.1:1234",
                                            "world_size": 3, "rank": 0}
    monkeypatch.setenv("COORDINATOR", "127.0.0.1:99")
    assert distributed.init_distributed(backend="gloo")
    assert calls[1][1] == {"init_method": "tcp://127.0.0.1:99", "world_size": 3, "rank": 1}
    monkeypatch.delenv("PROCESS_ID")
    with pytest.raises(ValueError, match="NUM_PROCESSES, PROCESS_ID"):
        distributed.init_distributed()
