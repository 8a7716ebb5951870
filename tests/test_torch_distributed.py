"""The port's multi-process layer (parallel/distributed.py) on the CPU.

The single-process cases mirror tests/test_distributed.py: the global mesh
over this process's slots, distribute_local_streams' rows, and
init_distributed with nothing configured. A one-process Gloo group is
brought up three ways (arguments, the CBV_* variables, torchrun's). Then a
real two-process Gloo fleet: the JAX fleet workload of
tests/fleet_fixture.py (8 streams, 2 processes x 4 slots, the pawn of file
gi % 8 leaving its square) is rendered into an npz, its expected occupancy
comes from the JAX package's single-process meshed run (as
tests/test_distributed.py's reference), and two
``chessboard_vision_tpu_torch.tools.dryrun_multigpu --fleet-worker``
processes must each print FLEET-OK with their rows equal to it. Every wait
has a timeout of its own, and a worker past it is killed.
"""

import os
import socket
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from chessboard_vision_tpu.parallel.mesh import make_mesh as jax_make_mesh
from chessboard_vision_tpu_torch import geometry as tgeo
from chessboard_vision_tpu_torch.parallel import distributed as pdist
from chessboard_vision_tpu_torch.parallel.mesh import make_mesh
from chessboard_vision_tpu_torch.tools import dryrun_multigpu

import fleet_fixture as ff

# One intra-op thread: the suite runs in parallel worker processes, and
# each torch process would otherwise spread over every core.
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VARS = ("CBV_COORDINATOR", "CBV_NUM_PROCESSES", "CBV_PROCESS_ID", "MASTER_ADDR",
            "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE")
WORKER_TIMEOUT_S = 120


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture
def no_launcher_env(monkeypatch):
    for name in ENV_VARS:
        monkeypatch.delenv(name, raising=False)


def test_global_mesh_single_process(no_launcher_env):
    """Without a process group the global mesh is this process's slots."""
    mesh = pdist.global_stream_mesh(local_devices=["cpu"] * 8)
    assert mesh.size == 8 and mesh.axis_names == ("data",) and mesh.shape == {"data": 8}
    assert mesh.ranks.tolist() == [0] * 8 and mesh.process == 0
    two = pdist.global_stream_mesh(("data", "space"), ["cpu"] * 8, shape=(4, 2))
    assert two.shape == {"data": 4, "space": 2}


def test_distribute_local_streams_single_process(no_launcher_env, rng):
    mesh = make_mesh(8, devices=["cpu"] * 8)
    local = rng.normal(size=(8, 3, 4, 4)).astype(np.float32)
    got = pdist.distribute_local_streams(mesh, local)
    assert got.streams == range(8) and got.global_shape == (8, 3, 4, 4)
    np.testing.assert_array_equal(got.frames, local)
    with pytest.raises(ValueError, match="do not divide"):
        pdist.distribute_local_streams(mesh, local[:6])


def test_init_distributed_unconfigured_returns_false(no_launcher_env):
    t0 = time.perf_counter()
    assert pdist.init_distributed() is False
    assert not torch.distributed.is_initialized()
    assert time.perf_counter() - t0 < 5.0
    assert torch.equal(pdist.fleet_sum(torch.arange(6).reshape(3, 2)), torch.tensor([6, 9]))


@pytest.mark.parametrize("how", ["arguments", "cbv_env", "torchrun_env"])
def test_one_process_group(how, no_launcher_env, monkeypatch):
    """A one-process group from each source of its configuration: Gloo on
    the CPU (auto), idempotent, its global mesh owned by rank 0, and
    fleet_sum an all_reduce that leaves one process's sum as it is."""
    port = _free_port()
    if how == "cbv_env":
        monkeypatch.setenv("CBV_COORDINATOR", f"localhost:{port}")
        monkeypatch.setenv("CBV_NUM_PROCESSES", "1")
        monkeypatch.setenv("CBV_PROCESS_ID", "0")
    elif how == "torchrun_env":
        for name, value in (("MASTER_ADDR", "localhost"), ("MASTER_PORT", str(port)),
                            ("RANK", "0"), ("WORLD_SIZE", "1")):
            monkeypatch.setenv(name, value)
    args = (f"localhost:{port}", 1, 0) if how == "arguments" else ()
    assert pdist.init_distributed(*args)
    try:
        assert torch.distributed.get_backend() == "gloo"
        assert pdist.init_distributed()
        mesh = pdist.global_stream_mesh(local_devices=["cpu"] * 2)
        assert mesh.ranks.tolist() == [0, 0] and mesh.process == 0
        x = torch.arange(8, dtype=torch.int32).reshape(4, 2)
        assert torch.equal(pdist.fleet_sum(x), x.sum(dim=0))
    finally:
        torch.distributed.destroy_process_group()


def _reference_fleet_occupancy():
    """The JAX package's single-process meshed run of the fleet workload
    (tests/test_distributed.py's reference)."""
    ms = ff.make_fleet_pipeline(jax_make_mesh(8, ("data",)))
    state = ms.init_state()
    refs = np.stack([ff.stream_frames(gi)[0] for gi in range(ff.N_STREAMS)])
    steps = np.stack([ff.stream_frames(gi)[1] for gi in range(ff.N_STREAMS)])
    state = ms.capture_reference(state, refs)
    state, out = ms.step(state, steps)
    occ = np.asarray(out.step.occupancy)
    for gi in range(ff.N_STREAMS):
        assert not occ[gi, 8 + gi % 8], f"stream {gi}: pawn still seen"
    return refs, steps, occ


def test_two_process_gloo_fleet(tmp_path):
    """Two fleet workers of the port over Gloo on the CPU, 4 streams and 4
    slots each: each rank's occupancy equals its rows of the JAX package's
    single-process reference, and the fleet sum equals the reference's."""
    refs, steps, occ = _reference_fleet_occupancy()
    g = tgeo.BoardGeometry.from_calibration(ff.FLEET_CORNERS, display_size=ff.DISPLAY_SIZE,
                                            margin=ff.MARGIN)
    frames_path, expected_path = str(tmp_path / "fleet.npz"), str(tmp_path / "expected.npz")
    dryrun_multigpu.save_fleet(frames_path, refs, steps, g, ff.MARGIN, ff.STREAMS_PER_PROC)
    np.savez(expected_path, occ=occ)
    port = _free_port()
    env = {k: v for k, v in os.environ.items() if k not in ENV_VARS}
    env.update(OMP_NUM_THREADS="1", PYTHONPATH=os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "chessboard_vision_tpu_torch.tools.dryrun_multigpu",
         "--fleet-worker", str(rank), str(ff.PROCESSES), str(port), frames_path,
         expected_path, "--device", "cpu", "--backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for rank in range(ff.PROCESSES)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=WORKER_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for rank, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {rank} failed:\n{out}"
        assert f"FLEET-OK rank={rank} streams={4 * rank}:{4 * rank + 4} of 8" in out, out
