"""pathtracing_tpu_torch's multi-GPU path (parallel/) on the CPU: two
processes joined by a gloo process group run render_sharded, held to the
JAX package's on two virtual CPU devices at tests/test_parallel.py's
tolerances (with test_torch_parallel_train.py's train step, the
counterpart of __graft_entry__.py::dryrun_multichip); and the one-rank
mesh against render()."""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.parallel import mesh as jmesh
from pathtracing_tpu.sensor.film import finalize as j_finalize
from pathtracing_tpu_torch import scenes as tscenes
from pathtracing_tpu_torch.integrators.path import RenderConfig as TConfig
from pathtracing_tpu_torch.integrators.render import render
from pathtracing_tpu_torch.parallel import mesh as tmesh
from pathtracing_tpu_torch.sensor.film import finalize

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]

_WORKER = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
port, rank, out, sp, what = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    int(sys.argv[4]), sys.argv[5]
from pathtracing_tpu_torch.parallel.distributed import (initialize,
                                                        is_coordinator)
info = initialize("127.0.0.1:" + port, 2, rank, backend="gloo")
try:
    assert info == dict(process_index=rank, process_count=2,
                        local_devices=1, global_devices=2), info
    assert is_coordinator() == (rank == 0)
    from pathtracing_tpu_torch import scenes
    from pathtracing_tpu_torch.core.filters import mitchell
    from pathtracing_tpu_torch.integrators.path import RenderConfig
    from pathtracing_tpu_torch.parallel.mesh import (make_mesh,
                                                     render_sharded,
                                                     train_step_sharded)
    from pathtracing_tpu_torch.sensor.film import finalize
    mesh = make_mesh(sp=sp)
    assert (mesh.dp, mesh.sp) == (2 // sp, sp)
    res = {}
    if what == "render":
        scene, cam, meta = scenes.cornell_box(resolution=(16, 16),
                                              device="cpu")
        film = render_sharded(scene, cam, meta, RenderConfig(
            spp=4, max_depth=3, rays_per_batch=64, regenerate=sp == 1),
            mesh=mesh, device="cpu")
        res["img"] = finalize(film).numpy()
    else:
        scene, cam, meta = scenes.furnace(resolution=(8, 8), device="cpu")
        params, loss = train_step_sharded(
            scene, cam, meta, RenderConfig(spp=2, max_depth=2,
                                           rays_per_batch=64,
                                           filter=mitchell()),
            np.full((8, 8, 3), 0.25, np.float32), mesh=mesh, lr=1.0,
            device="cpu")
        res["loss"] = loss.numpy()
        res.update({"p_" + k: v.numpy() for k, v in params.items()})
    np.savez(out, **res)
    print("WORKER_OK", rank)
finally:
    torch.distributed.destroy_process_group()
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return str(s.getsockname()[1])


def two_ranks(tmp_path, sp, what, jax_side):
    """Run _WORKER's `what` ("render" or "train") on two gloo ranks while
    `jax_side()` computes the reference in this process; returns (rank
    outputs, reference)."""
    port = _free_port()
    outs = [tmp_path / f"rank{r}.npz" for r in range(2)]
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep
           + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen(
        [sys.executable, "-c", _WORKER, port, str(r), str(outs[r]), str(sp),
         what],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(2)]
    try:
        ref = jax_side()
        logs = [p.communicate(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, (o, e) in zip(procs, logs):
        assert p.returncode == 0 and "WORKER_OK" in o, e[-3000:]
    return [dict(np.load(o)) for o in outs], ref


def test_torch_two_rank_pixel_sharding_matches_jax(tmp_path):
    """dp = 2 (pixels split over the ranks): the regenerating sharded
    render of the Cornell box against the JAX package's sharded render on
    two devices (its wave loop: the same samples); both ranks hold the
    same film."""
    def jax_side():
        film = jmesh.render_sharded(
            *jscenes.cornell_box(resolution=(16, 16)),
            JConfig(spp=4, max_depth=3, rays_per_batch=64),
            mesh=jmesh.make_mesh(2))
        return np.asarray(j_finalize(film))

    ranks, img = two_ranks(tmp_path, 1, "render", jax_side)
    np.testing.assert_array_equal(ranks[1]["img"], ranks[0]["img"])
    np.testing.assert_allclose(ranks[0]["img"].reshape(img.shape), img,
                               rtol=2e-4, atol=2e-5)


def test_torch_two_rank_sample_sharding_matches_jax(tmp_path):
    """sp = 2 (sample waves split over the ranks, every pixel on both):
    the wave-loop sharded render against the JAX package's dp x sp =
    1 x 2 mesh."""
    def jax_side():
        film = jmesh.render_sharded(
            *jscenes.cornell_box(resolution=(16, 16)),
            JConfig(spp=4, max_depth=3, rays_per_batch=64),
            mesh=jmesh.make_mesh(2, sp=2))
        return np.asarray(j_finalize(film))

    ranks, img = two_ranks(tmp_path, 2, "render", jax_side)
    np.testing.assert_array_equal(ranks[1]["img"], ranks[0]["img"])
    np.testing.assert_allclose(ranks[0]["img"].reshape(img.shape), img,
                               rtol=2e-4, atol=2e-5)


@pytest.mark.parametrize("regenerate", [False, True])
def test_torch_one_rank_mesh_matches_render(regenerate):
    """Without a process group the mesh is one rank: render_sharded's film
    (its own tiling and regen_schedule(divisor=True)) equals render()'s
    within tests/test_parallel.py's tolerance."""
    scene, cam, meta = tscenes.cornell_box(resolution=(10, 10), device="cpu")
    cfg = TConfig(spp=2, max_depth=3, rays_per_batch=30,
                  regenerate=regenerate)
    mesh = tmesh.make_mesh()
    assert (mesh.dp, mesh.sp, mesh.rank) == (1, 1, 0)
    with pytest.raises(ValueError):
        tmesh.make_mesh(2)
    want = finalize(render(scene, cam, meta, cfg, device="cpu"))
    got = finalize(tmesh.render_sharded(scene, cam, meta, cfg, mesh=mesh,
                                        device="cpu"))
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=2e-4,
                               atol=2e-5)
    img = tmesh.render_image_sharded(scene, cam, meta, cfg, device="cpu")
    assert img.shape == (10, 10, 3)
