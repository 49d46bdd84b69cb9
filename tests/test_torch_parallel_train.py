"""pathtracing_tpu_torch's sharded inverse-rendering step on two gloo
ranks against the JAX package's train_step_sharded on two virtual CPU
devices (tests/test_parallel.py's tolerances)."""
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracing_tpu import scenes as jscenes
from pathtracing_tpu.core.filters import mitchell as j_mitchell
from pathtracing_tpu.integrators.path import RenderConfig as JConfig
from pathtracing_tpu.parallel import mesh as jmesh
from test_torch_parallel import two_ranks


def test_torch_two_rank_train_step_matches_jax(tmp_path):
    """dp = 2: one Mitchell-filtered SGD step on the furnace (the partial
    films merged inside the loss, so the filter's spill across the shard
    border counts): the loss and the new parameters of the JAX package's
    step, the same on both ranks."""
    def jax_side():
        params, loss = jmesh.train_step_sharded(
            *jscenes.furnace(resolution=(8, 8)),
            JConfig(spp=2, max_depth=2, rays_per_batch=64,
                    filter=j_mitchell()),
            jnp.full((8, 8, 3), 0.25, jnp.float32), mesh=jmesh.make_mesh(2),
            lr=1.0)
        return params, float(loss)

    ranks, (params, loss) = two_ranks(tmp_path, 1, "train", jax_side)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k], err_msg=k)
    assert float(ranks[0]["loss"]) == pytest.approx(loss, rel=1e-4)
    for k, v in params.items():
        np.testing.assert_allclose(ranks[0]["p_" + k], np.asarray(v),
                                   rtol=1e-3, atol=1e-6, err_msg=k)
    assert not np.array_equal(ranks[0]["p_light_color"],
                              np.asarray(jscenes.furnace(
                                  resolution=(8, 8))[0]["light_color"]))
