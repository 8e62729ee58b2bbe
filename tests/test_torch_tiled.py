"""The port's halo-tiled inference against the JAX package's
(``sradsgan_tpu/evaluation/tiled.py``), and the mesh helpers it shares the
tiles with.

The JAX function runs on a mesh of one CPU device, the port in one process,
on a tiny SRADSGAN whose JAX weights the port carries through
``tools/from_jax.py``; the scenes are held at the serving test's bar
(``tests/test_torch_serving.py``: rtol 1e-4, atol 3e-5).  The padding and
the row order of ``parallel/mesh.py`` are held to JAX's padding and to
``shard_batch``'s strided rows.  Two ranks are in ``tests/test_torch_ddp.py``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh as JaxMesh  # noqa: E402

from sradsgan_tpu.evaluation.tiled import (  # noqa: E402
    tiled_super_resolve as jax_tiled)
from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxGenerator)
from sradsgan_tpu.parallel.mesh import (  # noqa: E402
    pad_batch_to_devices as jax_pad)
from sradsgan_tpu_torch.evaluation.tiled import tiled_super_resolve  # noqa
from sradsgan_tpu_torch.models import create_generator  # noqa: E402
from sradsgan_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from sradsgan_tpu_torch.parallel.mesh import (  # noqa: E402
    Mesh, gather_rows, pad_batch_to_devices, shard_batch)
from sradsgan_tpu_torch.serving import Predictor  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import sradsgan_state_dict  # noqa

SCALE = 2
SMALL = dict(base_filters=16, n_groups=1, n_blocks=2)
RTOL, ATOL = 1e-4, 3e-5  # tests/test_torch_serving.py's bar


@pytest.fixture(scope="module")
def generators():
    gen = JaxGenerator(scale=SCALE, **SMALL)
    params = jax.tree.map(np.asarray, gen.init(
        jax.random.PRNGKey(5), jnp.zeros((1, 12, 12, 3)))["params"])
    rng = np.random.default_rng(2)

    def draw(path, leaf):  # order-one activations, non-zero gains
        name = path[-1].key
        if name == "gamma":
            return np.full(leaf.shape, 0.6, np.float32)
        std = (0.05 if name == "bias" else
               0.5 / np.sqrt(np.prod(leaf.shape[:-1])))
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, params)
    model = create_generator("sradsgan", SCALE, **SMALL)
    model.load_state_dict(sradsgan_state_dict(params))
    return gen, {"params": params}, model.eval()


@pytest.mark.parametrize("shape,tile,halo,batch_tiles", [
    ((30, 25, 3), 8, 3, 5),     # 16 tiles in chunks of 5, a tail of 1
    ((17, 40, 3), 16, 4, 64),   # 6 tiles in one chunk
])
def test_tiled_matches_jax(generators, shape, tile, halo, batch_tiles):
    gen, variables, model = generators
    image = np.random.default_rng(3).random(shape).astype(np.float32)
    one_device = JaxMesh(np.asarray(jax.devices()[:1]), ("data",))
    want = jax_tiled(gen, variables, image, SCALE, tile, halo,
                     mesh=one_device, batch_tiles=batch_tiles)
    got = tiled_super_resolve(model, image, SCALE, tile, halo, batch_tiles,
                              device="cpu")
    assert got.shape == want.shape == (shape[0] * SCALE, shape[1] * SCALE,
                                       3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_predictor_tiles_on_a_world_of_one(generators):
    """``Predictor(mesh=...)`` with a mesh of one rank and no group gives
    the scene of the mesh-less predictor, bit for bit."""
    model = generators[2]
    image = np.random.default_rng(4).random((26, 21, 3)).astype(np.float32)
    kw = dict(buckets=(8,), tile=8, halo=2, device="cpu")
    one = Mesh(0, 1, torch.device("cpu"))
    np.testing.assert_array_equal(
        Predictor(model, SCALE, mesh=one, **kw)(image),
        Predictor(model, SCALE, **kw)(image))


class _FakeMesh:
    """JAX's padding reads ``mesh.devices.size`` alone."""

    def __init__(self, n):
        self.devices = np.empty(n)


@pytest.mark.parametrize("world,rows", [(1, 5), (2, 5), (3, 7), (4, 8),
                                        (4, 1)])
def test_padding_and_row_order_match_jax(world, rows, monkeypatch):
    """``pad_batch_to_devices`` repeats the last row as JAX's ``edge``
    padding does (numpy arrays, tensors and dicts); ``gather_rows`` of
    every rank's ``shard_batch`` rows gives the padded batch back (its
    ``all_gather`` replaced by one that hands it the ranks' blocks)."""
    batch = np.random.default_rng(world).random((rows, 3, 2)).astype(
        np.float32)
    want = jax_pad({"x": batch}, _FakeMesh(world))["x"]
    meshes = [Mesh(r, world, torch.device("cpu")) for r in range(world)]
    got = pad_batch_to_devices({"x": batch}, meshes[0])["x"]
    np.testing.assert_array_equal(got, want)
    tensor = pad_batch_to_devices(torch.from_numpy(batch), meshes[0])
    np.testing.assert_array_equal(tensor.numpy(), want)
    assert len(want) % world == 0
    blocks = [torch.from_numpy(shard_batch(got, m)) for m in meshes]
    assert gather_rows(blocks[0], meshes[0]) is blocks[0]  # no group

    def all_gather(parts, tensor, group):
        assert group == "group" and len(parts) == world
        for part, block in zip(parts, blocks):
            part.copy_(block)

    monkeypatch.setattr(port_mesh.dist, "all_gather", all_gather)
    monkeypatch.setattr(port_mesh.dist, "get_backend", lambda group: "gloo")
    for m in meshes:
        grouped = port_mesh.dataclasses.replace(m, group="group")
        out = gather_rows(blocks[m.rank], grouped)
        np.testing.assert_array_equal(out.numpy(), want)
