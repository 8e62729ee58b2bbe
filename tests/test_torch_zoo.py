"""The port's model zoo against the JAX package's, through the weight
bridges (``sradsgan_tpu_torch/tools/from_jax.py``).

Seven generators (EDSR, SRGAN, DRCAN, DSSR, SRAGAN, NDSRGAN, AMSSRN) at tiny
widths and depths, at x2 and x4 (AMSSRN also x3), each held to the bar the
JAX package met against the reference (``docs/VALIDATION.md``): 2e-5 of
max|ref| for EDSR, DRCAN and DSSR, 3e-5 for the others.  Weights are drawn
with numpy at fan-in scale, so that activations are of order one, with every
zero-init gain and output conv (SRAGAN's CGAM and SGAM gains, AMSSRN's
``gamma`` and non-local ``W``) non-zero and random BatchNorm statistics.
The JAX side runs its CPU formulations, the port its kernels' plain PyTorch
versions.  SRGAN and SRAGAN also run in train mode, where the BatchNorm that
their two x2 stages share updates its running statistics twice a forward;
SRAGAN also with its 72 tails fused.  The bridges round-trip through the
reference readers of ``sradsgan_tpu/tools/import_reference.py``, which read
every key of the full-width state dicts; the discriminator variants (plain,
and NDSRGAN's 4x4) match JAX in both modes.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.models import amssrn as jax_amssrn  # noqa: E402
from sradsgan_tpu.models import drcan as jax_drcan  # noqa: E402
from sradsgan_tpu.models import dssr as jax_dssr  # noqa: E402
from sradsgan_tpu.models import edsr as jax_edsr  # noqa: E402
from sradsgan_tpu.models import ndsrgan as jax_ndsrgan  # noqa: E402
from sradsgan_tpu.models import sragan as jax_sragan  # noqa: E402
from sradsgan_tpu.models import srgan as jax_srgan  # noqa: E402
from sradsgan_tpu.models.discriminators import (  # noqa: E402
    PatchDiscriminator as JaxD)
from sradsgan_tpu.tools import import_reference as ir  # noqa: E402
from sradsgan_tpu_torch import models  # noqa: E402
from sradsgan_tpu_torch.models.discriminators import (  # noqa: E402
    PatchDiscriminator)
from sradsgan_tpu_torch.models.ndsrgan import NDSRGAN_D_BLOCKS  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    discriminator_state_dict, generator_state_dict, load_npz, save_npz)

# name: (JAX generator, reference reader, tiny widths and depths, the
# reader's depth arguments for them, bar of max|ref|)
ZOO = {
    "edsr": (jax_edsr.EDSR, ir.import_edsr,
             dict(base_filters=16, num_residuals=2),
             dict(num_residuals=2), 2e-5),
    "srgan": (jax_srgan.SRGANGenerator, ir.import_srgan,
              dict(base_filters=16, num_residuals=2),
              dict(num_residuals=2), 3e-5),
    "drcan": (jax_drcan.DRCAN, ir.import_drcan,
              dict(n_feats=16, n_resgroups=2, n_resblocks=2),
              dict(n_resgroups=2, n_resblocks=2), 2e-5),
    "dssr": (jax_dssr.DSSR, ir.import_dssr,
             dict(n_feats=16, n_groups=2, n_blocks=2),
             dict(n_groups=2, n_blocks=2), 2e-5),
    "sragan": (jax_sragan.SRAGANGenerator, ir.import_sragan,
               dict(base_filters=16, n_groups=2, n_blocks=2),
               dict(n_groups=2, n_blocks=2), 3e-5),
    "ndsrgan": (jax_ndsrgan.NDSRGANGenerator, ir.import_ndsrgan,
                dict(nf=16, nc=8, n_dcrdb=2), dict(n_dcrdb=2), 3e-5),
    "amssrn": (jax_amssrn.AMSSRN, ir.import_amssrn,
               dict(n_feats=16, n_blocks=4), dict(n_blocks=4), 3e-5),
}
BATCHNORM = ("srgan", "sragan")
LR = 12


def random_variables(variables, seed=0):
    """Same tree, numpy leaves: kernels normal(0, 0.5 / sqrt(fan_in)),
    biases normal(0, 0.05), BatchNorm scales uniform(0.5, 1.5), running
    means normal(0, 0.1) and variances uniform(0.5, 1.5), PReLU slopes
    uniform(0.1, 0.4) (one draw for the three slopes of an AMSSRN ASPP,
    which the reference shares), gains 0.6."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "gamma":
            return np.full(leaf.shape, 0.6, np.float32)
        if name in ("bias", "mean"):
            std = 0.1 if name == "mean" else 0.05
            return rng.normal(0, std, leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name == "alpha":
            return rng.uniform(0.1, 0.4, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, 0.5 / np.sqrt(fan_in),
                          leaf.shape).astype(np.float32)

    out = jax.tree_util.tree_map_with_path(draw, variables)
    for key, node in out.get("params", out).items():
        if key.startswith("DBASPP_"):
            for d in (1, 2):
                node[f"PReLU_{d}"] = dict(node["PReLU_0"])
    return out


def jax_variables(name, scale, seed=0):
    cls, _, kwargs, _, _ = ZOO[name]
    gen = cls(scale=scale, **kwargs)
    variables = gen.init(jax.random.PRNGKey(0), jnp.zeros((1, LR, LR, 3)))
    variables = jax.tree.map(np.asarray, dict(variables))
    if name not in BATCHNORM:
        variables = {"params": variables["params"]}
    return gen, random_variables(variables, seed + scale)


def port_generator(name, scale, variables, **kw):
    model = models.create_generator(name, scale, **ZOO[name][2], **kw)
    model.load_state_dict(generator_state_dict(name, variables))
    return model


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _input(seed=1):
    return np.random.default_rng(seed).random((2, LR, LR, 3)).astype(
        np.float32)


def _assert_close(got, want, bar):
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= bar * float(np.abs(want).max()), (err, bar)


CASES = [(n, s) for n in ZOO for s in (2, 4)] + [("amssrn", 3)]


@pytest.mark.parametrize("name,scale", CASES)
def test_generator_matches_jax(name, scale):
    gen, variables = jax_variables(name, scale)
    x = _input()
    want = np.asarray(jax.jit(gen.apply, static_argnames="train")(
        variables, jnp.asarray(x), train=False))
    model = port_generator(name, scale, variables).eval()
    with torch.no_grad():
        got = _nhwc(model(_nchw(x)))
    assert want.shape == (2, LR * scale, LR * scale, 3)
    _assert_close(got, want, ZOO[name][4])
    assert np.abs(want).max() > 0.05  # no vanishing outputs


def _running_stats(state):
    return {k: v.numpy() for k, v in state.items()
            if k.endswith(("running_mean", "running_var"))}


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("name", BATCHNORM)
def test_batchnorm_generator_in_train_mode_matches_jax(name, scale):
    """A train-mode forward normalizes by the batch statistics and updates
    the running ones: at x4 the shared upsample BatchNorm twice, so its
    statistics differ from one update's."""
    gen, variables = jax_variables(name, scale)
    x = _input()
    want, updated = gen.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    model = port_generator(name, scale, variables).train()
    got = _nhwc(model(_nchw(x)))
    _assert_close(got, np.asarray(want), ZOO[name][4])
    want_stats = _running_stats(generator_state_dict(
        name, {"params": variables["params"],
               "batch_stats": jax.tree.map(np.asarray,
                                           updated["batch_stats"])}))
    got_stats = _running_stats(model.state_dict())
    assert set(got_stats) == set(want_stats)
    for key, value in got_stats.items():
        np.testing.assert_allclose(value, want_stats[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    # the shared BatchNorm: one update per stage from the initial stats
    before = _running_stats(generator_state_dict(name, variables))
    key = "upsampling.1.running_mean"
    assert not np.allclose(got_stats[key], before[key])
    if scale == 4:  # x2's one stage sees what x4's first stage sees
        once = port_generator(name, 2, variables).train()
        once(_nchw(x))
        np.testing.assert_allclose(
            _running_stats(once.state_dict())["conv2.1.running_mean"],
            got_stats["conv2.1.running_mean"], rtol=1e-6, atol=1e-7)
        assert not np.allclose(
            _running_stats(once.state_dict())[key], got_stats[key],
            rtol=1e-3, atol=1e-4)  # the second update moved them


def test_sragan_fused_tails_match_unfused():
    """``rab_tail="fused"`` (the fused op's plain path here) over the same
    state dict, in eval and train mode."""
    _, variables = jax_variables("sragan", 4)
    x = _nchw(_input())
    for train in (False, True):
        unfused = port_generator("sragan", 4, variables).train(train)
        fused = port_generator("sragan", 4, variables,
                               rab_tail="fused").train(train)
        with torch.no_grad():
            want, got = unfused(x).numpy(), fused(x).numpy()
        _assert_close(got, want, 1e-5)
        for key, value in _running_stats(fused.state_dict()).items():
            np.testing.assert_allclose(
                value, _running_stats(unfused.state_dict())[key],
                rtol=1e-5, atol=1e-6, err_msg=key)


def _reader(name, state, variables, scale):
    _, read, _, depth, _ = ZOO[name]
    tree = variables if name in BATCHNORM else variables["params"]
    out = read(state, tree, scale=scale, **depth)
    return out if name in BATCHNORM else {"params": out}


@pytest.mark.parametrize("name", ZOO)
def test_bridge_round_trip_is_exact(name, tmp_path):
    """The reference's reader (``import_reference.import_<model>``)
    inverts the bridge, and the .npz transport loses nothing."""
    _, variables = jax_variables(name, 4)
    save_npz(str(tmp_path / "g.npz"), variables)
    model = port_generator(name, 4, load_npz(str(tmp_path / "g.npz")))
    back = _reader(name, model.state_dict(), variables, 4)
    leaves, tree = jax.tree.flatten(variables)
    back_leaves, back_tree = jax.tree.flatten(back)
    assert tree == back_tree
    for a, b in zip(leaves, back_leaves):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ZOO)
def test_full_width_state_dict_is_what_import_reference_reads(name):
    """At the published widths and depths (the JAX defaults), every port
    key but BatchNorm's step counter is read by the reference reader with
    the JAX shape, and every JAX leaf is written."""
    cls = ZOO[name][0]
    shapes = jax.eval_shape(
        cls(scale=4).init, jax.random.PRNGKey(0),
        jax.ShapeDtypeStruct((1, LR, LR, 3), jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(shapes))
    if name not in BATCHNORM:
        zeros = {"params": zeros["params"]}
    state = {k: torch.ones_like(v) for k, v in
             models.create_generator(name, 4).state_dict().items()
             if not k.endswith("num_batches_tracked")}
    _, read, _, _, _ = ZOO[name]
    tree = zeros if name in BATCHNORM else zeros["params"]
    filled = read(state, tree)  # asserts each shape
    leaves = jax.tree.leaves(filled)
    # AMSSRN: the reference's one ASPP PReLU fills JAX's three slopes
    shared = 2 * 4 if name == "amssrn" else 0
    assert len(leaves) == len(state) + shared
    assert all((leaf == 1).all() for leaf in leaves)
    bridged = generator_state_dict(name, zeros)
    assert {k for k in bridged if not k.endswith("num_batches_tracked")} \
        == set(state)


SMALL_BLOCKS = ((8, 1, False), (8, 2, True), (16, 1, True), (16, 2, True),
                (32, 1, True), (32, 2, True), (32, 1, True), (32, 2, True))
D_VARIANTS = {
    # name: (JAX D kwargs, port D kwargs, bridge kwargs, input size)
    "plain": (dict(blocks=SMALL_BLOCKS, use_attention=False),
              dict(blocks=SMALL_BLOCKS, use_attention=False),
              dict(blocks=SMALL_BLOCKS, use_attention=False), 32),
    "ndsrgan": (dict(blocks=jax_ndsrgan.NDSRGAN_D_BLOCKS, kernel_size=4),
                dict(blocks=NDSRGAN_D_BLOCKS, kernel_size=4,
                     use_attention=False),
                dict(blocks=NDSRGAN_D_BLOCKS, use_attention=False), 32),
}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("variant", D_VARIANTS)
def test_discriminator_variant_matches_jax(variant, train):
    """SRGAN's and DRCAN's plain D and NDSRGAN's 4x4 D, with torch's
    symmetric (k - 1) // 2 padding, in eval and train mode (the running
    statistics too)."""
    jax_kw, port_kw, bridge_kw, size = D_VARIANTS[variant]
    d = JaxD(**jax_kw)
    variables = jax.tree.map(np.asarray, dict(d.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)))))
    variables = random_variables(variables, seed=5)
    port = PatchDiscriminator(**port_kw)
    port.load_state_dict(discriminator_state_dict(variables, **bridge_kw))
    port.train(train)
    x = np.random.default_rng(2).random((3, size, size, 3)).astype(
        np.float32)
    if train:
        want, upd = d.apply(variables, jnp.asarray(x), train=True,
                            mutable=["batch_stats"])
        stats = {"params": variables["params"],
                 "batch_stats": jax.tree.map(np.asarray,
                                             upd["batch_stats"])}
    else:
        want, stats = d.apply(variables, jnp.asarray(x)), variables
    got = _nhwc(port(_nchw(x)))
    _assert_close(got, np.asarray(want), 3e-5)
    want_stats = _running_stats(discriminator_state_dict(stats, **bridge_kw))
    for key, value in _running_stats(port.state_dict()).items():
        np.testing.assert_allclose(value, want_stats[key], rtol=1e-5,
                                   atol=1e-6, err_msg=key)
    assert not any(isinstance(m, torch.nn.Conv2d) and m.in_channels == 2
                   for m in port.modules())  # no CBAM
