"""Reference checkpoints and torchvision trunks read by the port without
JAX (``sradsgan_tpu_torch/tools/from_reference.py`` and
``tools/convert_torch.py``), against the JAX package's readers.

- For the nine generators at tiny widths and the patch D, a seeded state
  dict under the reference's names, with the keys the reference carries
  beside them (BatchNorm's ``num_batches_tracked``, HAT's index buffers),
  is saved as a ``.pkl``; the port's ``from_reference`` and the JAX
  ``import_reference.import_<model>`` followed by the bridge
  ``from_jax`` must give the same state dict, bit for bit.
- A missing key, a HAT index buffer that is not the port's table and a
  checkpoint that is no state dict are refused.
- ``convert_torch`` of both packages writes the same ``.npz`` for the five
  kinds, member for member and byte for byte; the torchvision trunks load
  straight into the port's VGG19 and LPIPS trunks.
"""

import warnings
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.models import hat as jax_hat  # noqa: E402
from sradsgan_tpu.models.discriminators import (  # noqa: E402
    PatchDiscriminator as JaxD)
from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxSRADSGAN)
from sradsgan_tpu.tools import convert_torch as jax_convert  # noqa: E402
from sradsgan_tpu.tools import import_reference as ir  # noqa: E402
from sradsgan_tpu_torch import models  # noqa: E402
from sradsgan_tpu_torch.losses import lpips as port_lpips  # noqa: E402
from sradsgan_tpu_torch.losses.vgg import load_vgg19  # noqa: E402
from sradsgan_tpu_torch.models.discriminators import (  # noqa: E402
    PatchDiscriminator)
from sradsgan_tpu_torch.models.hat import rpi_oca, rpi_sa  # noqa: E402
from sradsgan_tpu_torch.tools import convert_torch  # noqa: E402
from sradsgan_tpu_torch.tools import from_reference  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    discriminator_state_dict, generator_state_dict)
from test_convert_torch import (  # noqa: E402
    _torch_alexnet_features, _torch_squeezenet_features,
    _torch_vgg16_features, _torch_vgg19_features12)
from test_torch_zoo import BATCHNORM, ZOO  # noqa: E402

SCALE = 2
LR = 12
HAT_TINY = dict(embed_dim=12, depths=(2,), num_heads=(2,), window_size=4)
D_BLOCKS = ((8, 1, False), (8, 2, True), (16, 1, True), (16, 2, True),
            (16, 1, True), (16, 2, True))
# name: (JAX network, its reader, port kwargs, reader kwargs)
NETWORKS = {
    **{name: (cls, read, kwargs, depth)
       for name, (cls, read, kwargs, depth, _) in ZOO.items()},
    "sradsgan": (JaxSRADSGAN, ir.import_sradsgan,
                 dict(base_filters=16, n_groups=2, n_blocks=2),
                 dict(n_groups=2, n_blocks=2)),
    "hat": (jax_hat.HAT, ir.import_hat, HAT_TINY, dict(depths=(2,))),
    "discriminator": (JaxD, ir.import_patch_discriminator,
                      dict(blocks=D_BLOCKS, use_attention=True),
                      dict(attention=True)),
}
WITH_STATS = set(BATCHNORM) | {"discriminator"}


def _port_network(name, seed=0):
    kwargs = NETWORKS[name][2]
    if name == "discriminator":
        return PatchDiscriminator(**kwargs, seed=seed)
    return models.create_generator(name, SCALE, seed=seed, **kwargs)


def _jax_template(name):
    """Zeros in the shapes of the JAX network's variables (no init is
    compiled)."""
    cls, _, kwargs, _ = NETWORKS[name]
    net = cls(**kwargs) if name == "discriminator" else cls(scale=SCALE,
                                                            **kwargs)
    size = 32 if name == "discriminator" else LR
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, size, size, 3),
                                                 jnp.float32))
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32),
                         dict(shapes))
    return zeros if name in WITH_STATS else zeros["params"]


def reference_state(name, seed=0):
    """The port's state dict with every float tensor drawn, as the
    reference saves it: ``num_batches_tracked`` counted up, HAT's two index
    buffers beside the weights."""
    rng = np.random.default_rng(seed)
    state = {}
    for key, value in _port_network(name).state_dict().items():
        if value.is_floating_point():
            value = torch.from_numpy(rng.normal(
                0, 0.5, tuple(value.shape)).astype(np.float32))
        else:
            value = torch.full_like(value, 7)
        state[key] = value
    if name == "hat":
        win = HAT_TINY["window_size"]
        state["relative_position_index_SA"] = torch.from_numpy(rpi_sa(win))
        state["relative_position_index_OCA"] = torch.from_numpy(
            rpi_oca(win, 0.5))
    return state


def _jax_route(name, state):
    """The JAX reader and the bridge back to the port."""
    _, read, kwargs, depth = NETWORKS[name]
    np_state = {k: v.numpy() for k, v in state.items()}
    if name == "discriminator":
        variables = read(np_state, _jax_template(name), **depth)
        return discriminator_state_dict(variables, kwargs["blocks"],
                                        kwargs["use_attention"])
    out = read(np_state, _jax_template(name), scale=SCALE, **depth)
    return generator_state_dict(name, out if name in WITH_STATS
                                else {"params": out})


@pytest.mark.parametrize("name", NETWORKS)
def test_from_reference_is_the_jax_readers_bit_for_bit(name, tmp_path):
    state = reference_state(name, seed=len(name))
    path = str(tmp_path / "generator_param.pkl")
    torch.save(state, path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got = from_reference.reference_state_dict(
            name, from_reference.load_reference_state(path), SCALE,
            **NETWORKS[name][2])
    # what the reference carries beside the weights, and nothing else
    extra = [k for k in state if k.endswith("num_batches_tracked")
             or k.startswith("relative_position_index")]
    assert [str(w.message) for w in caught] == ([
        f"reference_state_dict({name!r}): dropped {len(extra)} key(s) the "
        f"port does not hold: {extra}"] if extra else [])
    want = _jax_route(name, state)
    assert list(got) == list(_port_network(name).state_dict())
    assert set(got) == set(want)
    for key, value in want.items():
        assert got[key].dtype == value.dtype, key
        assert torch.equal(got[key], value), key
    model = _port_network(name, seed=3)
    model.load_state_dict(got)  # strict


def test_load_reference_builds_the_module(tmp_path):
    state = reference_state("edsr")
    torch.save(state, tmp_path / "g.pkl")
    model = from_reference.load_reference(
        "edsr", str(tmp_path / "g.pkl"), SCALE, **NETWORKS["edsr"][2])
    assert not model.training
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key


def test_a_missing_key_raises():
    state = reference_state("sradsgan")
    del state["res_groups.1.RG.0.sa.conv1.weight"]
    with pytest.raises(KeyError, match=r"res_groups\.1\.RG\.0\.sa\.conv1"):
        from_reference.reference_state_dict("sradsgan", state, SCALE,
                                            **NETWORKS["sradsgan"][2])


def test_a_shape_that_differs_raises():
    state = reference_state("edsr")
    state["input_conv.conv.weight"] = state["input_conv.conv.weight"][:, :2]
    with pytest.raises(ValueError, match="input_conv.conv.weight"):
        from_reference.reference_state_dict("edsr", state, SCALE,
                                            **NETWORKS["edsr"][2])


@pytest.mark.parametrize("key", ["relative_position_index_SA",
                                 "relative_position_index_OCA",
                                 "layers.0.residual_group.blocks.1.attn_mask"])
def test_a_hat_buffer_that_is_not_the_ports_table_raises(key):
    """Each kind of index buffer is checked: a right one passes (an
    ``attn_mask`` of a 3 x 3-window image), one changed entry raises."""
    from sradsgan_tpu_torch.models.hat import sw_attn_mask

    win = HAT_TINY["window_size"]
    state = reference_state("hat")
    if key.endswith("attn_mask"):
        state[key] = torch.from_numpy(sw_attn_mask(3 * win, 3 * win, win,
                                                   win // 2))
    with pytest.warns(UserWarning, match=key):
        from_reference.reference_state_dict("hat", state, SCALE, **HAT_TINY)
    bad = state[key].clone()
    bad.view(-1)[5] += 1
    state[key] = bad
    with pytest.raises(ValueError, match=f"HAT buffer {key}"):
        from_reference.reference_state_dict("hat", state, SCALE, **HAT_TINY)


def test_a_checkpoint_that_is_no_state_dict_is_refused(tmp_path):
    torch.save(_port_network("edsr"), tmp_path / "module.pkl")
    with pytest.raises(ValueError, match="reference's code"):
        from_reference.load_reference_state(str(tmp_path / "module.pkl"))
    torch.save({"epoch": 3, "weights": [1.0]}, tmp_path / "other.pkl")
    with pytest.raises(ValueError, match="not a state dict of tensors"):
        from_reference.load_reference_state(str(tmp_path / "other.pkl"))


TORCHVISION = {"vgg19": _torch_vgg19_features12,
               "alexnet": _torch_alexnet_features,
               "vgg16": _torch_vgg16_features,
               "squeezenet": _torch_squeezenet_features}


def _members(path):
    with zipfile.ZipFile(path) as z:
        return [(info.filename, z.read(info)) for info in z.infolist()]


@pytest.mark.parametrize("kind", list(TORCHVISION) + ["generator"])
def test_convert_torch_writes_the_jax_files(kind, tmp_path):
    torch.manual_seed(len(kind))
    if kind == "generator":
        state = reference_state("srgan")
    else:
        state = TORCHVISION[kind]().state_dict()
    src = str(tmp_path / "in.pth")
    torch.save(state, src)
    assert jax_convert.main([kind, src, str(tmp_path / "jax.npz")]) == 0
    assert convert_torch.main([kind, src, str(tmp_path / "port.npz")]) == 0
    port, want = (_members(tmp_path / f"{side}.npz")
                  for side in ("port", "jax"))
    assert [n for n, _ in port] == [n for n, _ in want]
    for (name, got), (_, ref) in zip(port, want):
        assert got == ref, name


def test_vgg19_pth_loads_into_the_content_features(tmp_path):
    """``load_vgg19`` of torchvision's file: the features of the
    torchvision module, bit for bit, and the weights of the port's
    converted ``.npz``."""
    torch.manual_seed(0)
    tv = _torch_vgg19_features12()
    torch.save(tv.state_dict(), tmp_path / "vgg19.pth")
    model = load_vgg19(str(tmp_path / "vgg19.pth"))
    x = torch.rand(2, 3, 24, 24)
    with torch.no_grad():
        assert torch.equal(model(x), tv.features(x))
    convert_torch.main(["vgg19", str(tmp_path / "vgg19.pth"),
                        str(tmp_path / "vgg19.npz")])
    via_npz = load_vgg19(str(tmp_path / "vgg19.npz"))
    for key, value in via_npz.state_dict().items():
        assert torch.equal(model.state_dict()[key], value), key


@pytest.mark.parametrize("net,kind", [("alex", "alexnet"), ("vgg", "vgg16"),
                                      ("squeeze", "squeezenet")])
def test_lpips_reads_a_torchvision_trunk(net, kind, tmp_path, monkeypatch):
    """``SRADSGAN_TPU_*_NPZ`` naming torchvision's ``.pth`` gives the
    calibrated LPIPS that the converted ``.npz`` gives, bit for bit."""
    torch.manual_seed(1)
    torch.save(TORCHVISION[kind]().state_dict(), tmp_path / "t.pth")
    convert_torch.main([kind, str(tmp_path / "t.pth"),
                        str(tmp_path / "t.npz")])
    env = port_lpips.NETS[net][1]
    states = []
    for suffix in ("pth", "npz"):
        monkeypatch.setenv(env, str(tmp_path / f"t.{suffix}"))
        model, calibrated = port_lpips.load_lpips(net)
        assert calibrated
        states.append(model.state_dict())
    assert list(states[0]) == list(states[1])
    for key, value in states[1].items():
        assert torch.equal(states[0][key], value), key
