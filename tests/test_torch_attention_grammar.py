"""The port's attention grammar against the JAX package's: ``LocalAttention``
and ``GlobalAttention`` in every mode, pool mode and ``add_conv``; the
paper's ablation configurations of SRADSGAN and SRAGAN's ``ga_mode``, their
gradients, the fused RAB tail on exactly the tails JAX fuses, the weight
bridges and ``cli train`` with an ablation's ``--model-kwargs``.

Weights are drawn with numpy at fan-in scale, the gains non-zero, and carried
by the bridge (``tools/from_jax.py``).  JAX runs its CPU formulations, the
port its kernels' plain versions, at the bar of
``tests/test_torch_sradsgan.py``.
"""

import functools
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import chip_smoke  # noqa: E402
from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxSRADSGAN)
from sradsgan_tpu.models.sragan import (  # noqa: E402
    SRAGANGenerator as JaxSRAGAN)
from sradsgan_tpu.nn import attention as jax_attention  # noqa: E402
from sradsgan_tpu_torch import cli  # noqa: E402
from sradsgan_tpu_torch.models import create_generator  # noqa: E402
from sradsgan_tpu_torch.nn.attention import (  # noqa: E402
    MODES, GlobalAttention, LocalAttention, SpatialGate)
from sradsgan_tpu_torch.tools import from_jax, from_reference  # noqa: E402

RTOL, ATOL = 1e-4, 3e-5  # tests/test_torch_sradsgan.py's bar
FUSED_ATOL = 1e-6        # fused against unfused: one math, another order
GRAD_ATOL = 3e-5         # of max|grad| of each tensor
SMALL = dict(base_filters=16, n_groups=2, n_blocks=2)
POOLS = ("Avg|Max", "Avg", "Max")
CONFIGS = chip_smoke.GRAMMAR_CASES  # the card phase's configurations


def _fan_in(tree, seed):
    """numpy leaves by shape: kernels normal(0, 0.8 / sqrt(fan_in)) (which
    keeps every configuration's output of order one), biases normal(0,
    0.05), gains 0.6, BatchNorm scales uniform(0.5, 1.5) and statistics
    drawn."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "gamma":
            return np.full(leaf.shape, 0.6, np.float32)
        if name in ("bias", "mean"):
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, 0.8 / np.sqrt(fan_in),
                          leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, tree)


def _variables(module, x, seed):
    """The module's variables by shape alone (nothing compiled)."""
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.asarray(x))
    return _fan_in(shapes, seed)


def _apply(module, variables, x):
    return np.asarray(jax.jit(module.apply)(variables, jnp.asarray(x)))


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def _x(shape, seed=1):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


@pytest.mark.parametrize("add_conv", [True, False])
@pytest.mark.parametrize("pool_mode", POOLS)
@pytest.mark.parametrize("mode", MODES)
def test_local_attention_matches_jax(mode, pool_mode, add_conv):
    m = jax_attention.LocalAttention(mode, pool_mode, add_conv)
    x = _x((2, 9, 11, 16)) * 2 - 1
    v = _variables(m, x, seed=len(mode) + len(pool_mode))
    port = LocalAttention(16, mode=mode, pool_mode=pool_mode,
                          add_conv=add_conv)
    port.load_state_dict(from_jax.local_attention_state_dict(v))  # strict
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, _apply(m, v, x), rtol=RTOL, atol=ATOL)
    # the strict load matched the JAX tree's leaves: 'CA' and 'SA' hold no
    # conv, whatever add_conv says
    assert hasattr(port, "conv") == (mode in ("", "CA|SA")
                                     or ("-" in mode and add_conv))


@pytest.mark.parametrize("add_conv", [True, False])
@pytest.mark.parametrize("mode", MODES[1:])
def test_global_attention_matches_jax(mode, add_conv):
    m = jax_attention.GlobalAttention(mode, add_conv)
    x = _x((2, 6, 7, 16), seed=2) * 2 - 1
    v = _variables(m, x, seed=len(mode))
    port = GlobalAttention(16, mode, add_conv)
    port.load_state_dict(from_jax.global_attention_state_dict(v))
    with torch.no_grad():
        got = _nhwc(port(_nchw(x)))
    np.testing.assert_allclose(got, _apply(m, v, x), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("make", [
    lambda: LocalAttention(16, mode="SA|CA"),
    lambda: LocalAttention(16, mode="CA-CA"),
    lambda: LocalAttention(16, pool_mode="Min"),
    lambda: GlobalAttention(16, ""),
    lambda: GlobalAttention(16, "PA"),
    lambda: create_generator("sradsgan", 4, bla_mode="XX", **SMALL),
    lambda: create_generator("sragan", 4, ga_mode="", n_groups=1,
                             n_blocks=2)])
def test_an_unknown_mode_raises(make):
    with pytest.raises(ValueError):
        make()


@pytest.mark.parametrize("make", [
    lambda: jax_attention.LocalAttention("SA|CA"),
    lambda: jax_attention.GlobalAttention("")])
def test_jax_raises_there_too(make):
    with pytest.raises(ValueError, match="unknown attention mode"):
        jax.eval_shape(make().init, jax.random.PRNGKey(0),
                       jnp.zeros((1, 4, 4, 16)))


def _jax_generator(name, kwargs, x, seed=0):
    cls = JaxSRAGAN if name == "sragan" else JaxSRADSGAN
    gen = cls(scale=4, **SMALL, **kwargs)
    return gen, _variables(gen, x, seed)


def _port_generator(name, kwargs, variables, **extra):
    model = create_generator(name, 4, **SMALL, **kwargs, **extra)
    model.load_state_dict(from_jax.generator_state_dict(name, variables))
    return model.eval()


@pytest.mark.parametrize("case", sorted(CONFIGS))
def test_ablation_configuration_matches_jax(case):
    """Each configuration of the card phase at small widths: the forward
    against JAX, then the same weights with ``rab_tail="fused"`` against
    the unfused port."""
    name, kwargs = CONFIGS[case]["model"], CONFIGS[case]["model_kwargs"]
    x = _x((2, 12, 12, 3), seed=3)
    gen, v = _jax_generator(name, kwargs, x)
    want = _apply(gen, v, x)
    model = _port_generator(name, kwargs, v)
    fused = _port_generator(name, kwargs, v, rab_tail="fused")
    with torch.no_grad():
        got = _nhwc(model(_nchw(x)))
        got_fused = _nhwc(fused(_nchw(x)))
    assert got.shape == want.shape == (2, 48, 48, 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    assert np.abs(want).max() > 0.1
    np.testing.assert_allclose(got_fused, got, rtol=0, atol=FUSED_ATOL)


@pytest.mark.parametrize("case", ["g_sa_ca", "g_noconv", "g_parallel"])
def test_fused_tails_are_the_ones_jax_fuses(case, monkeypatch):
    """Under JAX's ``SRADSGAN_TPU_RAB_TAIL=fused`` the JAX generator fuses
    the tails its ``use_fused_rab_tail`` admits; the port's
    ``rab_tail="fused"`` fuses the same ones (with ``bla_mode="SA-CA"``
    the group tails only) and runs the others unfused, giving JAX's
    output."""
    kwargs = CONFIGS[case]["model_kwargs"]
    x = _x((2, 12, 12, 3), seed=4)
    monkeypatch.setenv("SRADSGAN_TPU_RAB_TAIL", "fused")
    gen, v = _jax_generator("sradsgan", kwargs, x, seed=1)
    want = _apply(gen, v, x)
    model = _port_generator("sradsgan", kwargs, v, rab_tail="fused")
    with torch.no_grad():
        np.testing.assert_allclose(_nhwc(model(_nchw(x))), want, rtol=RTOL,
                                   atol=ATOL)
    fused = [n for n, m in model.named_modules()
             if isinstance(m, LocalAttention) and m.fused]
    want_fused = {"g_sa_ca": ["res_groups.0", "res_groups.1"],
                  "g_noconv": [], "g_parallel": []}[case]
    assert fused == want_fused


def test_sragan_ga_mode_matches_jax_in_train_mode():
    """SRAGAN with ``ga_mode="SA-CA"`` in train mode (its BatchNorms on the
    batch's statistics) against JAX, the groups staying 'CA-SA'."""
    x = _x((2, 12, 12, 3), seed=5)
    gen = JaxSRAGAN(scale=4, n_groups=2, n_blocks=2, base_filters=16,
                    ga_mode="SA-CA")
    v = _variables(gen, x, seed=2)
    want, _ = jax.jit(functools.partial(gen.apply, train=True,
                                        mutable=["batch_stats"]))(
        v, jnp.asarray(x))
    model = create_generator("sragan", 4, n_groups=2, n_blocks=2,
                             base_filters=16, ga_mode="SA-CA")
    model.load_state_dict(from_jax.sragan_state_dict(v))
    with torch.no_grad():
        got = _nhwc(model.train()(_nchw(x)))
    np.testing.assert_allclose(got, np.asarray(want), rtol=RTOL, atol=ATOL)
    assert model.mode == "SA-CA" and all(
        m.mode == "CA-SA" for m in model.modules()
        if isinstance(m, LocalAttention))


@pytest.mark.parametrize("case", ["g_parallel", "g_single"])
def test_generator_gradients_match_jax(case):
    """Parameter and input gradients of an ablation against ``jax.grad``,
    through the plain backwards of the pool, the gate, the single-stat
    stencil and the attention."""
    kwargs = CONFIGS[case]["model_kwargs"]
    rng = np.random.default_rng(6)
    x = rng.random((2, 12, 12, 3)).astype(np.float32)
    r = rng.normal(0, 1, (2, 48, 48, 3)).astype(np.float32)
    gen, v = _jax_generator("sradsgan", kwargs, x, seed=3)

    def loss(params, x):
        return jnp.mean(gen.apply({"params": params}, x) * r)

    dp, dx_want = jax.jit(jax.grad(loss, argnums=(0, 1)))(v["params"],
                                                          jnp.asarray(x))
    want = from_jax.sradsgan_state_dict(jax.tree.map(np.asarray, dp))
    model = _port_generator("sradsgan", kwargs, v)
    tx = _nchw(x).requires_grad_()
    names, tensors = zip(*model.named_parameters())
    grads = torch.autograd.grad((model(tx) * _nchw(r)).mean(),
                                (tx,) + tensors)
    np.testing.assert_allclose(_nhwc(grads[0]), np.asarray(dx_want),
                               rtol=1e-4,
                               atol=GRAD_ATOL * np.abs(dx_want).max())
    assert set(names) == set(want)
    top = max(float(w.abs().max()) for w in want.values())
    for name, g in zip(names, grads[1:]):
        w = want[name].numpy()
        if name.endswith("key_conv.bias"):
            # zero by the math (a per-query shift of the energies, which
            # the softmax removes): both sides hold rounding noise
            assert max(np.abs(w).max(), float(g.abs().max())) <= 1e-6 * top
            continue
        np.testing.assert_allclose(
            g.numpy(), w, rtol=1e-4,
            atol=GRAD_ATOL * max(np.abs(w).max(), 1e-4 * top), err_msg=name)
    assert np.abs(want["GAB_UP.sa.query_conv.weight"].numpy()).max() > 0


def test_single_stat_gate_holds_a_one_plane_kernel():
    """"Avg" and "Max" gates take a (1, 1, 7, 7) kernel and run the plain
    stencil; only "Avg|Max" keeps the kernels' (1, 2, 7, 7)."""
    assert SpatialGate("Avg").conv1.weight.shape == (1, 1, 7, 7)
    assert SpatialGate("Max").conv1.weight.shape == (1, 1, 7, 7)
    assert SpatialGate().conv1.weight.shape == (1, 2, 7, 7)


@pytest.mark.parametrize("case", ["g_parallel", "g_single", "g_conv_only"])
def test_variant_bridge_round_trips(case, tmp_path):
    """At full width the bridge writes every key of the port's variant with
    its shape; the .npz transport and the reference reader
    (``from_reference``, the variant by name) carry the weights bit for
    bit, and the reader refuses a checkpoint of another variant."""
    kwargs = CONFIGS[case]["model_kwargs"]
    shapes = jax.eval_shape(JaxSRADSGAN(scale=4, **kwargs).init,
                            jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 12, 12, 3),
                                                 jnp.float32))["params"]
    zeros = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    full = create_generator("sradsgan", 4, **kwargs).state_dict()
    bridged = from_jax.sradsgan_state_dict(zeros)
    assert {k: tuple(t.shape) for k, t in bridged.items()} == {
        k: tuple(t.shape) for k, t in full.items()}

    x = _x((1, 12, 12, 3))
    _, v = _jax_generator("sradsgan", kwargs, x, seed=7)
    from_jax.save_npz(str(tmp_path / "g.npz"), v["params"])
    state = from_jax.sradsgan_state_dict(
        from_jax.load_npz(str(tmp_path / "g.npz")))
    torch.save(state, tmp_path / "g.pkl")
    model = from_reference.load_reference("sradsgan",
                                          str(tmp_path / "g.pkl"), 4,
                                          **SMALL, **kwargs)
    for key, value in model.state_dict().items():
        assert torch.equal(value, state[key]), key
    other = {k: v for k, v in CONFIGS["g_sa_ca"]["model_kwargs"].items()}
    with pytest.raises((KeyError, ValueError)):
        from_reference.reference_state_dict("sradsgan", state, 4, **SMALL,
                                            **other)


def test_reference_reader_refuses_an_unexpected_key():
    state = create_generator("sradsgan", 4, **SMALL,
                             bla_mode="CA").state_dict()
    state["res_groups.0.RG.0.conv.weight"] = torch.zeros(16, 16, 1, 1)
    with pytest.raises(ValueError, match=r"res_groups\.0\.RG\.0\.conv"):
        from_reference.reference_state_dict("sradsgan", state, 4, **SMALL,
                                            bla_mode="CA")


def test_reference_reader_drops_a_key_outside_the_grammar():
    """A key of no attention composition (a submodule the port does not
    build) is dropped and named in the warning, as the JAX readers ignore
    what they do not read; the variant's own keys load."""
    state = create_generator("sradsgan", 4, **SMALL,
                             bla_mode="CA").state_dict()
    state["res_groups.0.RG.0.extra.weight"] = torch.zeros(3)
    state["unused_head.bias"] = torch.zeros(3)
    with pytest.warns(UserWarning, match="dropped 2 key") as caught:
        got = from_reference.reference_state_dict("sradsgan", state, 4,
                                                  **SMALL, bla_mode="CA")
    assert "unused_head.bias" in str(caught[0].message)
    assert "res_groups.0.RG.0.extra.weight" not in got
    assert torch.equal(got["res_groups.0.RG.0.ca.fc1.weight"],
                       state["res_groups.0.RG.0.ca.fc1.weight"])


def test_the_card_phase_counts_follow_the_module_structure():
    """chip_smoke's table of forward launches per configuration (full
    width) is what the module structure gives, unfused and fused."""
    for case, spec in CONFIGS.items():
        for rab_tail in ("unfused", "fused"):
            model = create_generator(spec["model"], 4, rab_tail=rab_tail,
                                     **spec["model_kwargs"])
            got = chip_smoke.forward_launches(model)
            assert got == chip_smoke.grammar_forward(case, rab_tail), (
                case, rab_tail)


def test_cli_train_takes_an_ablation(tmp_path, capsys):
    """The command line that JAX trains and the parent port refused."""
    kwargs = {"bla_mode": "SA-CA", "rla_mode": "CA|SA", "n_groups": 1,
              "n_blocks": 1, "base_filters": 16}
    argv = ["train", "--device", "cpu", "--data", "synthetic", "--model",
            "sradsgan", "--scale", "2", "--crop-size", "16", "--batch-size",
            "4", "--no-bf16", "--steps", "2", "--no-final-eval",
            "--save-dir", str(tmp_path), "--model-kwargs",
            json.dumps(kwargs)]
    assert cli.main(argv) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(list(out["final"].values())).all()
