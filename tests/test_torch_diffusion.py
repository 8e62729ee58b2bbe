"""The port's GDP diffusion (``sradsgan_tpu_torch/diffusion/``) against the
JAX package's, on the CPU at tiny widths.

The same numpy-seeded inputs go through the JAX function and its port; the
port's UNet gets the JAX params through ``tools/from_jax.py:unet_state_dict``.
The JAX init zeroes each ResBlock's second conv, each attention projection
and the final conv (the fresh net outputs exactly zero), so every comparison
runs at perturbed weights: kernels normal(0, 1 / sqrt(fan_in)), biases
normal(0, 0.05), GroupNorm scales uniform(0.5, 1.5).  Bars, float32:
rtol 1e-4 and atol 3e-5 of max|ref| unless a test says otherwise.

- the 7 beta schedules and every ``Schedule`` constant equal to JAX's;
- ``timestep_embedding`` at even and odd widths;
- UNet forwards at inner 32: mults (1, 2) with ``attn_res=(2,)`` (attention
  on the down and up paths too), mults (1, 4) (c 128 at level 1: two
  heads), ``resblock_updown=False``, a 16x24 input; a bf16 forward;
- ``q_sample``; ``p_losses`` and its gradients at JAX's own ``t`` and
  noise; an 8-step chain and ``p_sample_chain``'s snapshots against a JAX
  composition of ``UNet.apply`` and the ``Schedule`` constants, fed the
  port's noise; three Adam steps against ``DiffusionTrainer._jit_train``;
- the trainer's checkpoint resume, the reflect pad at 13x11,
  ``validate``'s keys and dumps; the 12 configs; the bridge at full width;
  the init; ``plot_chain_grid``.
"""

import filecmp
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.core.config import DataConfig as JaxDataConfig  # noqa: E402
from sradsgan_tpu.diffusion import config as jax_config  # noqa: E402
from sradsgan_tpu.diffusion import gaussian as jax_gaussian  # noqa: E402
from sradsgan_tpu.diffusion import unet as jax_unet  # noqa: E402
from sradsgan_tpu.diffusion.trainer import (  # noqa: E402
    DiffusionTrainer as JaxDiffusionTrainer)
from sradsgan_tpu_torch.config import DataConfig  # noqa: E402
from sradsgan_tpu_torch.diffusion import config, gaussian, unet  # noqa: E402
from sradsgan_tpu_torch.diffusion.trainer import (  # noqa: E402
    DiffusionTrainer)
from sradsgan_tpu_torch.tools.from_jax import unet_state_dict  # noqa: E402
from sradsgan_tpu_torch.utils import plotting  # noqa: E402

RTOL, ATOL = 1e-4, 3e-5
SCHEDULES = ("linear", "quad", "warmup10", "warmup50", "const", "jsd",
             "cosine")
STRUCTURE = ("channel_mults", "attn_res", "res_blocks", "resblock_updown")
TINY = dict(inner_channel=32, channel_mults=(1, 2), res_blocks=1)
# name: (UNet arguments, input H, W)
UNETS = {
    "attn_down_and_up": (dict(TINY, attn_res=(2,)), (16, 16)),
    "two_heads": (dict(TINY, channel_mults=(1, 4)), (16, 16)),
    "conv_updown": (dict(TINY, attn_res=(2,), resblock_updown=False),
                    (16, 16)),
    "non_square": (TINY, (16, 24)),
}


def random_params(params, seed):
    """Same tree, numpy leaves: kernels normal(0, 1 / sqrt(fan_in)), biases
    normal(0, 0.05), GroupNorm scales uniform(0.5, 1.5)."""
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = path[-1].key
        if name == "bias":
            return rng.normal(0, 0.05, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        fan_in = int(np.prod(leaf.shape[:-1]))
        return rng.normal(0, 1 / np.sqrt(fan_in),
                          leaf.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, params)


def jax_net(kwargs, hw, seed=0):
    """The JAX UNet and perturbed params (shapes by ``eval_shape``)."""
    net = jax_unet.UNet(**kwargs)
    shapes = jax.eval_shape(net.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, *hw, 6)), jnp.zeros((1,), jnp.int32))
    return net, random_params(shapes["params"], seed)


def port_net(kwargs, params):
    model = unet.UNet(**kwargs)
    model.load_state_dict(unet_state_dict(
        params, **{k: kwargs[k] for k in STRUCTURE if k in kwargs}))
    return model


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def nhwc(t):
    return t.detach().float().numpy().transpose(0, 2, 3, 1)


def close(got, want, rtol=RTOL, atol=ATOL):
    want = np.asarray(want, np.float64)
    np.testing.assert_allclose(np.asarray(got, np.float64), want, rtol=rtol,
                               atol=atol * np.abs(want).max())


def _inputs(hw, batch=2, seed=1):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (batch, *hw, 6)).astype(np.float32)
    return x, np.array([3, 700][:batch], np.int32)


# ---------------------------------------------------------------------------
# schedules

@pytest.mark.parametrize("name", SCHEDULES)
def test_schedule_equals_jax(name):
    np.testing.assert_array_equal(
        gaussian.make_beta_schedule(name, 100, 1e-4, 2e-2),
        jax_gaussian.make_beta_schedule(name, 100, 1e-4, 2e-2))
    got = gaussian.Schedule.create(name, 100, 1e-4, 2e-2)
    want = jax_gaussian.Schedule.create(name, 100, 1e-4, 2e-2)
    for field in ("betas", "sqrt_alphas_cumprod",
                  "sqrt_one_minus_alphas_cumprod", "posterior_mean_coef1",
                  "posterior_mean_coef2", "posterior_log_variance_clipped"):
        a, b = getattr(got, field), getattr(want, field)
        assert a.dtype == b.dtype == np.float32, field
        np.testing.assert_array_equal(a, b, err_msg=field)
    assert got.num_timesteps == want.num_timesteps == 100


@pytest.mark.parametrize("dim", [32, 33])
def test_timestep_embedding_matches_jax(dim):
    t = np.array([0, 1, 7, 250, 999], np.int32)
    want = np.asarray(jax_unet.timestep_embedding(jnp.asarray(t), dim))
    got = unet.timestep_embedding(torch.from_numpy(t).long(), dim)
    assert got.dtype == torch.float32 and got.shape == (5, dim)
    if dim % 2:
        assert not got[:, -1].any()
    close(got.numpy(), want)


# ---------------------------------------------------------------------------
# the UNet

@pytest.mark.parametrize("case", sorted(UNETS))
def test_unet_forward_matches_jax(case):
    kwargs, hw = UNETS[case]
    net, params = jax_net(kwargs, hw)
    x, t = _inputs(hw)
    want = np.asarray(jax.jit(net.apply)({"params": params}, x, t))
    model = port_net(kwargs, params)
    with torch.no_grad():
        got = nhwc(model(nchw(x), torch.from_numpy(t).long()))
    assert got.shape == want.shape == (2, *hw, 3)
    close(got, want)


def test_groupnorm_epsilon_is_flax_s():
    """Flax's GroupNorm epsilon is 1e-6 (``nn.GroupNorm``'s 1e-5): at an
    input of 1e-3 and zero biases the first GroupNorm's variance is of the
    order of the epsilon, so the forward shows which one runs.  (The biases
    are zero because Flax takes the variance as E[x^2] - E[x]^2, which
    loses the digits of a small variance under a large mean.)"""
    kwargs, hw = UNETS["attn_down_and_up"]
    net, params = jax_net(kwargs, hw)
    params = jax.tree_util.tree_map_with_path(
        lambda path, v: v * 0 if path[-1].key == "bias" else v, params)
    x, t = _inputs(hw)
    x = x * np.float32(1e-3)
    want = np.asarray(jax.jit(net.apply)({"params": params}, x, t))
    model = port_net(kwargs, params)
    assert {m.eps for m in model.modules()
            if isinstance(m, torch.nn.GroupNorm)} == {1e-6}
    with torch.no_grad():
        close(nhwc(model(nchw(x), torch.from_numpy(t).long())), want)


def test_flax_fast_variance_loses_a_small_variance():
    """A JAX-side gap, held here so that nobody "repairs" the port: Flax's
    GroupNorm takes the variance as E[x^2] - E[x]^2 in float32, which loses
    the digits of a small variance under a large mean (input 1e-3, biases
    0.05).  There the port (torch's GroupNorm, as the reference's) stays
    within 3e-5 of max|ref| of its own float64 forward, and JAX lies more
    than 1e-4 of max|ref| from it (5.8e-4 here; the port 3.8e-6)."""
    kwargs, hw = UNETS["attn_down_and_up"]
    net, params = jax_net(kwargs, hw)
    x, t = _inputs(hw)
    x = x * np.float32(1e-3)
    jax_out = np.asarray(jax.jit(net.apply)({"params": params}, x, t))
    model = port_net(kwargs, params)
    tt = torch.from_numpy(t).long()
    with torch.no_grad():
        got = nhwc(model(nchw(x), tt))
        ref = model.double()(nchw(x).double(), tt).numpy().transpose(
            0, 2, 3, 1)
    scale = np.abs(ref).max()
    port_err = np.abs(got - ref).max() / scale
    jax_err = np.abs(jax_out - ref).max() / scale
    print(f"of max|float64|: port {port_err:.3e}, JAX {jax_err:.3e}")
    assert port_err <= ATOL, port_err
    assert jax_err > 1e-4, jax_err


def test_two_heads_are_reached():
    model = unet.UNet(**UNETS["two_heads"][0])
    heads = {m.heads for m in model.modules()
             if isinstance(m, unet.AttnBlock)}
    assert heads == {2}
    model = unet.UNet(**UNETS["attn_down_and_up"][0])
    assert isinstance(model.input_blocks[3][1], unet.AttnBlock)  # level 1
    assert isinstance(model.output_blocks[0][1], unet.AttnBlock)


def test_bf16_forward_is_finite_and_near_jax():
    """bf16 autocast over float32 weights against the JAX float32 forward:
    within 2e-2 of max|ref| (1.44e-2 here; JAX's own bf16 forward lies
    1.55e-2 from it, and the two bf16 forwards 2.1e-2 from each other:
    each rounds in its own places)."""
    kwargs, hw = UNETS["attn_down_and_up"]
    net, params = jax_net(kwargs, hw)
    x, t = _inputs(hw)
    want = np.asarray(jax.jit(net.apply)({"params": params}, x, t))
    model = port_net(kwargs, params)
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        out = model(nchw(x), torch.from_numpy(t).long())
    assert out.dtype == torch.bfloat16
    got = nhwc(out)
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 2e-2, err


def test_init_is_flax_default():
    """Zero tensors where JAX's init has them (so a fresh net outputs
    zero), GroupNorm scale one, every other kernel LeCun normal."""
    kwargs, hw = UNETS["attn_down_and_up"]
    net = jax_unet.UNet(**kwargs)
    x, t = _inputs(hw)
    variables = jax.jit(net.init)(jax.random.PRNGKey(0), x, t)
    want = unet_state_dict(jax.tree.map(np.asarray, variables["params"]),
                           **{k: kwargs[k] for k in STRUCTURE if k in kwargs})
    model = unet.UNet(**kwargs, seed=3)
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    normalized = {"port": [], "jax": []}
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, name
        assert bool((g == 0).all()) == bool((w == 0).all()), name
        if name.endswith("norm.weight") or name == "out.0.weight":
            assert bool((g == 1).all()), name
        elif name.endswith(".weight") and w.any():
            fan_in = w[0].numel()
            normalized["port"].append(g.flatten() * fan_in ** 0.5)
            normalized["jax"].append(w.flatten() * fan_in ** 0.5)
    for key, parts in normalized.items():
        v = torch.cat(parts)
        assert abs(float(v.std()) - 1.0) < 0.03, key
        assert float(v.abs().max()) <= 2 / 0.87962566103423978 + 1e-5, key
    with torch.no_grad():
        assert not model(nchw(x), torch.from_numpy(t).long()).any()


def test_bridge_at_full_width_consumes_every_leaf(monkeypatch):
    """The shipped width (inner 64, mults (1, 2, 4, 8), attention at rate
    8): JAX shapes by ``eval_shape`` and the port's on the meta device, no
    68 M-parameter init on either side."""
    shapes = jax.eval_shape(jax_unet.UNet().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 6)),
                            jnp.zeros((1,), jnp.int32))["params"]
    zeros = jax.tree.map(
        lambda s: np.broadcast_to(np.float32(0), s.shape), shapes)
    sd = unet_state_dict(zeros)
    assert len(sd) == len(jax.tree.leaves(shapes))
    monkeypatch.setattr(unet, "flax_init", lambda model, seed: None)
    want = {k: tuple(v.shape)
            for k, v in unet.UNet(device="meta").state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    n = sum(v.numel() for v in sd.values())
    assert 67e6 < n < 69e6, n
    extra = dict(zeros, Dense_9={"kernel": np.zeros((2, 2), np.float32)})
    with pytest.raises(ValueError, match="Dense_9"):
        unet_state_dict(extra)


# ---------------------------------------------------------------------------
# the diffusion

def _sched(n=8):
    return (gaussian.Schedule.create("linear", n),
            jax_gaussian.Schedule.create("linear", n))


def test_q_sample_matches_jax():
    sched, jsched = _sched(1000)
    rng = np.random.default_rng(0)
    x0 = rng.uniform(-1, 1, (3, 8, 8, 3)).astype(np.float32)
    noise = rng.normal(0, 1, x0.shape).astype(np.float32)
    t = np.array([0, 417, 999], np.int32)
    want = np.asarray(jax_gaussian.q_sample(jsched, x0, t, noise))
    got = gaussian.q_sample(sched, nchw(x0), torch.from_numpy(t).long(),
                            nchw(noise))
    close(nhwc(got), want)


def _batch(hw=(16, 16), batch=2, seed=5):
    rng = np.random.default_rng(seed)
    return {"HR": rng.uniform(-1, 1, (batch, *hw, 3)).astype(np.float32),
            "SR": rng.uniform(-1, 1, (batch, *hw, 3)).astype(np.float32)}


def _jax_draws(rng, sched, x0):
    """``t`` and the noise of JAX ``p_losses`` (``gaussian.py:119-121``)."""
    k_t, k_n, _ = jax.random.split(rng, 3)
    t = jax.random.randint(k_t, (x0.shape[0],), 0, sched.num_timesteps)
    noise = jax.random.normal(k_n, x0.shape, jnp.float32)
    return np.asarray(t), np.asarray(noise)


def test_p_losses_and_gradients_match_jax():
    kwargs, hw = UNETS["attn_down_and_up"]
    net, params = jax_net(kwargs, hw)
    sched, jsched = _sched(1000)
    batch = _batch(hw)
    rng = jax.random.PRNGKey(7)

    def apply(variables, x, t, train, key):
        return net.apply({"params": variables}, x, t, train=train)

    def loss_fn(p):
        return jax_gaussian.p_losses(apply, p, jsched, batch, rng)

    want_loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    t, noise = _jax_draws(rng, jsched, batch["HR"])
    model = port_net(kwargs, params)
    loss = gaussian.p_losses_given(model, sched, nchw(batch["HR"]),
                                   nchw(batch["SR"]),
                                   torch.from_numpy(t).long(), nchw(noise))
    loss.backward()
    assert float(loss) == pytest.approx(float(want_loss), rel=RTOL)
    want = unet_state_dict(jax.tree.map(np.asarray, grads),
                           **{k: kwargs[k] for k in STRUCTURE
                              if k in kwargs})
    largest = max(float(g.abs().max()) for g in want.values())
    zeros = zero_by_math(model)
    assert len(zeros) == 6
    for name, p in model.named_parameters():
        if name in zeros:  # float32 rounding on both sides, ~1e-8
            for g in (p.grad, want[name]):
                assert float(g.abs().max()) <= 1e-6 * largest, name
        else:
            close(p.grad.numpy(), want[name].numpy())


def zero_by_math(model):
    """Biases whose gradient is zero in exact arithmetic: a per-channel
    shift that reaches nothing but a GroupNorm of one channel a group
    (32 channels), which removes it: a ResBlock's ``in_conv`` bias there,
    and the last block's residual biases before ``out.0``."""
    names = {f"{n}.in_conv.bias" for n, m in model.named_modules()
             if isinstance(m, unet.ResBlock)
             and m.out_norm.num_channels == unet.GN_GROUPS}
    if model.out[0].num_channels == unet.GN_GROUPS:
        last = f"output_blocks.{len(model.output_blocks) - 1}.0"
        names |= {f"{last}.out_conv.bias", f"{last}.skip.bias"}
    return names


def _jax_chain(net, params, jsched, cond, noises):
    """The JAX ancestral chain step by step: ``UNet.apply``, the clip and
    the ``Schedule`` constants, fed ``noises`` (the initial image, then one
    a step with t > 0) as JAX ``gaussian.py:150-160`` composes them."""
    apply = jax.jit(net.apply)
    c1, c2 = jsched.posterior_mean_coef1, jsched.posterior_mean_coef2
    logvar = jsched.posterior_log_variance_clipped
    img, states = noises[0], [noises[0]]
    n = jsched.num_timesteps
    for k, t in enumerate(range(n - 1, -1, -1)):
        tb = jnp.full((img.shape[0],), t, jnp.int32)
        x = jnp.clip(apply({"params": params},
                           jnp.concatenate([img, cond], -1), tb), -1, 1)
        mean = c1[t] * x + c2[t] * img
        if t > 0:
            img = mean + jnp.exp(0.5 * logvar[t]) * noises[k + 1]
        else:
            img = mean
        states.append(img)
    return [np.asarray(s) for s in states]


def test_eight_step_chain_and_snapshots_match_jax():
    kwargs, hw = UNETS["attn_down_and_up"]
    net, params = jax_net(kwargs, hw)
    sched, jsched = _sched(8)
    cond = _batch(hw)["SR"]
    # the port's draws, in its order: the initial image, then t = 7 ... 1
    gen = torch.Generator().manual_seed(11)
    noises = [nhwc(torch.randn((2, 3, *hw), generator=gen))
              for _ in range(8)]
    states = _jax_chain(net, params, jsched, cond, noises)
    model = port_net(kwargs, params)
    got = gaussian.p_sample_loop(model, sched, nchw(cond),
                                 torch.Generator().manual_seed(11))
    close(nhwc(got), states[-1])
    chain = gaussian.p_sample_chain(model, sched, nchw(cond),
                                    torch.Generator().manual_seed(11),
                                    n_snapshots=3)
    bounds = gaussian.snapshot_bounds(8, 3)
    np.testing.assert_array_equal(
        bounds, np.linspace(8, 0, 4).astype(int))
    assert chain.shape == (4, 2, 3, *hw)
    for snap, lo in zip(chain, bounds):
        close(nhwc(snap), states[8 - lo])


def _tiny_cfgs(crop=16):
    kw = dict(synthetic=True, synthetic_size=8, crop_size=crop,
              test_crop_size=crop, batch_size=2, test_batch_size=2,
              num_workers=2)
    return DataConfig(**kw), JaxDataConfig(**kw)


def _trainer(tmp_path, kwargs=TINY, crop=16, timesteps=8):
    return DiffusionTrainer(_tiny_cfgs(crop)[0], scale=2,
                            save_dir=str(tmp_path), n_timestep=timesteps,
                            bf16=False, unet_kwargs=kwargs, device="cpu")


def test_three_adam_steps_match_the_jax_trainer(tmp_path):
    """Three steps of each trainer from the same perturbed weights, each
    step given JAX's own ``t`` and noise: every loss within rtol 1e-4, and
    the weights after the third step within the float32 bar but for at
    most 1e-4 of the elements, each of which within two Adam steps' worth
    (2 lr a step).  Adam's first update is lr * sign(g) for |g| well above
    its epsilon, so an element whose gradient lies at float32 rounding of
    its tensor (~1e-7 of the largest) may move either way on either side:
    in a trial at these widths 19 of 3.1 M elements did, by 5.9e-5 at most (lr
    1e-4).  A fault in the optimizer (moments, bias correction, lr) moves
    most elements."""
    kwargs = dict(inner_channel=64, channel_mults=(1, 2), res_blocks=1)
    structure = dict(channel_mults=(1, 2), res_blocks=1)
    jt = JaxDiffusionTrainer(_tiny_cfgs()[1], scale=2,
                             save_dir=str(tmp_path / "jax"), n_timestep=1000,
                             bf16=False, unet_kwargs=kwargs, num_devices=1)
    params = random_params(jax.tree.map(np.asarray, jt.params), 3)
    jt.params = jax.tree.map(jnp.asarray, params)
    jt.opt_state = jt.tx.init(jt.params)
    port = _trainer(tmp_path / "port", kwargs, timesteps=1000)
    port.unet.load_state_dict(unet_state_dict(params, **structure))
    steps, lr = 3, 1e-4
    for step in range(steps):
        batch = _batch(seed=20 + step)
        key = jax.random.PRNGKey(100 + step)
        jt.params, jt.opt_state, want = jt._jit_train(jt.params,
                                                      jt.opt_state, batch,
                                                      key)
        t, noise = _jax_draws(key, jt.sched, batch["HR"])
        got = port.train_step(batch, t=t, noise=noise)
        assert float(got) == pytest.approx(float(want), rel=RTOL), step
    want = unet_state_dict(jax.tree.map(np.asarray, jt.params), **structure)
    outside = total = 0
    for name, p in port.unet.state_dict().items():
        ref = want[name]
        diff = (p - ref).abs()
        outside += int((diff > ATOL * ref.abs().max()
                        + RTOL * ref.abs()).sum())
        total += ref.numel()
        assert float(diff.max()) <= 2 * lr * steps, name
    assert outside <= 1e-4 * total, (outside, total)


def test_checkpoint_resumes_params_adam_and_step(tmp_path):
    trainer = _trainer(tmp_path)
    trainer.train(n_iter=2)
    path = trainer.save_checkpoint("resume")
    fresh = _trainer(tmp_path, crop=16)
    assert fresh.step == 0
    fresh.load_checkpoint(path)
    assert fresh.step == 2
    for a, b in zip(trainer.opt.state.values(), fresh.opt.state.values()):
        for key in ("exp_avg", "exp_avg_sq", "step"):
            torch.testing.assert_close(a[key], b[key], rtol=0, atol=0)
    # one more step from each, on the same batch and draws: equal
    batch = _batch()
    for tr in (trainer, fresh):
        tr.train_step(batch, torch.Generator().manual_seed(4))
    for a, b in zip(trainer.unet.parameters(), fresh.unet.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_super_resolution_reflect_pads_and_crops(tmp_path):
    trainer = _trainer(tmp_path, dict(TINY, channel_mults=(1, 1, 1, 1)))
    bc = np.random.default_rng(0).random((1, 13, 11, 3), dtype=np.float32)
    cond, size = trainer._cond(bc)
    padded = np.pad(bc, ((0, 0), (0, 3), (0, 5), (0, 0)), mode="reflect")
    assert size == (13, 11) and cond.shape == (1, 3, 16, 16)
    torch.testing.assert_close(cond, nchw(padded) * 2 - 1)
    got = trainer.super_resolution(bc, torch.Generator().manual_seed(2))
    want = trainer.super_resolution(padded, torch.Generator().manual_seed(2))
    assert got.shape == (1, 13, 11, 3) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, want[:, :13, :11])
    chain = trainer.super_resolution_chain(bc, n_snapshots=4)
    assert chain.shape == (5, 1, 13, 11, 3)
    assert chain.min() >= 0 and chain.max() <= 1


@pytest.mark.parametrize("mode", ["sample", "continuous", "no_cv2"])
def test_validate_keys_and_dumps(tmp_path, monkeypatch, capsys, mode):
    trainer = _trainer(tmp_path, crop=32)  # AlexNet LPIPS needs 32^2
    if mode == "no_cv2":
        monkeypatch.setitem(sys.modules, "cv2", None)  # import raises
    result_dir = tmp_path / "val"
    val = trainer.validate(max_images=2, result_dir=str(result_dir),
                           continuous=mode == "continuous", n_snapshots=3)
    lp = "lpips" if "lpips" in val else "lpips*"
    assert sorted(val) == sorted(
        ["mse", "psnr", "ssim", "ergas", lp, "bc_mse", "bc_psnr",
         "bc_ssim", "bc_ergas", "bc_" + lp])
    assert np.isfinite(list(val.values())).all()
    files = sorted(os.listdir(result_dir))
    tifs = [f for f in files if f.endswith(".tif")]
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is None:
        assert not tifs
    else:
        assert len(tifs) == 8, files
        img = cv2.imread(str(result_dir / tifs[0]))
        assert img is not None and img.shape == (32, 32, 3)
    if mode == "no_cv2":
        assert "cv2 does not import" in capsys.readouterr().err
    assert len([f for f in files if f.endswith("_plot.png")]) == 2
    process = [f for f in files if f.endswith("_sr_process.png")]
    assert len(process) == (2 if mode == "continuous" else 0), files


# ---------------------------------------------------------------------------
# configs and plotting

CONFIG_NAMES = sorted(os.path.splitext(f)[0]
                      for f in os.listdir(jax_config.CONFIG_DIR))


@pytest.mark.parametrize("name", CONFIG_NAMES)
def test_config_copy_and_kwargs_equal_jax(name):
    assert filecmp.cmp(os.path.join(config.CONFIG_DIR, f"{name}.json"),
                       os.path.join(jax_config.CONFIG_DIR, f"{name}.json"),
                       shallow=False)
    got = config.trainer_kwargs_from_config(config.load_gdp_config(name))
    want = jax_config.trainer_kwargs_from_config(
        jax_config.load_gdp_config(name))
    assert got == want
    assert got["unet_kwargs"]["attn_res"] == (8,)


def test_twelve_configs_and_scales():
    assert len(CONFIG_NAMES) == 12
    assert config.RESOLUTION_TO_SCALE == jax_config.RESOLUTION_TO_SCALE


@pytest.mark.parametrize("matplotlib", ["present", "absent"])
def test_plot_chain_grid(tmp_path, monkeypatch, capsys, matplotlib):
    chain = np.random.default_rng(0).random((4, 8, 8, 3), dtype=np.float32)
    path = tmp_path / "g" / "chain.png"
    if matplotlib == "absent":
        monkeypatch.setitem(sys.modules, "matplotlib", None)
        assert not plotting.plot_chain_grid(chain, str(path))
        assert "matplotlib does not import" in capsys.readouterr().err
        assert not path.exists()
    else:
        assert plotting.plot_chain_grid(chain, str(path))
        assert path.stat().st_size > 0
