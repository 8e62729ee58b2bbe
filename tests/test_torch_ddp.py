"""The port's data mesh: W ranks at global batch B take the step one process
takes at batch B, which is also the JAX package's sharded step.

Two gloo ranks on the CPU (``sradsgan_tpu_torch/tools/dp_check.py``, one
spawn for the module, joined against a deadline) run every scenario once:

- the tiny flagship (WGAN-GP through the CBAM patch D's BatchNorms) and
  tiny SRGAN (lsgan, BatchNorm in G), from the weights of JAX trainers at
  ``num_devices=2`` moved over the bridges, three steps at global batch 4;
- ``DiffusionTrainer``'s step at global batch 4, ``t`` and the noise drawn
  for the global batch;
- an epoch of ``Trainer.train()`` over 11 images at batch 4;
- validation sweeps whose images split unevenly over the ranks;
- halo-tiled inference of a 36 x 20 scene, 15 tiles in chunks of 4 (the
  tail of 3 padded to 4), each rank stitching the whole scene.

Each is held against one process here at the global batch (the same
weights, batches and draws): the losses within 1e-6 relative, every
gradient within 1e-5 of its own max|ref| (one that is zero by the math
within 1e-4 of its network's largest), the BatchNorm running statistics
within 1e-6; the GAN steps also against the JAX ``Trainer`` on two of
conftest's virtual CPU devices at the bars of ``tests/test_torch_trainer.py``
(the alphas fixed, as there).  Outside the spawn: the sharded loader against
JAX's, the global BatchNorm against ``nn.BatchNorm2d`` with its first and
second derivatives checked, and ``num_devices`` through the configs.
"""

import dataclasses
import tempfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu import models as jax_models  # noqa: E402
from sradsgan_tpu.core.config import config_for_model as jax_config  # noqa
from sradsgan_tpu.core.config import save_config as jax_save_config  # noqa
from sradsgan_tpu.data.datasets import (  # noqa: E402
    build_train_dataset as jax_train_dataset)
from sradsgan_tpu.data.loader import DataLoader as JaxLoader  # noqa: E402
from sradsgan_tpu.models.discriminators import (  # noqa: E402
    PatchDiscriminator as JaxD)
from sradsgan_tpu.parallel.mesh import replicate as jax_replicate  # noqa
from sradsgan_tpu.parallel.mesh import shard_batch as jax_shard  # noqa
from sradsgan_tpu.train.trainer import Trainer as JaxTrainer  # noqa: E402
from sradsgan_tpu_torch import models  # noqa: E402
from sradsgan_tpu_torch.config import (  # noqa: E402
    DataConfig, load_config, save_config)
from sradsgan_tpu_torch.data.datasets import build_train_dataset  # noqa
from sradsgan_tpu_torch.data.loader import DataLoader  # noqa: E402
from sradsgan_tpu_torch.diffusion.trainer import DiffusionTrainer  # noqa
from sradsgan_tpu_torch.nn.norm import global_batch_norm  # noqa: E402
from sradsgan_tpu_torch.parallel import mesh as port_mesh  # noqa: E402
from sradsgan_tpu_torch.tools import dp_check  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import (  # noqa: E402
    discriminator_state_dict, generator_state_dict, vgg19_state_dict)
from sradsgan_tpu_torch.train.trainer import Trainer  # noqa: E402
from test_torch_zoo_train import (  # noqa: E402
    _reference_d_stats, _replay, zero_by_math)

WORLD, BATCH, STEPS, ALPHA_SEED, DATA_SEED = 2, 4, 3, 5, 11
CBAM_D = {"blocks": [[4, 1, False], [4, 2, True], [8, 1, True],
                     [8, 2, True], [8, 1, True], [8, 1, True]],
          "kernel_size": 3, "use_attention": True}
PLAIN_D = {"blocks": [[4, 1, False], [4, 2, True], [8, 1, True],
                      [8, 2, True]], "kernel_size": 3, "use_attention": False}
GANS = {"sradsgan": (dict(base_filters=16, n_groups=1, n_blocks=1), CBAM_D),
        "srgan": (dict(base_filters=8, num_residuals=1), PLAIN_D)}
UNET = dict(inner_channel=32, channel_mults=(1, 2), res_blocks=1)
DEADLINE_S = 150.0
# 15 tiles of 8 + 2 * 3 pixels, in chunks of 4: 2 + 2 a rank, 2 + 2, 2 + 2
# and, padded from 3, 2 + 2
TILED = {"model": "sradsgan", "scale": 2,
         "model_kwargs": GANS["sradsgan"][0], "seed": 13, "height": 36,
         "width": 20, "tile": 8, "halo": 3, "batch_tiles": 4}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _g_state(model, state):
    return generator_state_dict(model, {"params": _np(state.g_params),
                                        "batch_stats": _np(state.g_stats)})


def _d_state(d_kw, params, stats):
    return discriminator_state_dict(
        {"params": _np(params), "batch_stats": _np(stats)},
        tuple(map(tuple, d_kw["blocks"])), d_kw["use_attention"])


def _port_cfg(name, model_kwargs, save_dir, **data):
    cfg = models.config_for_model(name, 2, bf16=False,
                                  model_kwargs=model_kwargs,
                                  save_dir=save_dir)
    cfg.data.synthetic, cfg.data.crop_size = True, 16
    cfg.data.test_crop_size, cfg.data.batch_size = 16, BATCH
    cfg.data.num_workers = 2
    for key, value in data.items():
        setattr(cfg.data, key, value)
    return cfg


def _jax_trainer(model, name, tmp):
    """The JAX trainer of the tiny twin at num_devices=2 (the flagship's
    attention gains 0.5) and its weights as the port's state dicts."""
    kwargs, d_kw = GANS[model]
    cfg = jax_config(name, 2)
    cfg.bf16 = False
    cfg.data.synthetic, cfg.data.crop_size = True, 16
    cfg.data.batch_size = BATCH
    cfg.model_kwargs = kwargs
    cfg.save_dir = tmp
    cfg.num_devices = WORLD
    jt = JaxTrainer(cfg)
    if model == "sradsgan":
        params = _np(jt.state.g_params)
        ga = dict(params["GlobalAttention_0"])
        for key in ("ChannelSelfAttention_0", "SpatialSelfAttention_0"):
            ga[key] = dict(ga[key], gamma=np.full((1,), 0.5, np.float32))
        params = dict(params, GlobalAttention_0=ga)
        jt.state = jax_replicate(jt.state.replace(
            g_params=jax.tree.map(jnp.asarray, params),
            g_opt=jt.g_opt_tx.init(jax.tree.map(jnp.asarray, params))),
            jt.mesh)
    weights = {"generator": _g_state(model, jt.state),
               "discriminator": _d_state(d_kw, jt.state.d_params,
                                         jt.state.d_stats),
               "vgg": vgg19_state_dict(_np(jt.vgg_params))}
    return jt, weights


def _fan_in_unet(seed):
    """A UNet state dict with every conv and dense kernel drawn (the JAX
    init zeroes the output conv, whose UNet then outputs 0)."""
    from sradsgan_tpu_torch.diffusion.unet import UNet
    unet = UNet(**UNET, image_size=16, seed=0)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in unet.modules():
            if isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
                w = torch.randn(m.weight.shape, generator=gen)
                m.weight.copy_(w * 0.5 / m.weight[0].numel() ** 0.5)
                if m.bias is not None:
                    m.bias.copy_(torch.randn(m.bias.shape, generator=gen)
                                 * 0.05)
    return unet.state_dict()


@pytest.fixture(scope="module")
def run():
    """Build the JAX trainers, write the weights and configs, run every
    scenario on two ranks once."""
    mp = pytest.MonkeyPatch()
    tmp = tempfile.TemporaryDirectory()
    work = tmp.name
    names, jax_trainers, weights, spec = {}, {}, {}, []
    tiny = []
    try:
        for model, (kwargs, d_kw) in GANS.items():
            name = names[model] = dp_check.register_tiny(model, d_kw)
            tiny.append({"model": model, "d_kwargs": d_kw})
            jspec = jax_models.get_spec(model)
            mp.setitem(jax_models._REGISTRY, name, dataclasses.replace(
                jspec, name=name, discriminator=lambda _d=d_kw, **kw: JaxD(
                    blocks=tuple(map(tuple, _d["blocks"])),
                    kernel_size=_d["kernel_size"],
                    use_attention=_d["use_attention"], **kw)))
            jax_trainers[model], w = _jax_trainer(model, name, work)
            weights[model] = f"{work}/{model}_weights.pt"
            torch.save(w, weights[model])
            cfg = _port_cfg(name, kwargs, f"{work}/{model}")
            save_config(cfg, f"{work}/{model}.json")
            spec.append({"name": model, "kind": "gan",
                         "config": f"{work}/{model}.json",
                         "weights": weights[model], "seed": DATA_SEED,
                         "steps": STEPS, "batch": BATCH, "lr_size": 8,
                         "alpha_seed": ALPHA_SEED})
        torch.save(_fan_in_unet(3), f"{work}/unet.pt")
        spec.append({"name": "diffusion", "kind": "diffusion", "scale": 2,
                     "crop": 16, "batch": BATCH, "unet_kwargs": UNET,
                     "weights": f"{work}/unet.pt", "seed": DATA_SEED,
                     "steps": 2, "draw_seed": 1, "turns": 2,
                     "timed_steps": 1})
        kwargs = GANS["sradsgan"][0]
        epoch_cfg = _port_cfg(names["sradsgan"], kwargs, f"{work}/epoch",
                              synthetic_size=11)
        epoch_cfg.num_epochs = 1
        save_config(epoch_cfg, f"{work}/epoch.json")
        spec.append({"name": "epoch", "kind": "epoch",
                     "config": f"{work}/epoch.json",
                     "weights": weights["sradsgan"]})
        # 9 test images in batches of 3: 5 and 4 a rank, in local batches
        # of 2 (2, 2, 1 and 2, 2); the first batch: 2 and 1
        val_cfg = _port_cfg(names["sradsgan"], kwargs, f"{work}/val",
                            synthetic_size=72, test_batch_size=3)
        save_config(val_cfg, f"{work}/val.json")
        for label, cap in (("whole", None), ("first_batch", 1)):
            spec.append({"name": f"val_{label}", "kind": "validate",
                         "config": f"{work}/val.json", "max_batches": cap,
                         "weights": weights["sradsgan"]})
        torch.save(torch.load(weights["sradsgan"],
                              weights_only=True)["generator"],
                   f"{work}/tiled_g.pt")
        spec.append(dict(TILED, name="tiled", kind="tiled",
                         weights=f"{work}/tiled_g.pt", turns=["one", "mesh"]))
        ranks = dp_check.run_ranks({"device": "cpu", "backend": "gloo",
                                    "tiny": tiny, "scenarios": spec},
                                   WORLD, f"{work}/ranks", DEADLINE_S)
        yield {"ranks": ranks, "names": names, "jax": jax_trainers,
               "weights": weights, "work": work, "spec": spec}
    finally:
        mp.undo()
        for name in names.values():
            models._REGISTRY.pop(name, None)
        tmp.cleanup()


def _one_process_gan(run, model):
    cfg = load_config(f"{run['work']}/{model}.json")
    trainer = Trainer(cfg, device="cpu")
    dp_check.load_gan_weights(trainer, run["weights"][model])
    batch = dp_check.gan_batches(DATA_SEED, 1, BATCH, 8, 2)[0]
    metrics = trainer.train_step(
        batch, torch.Generator().manual_seed(ALPHA_SEED))
    return {k: float(v) for k, v in metrics.items()}, trainer


def _zero_in_float64(trainer, batch):
    """The UNet's parameters whose gradient is zero in exact arithmetic
    (below 1e-9 of the largest in a float64 step): biases that a GroupNorm
    of one channel a group removes, at inner width 32."""
    import copy
    ref = copy.deepcopy(trainer)
    ref.unet.double()
    ref.train_step(batch, torch.Generator().manual_seed(1))
    grads = {n: float(p.grad.abs().max())
             for n, p in ref.unet.named_parameters()}
    return {n for n, g in grads.items() if g < 1e-9 * max(grads.values())}


def _hold_grads(got, module, net, zero=None):
    """Every gradient within 1e-5 of its own max|ref|.  One that is zero by
    the math (``zero``, by default a conv bias before a BatchNorm and the
    SGAM key bias) is float32 rounding alone, so its own max says nothing:
    it is held within 1e-4 of the network's largest gradient."""
    zero = zero_by_math(module) if zero is None else zero
    largest = max(float(p.grad.abs().max()) for p in module.parameters())
    assert set(got) == {n for n, _ in module.named_parameters()}, net
    for n, p in module.named_parameters():
        err = float((got[n] - p.grad).abs().max())
        bound = (1e-4 * largest if n in zero
                 else 1e-5 * float(p.grad.abs().max()))
        assert err <= bound, (net, n, err, bound)


@pytest.mark.parametrize("model", ["sradsgan", "srgan", "diffusion"])
def test_two_ranks_take_the_one_process_step(run, model):
    """Step 1 of each rank against one process at the global batch."""
    for rank, ranks in enumerate(run["ranks"]):
        got = ranks[model]
        if model == "diffusion":
            data_cfg = DataConfig(crop_size=16, batch_size=BATCH)
            with tempfile.TemporaryDirectory() as save_dir:
                ref = DiffusionTrainer(data_cfg, 2, save_dir=save_dir,
                                       unet_kwargs=UNET, bf16=False,
                                       device="cpu")
            ref.unet.load_state_dict(torch.load(f"{run['work']}/unet.pt",
                                                weights_only=True))
            batch = dp_check.diffusion_batches(DATA_SEED, 1, BATCH, 16)[0]
            zero = _zero_in_float64(ref, batch)
            loss = float(ref.train_step(
                batch, torch.Generator().manual_seed(1)))
            assert got["losses"][0] == pytest.approx(loss, rel=1e-6), rank
            _hold_grads(got["grads"], ref.unet, "unet", zero)
            continue
        want, ref = _one_process_gan(run, model)
        assert set(got["losses"][0]) == set(want)
        for key, value in want.items():
            assert got["losses"][0][key] == pytest.approx(
                value, rel=1e-6), (rank, key)
        for net in ("generator", "discriminator"):
            module = getattr(ref, net)
            _hold_grads(got["grads"][net], module, net)
            stats = {k: v for k, v in module.state_dict().items()
                     if k.endswith(("running_mean", "running_var"))}
            assert set(got["stats"][net]) == set(stats)
            for key, value in stats.items():
                np.testing.assert_allclose(got["stats"][net][key].numpy(),
                                           value.numpy(), rtol=0, atol=1e-6,
                                           err_msg=(rank, net, key))
        if model == "srgan":  # the global BatchNorm in G moved
            assert got["stats"]["generator"]


@pytest.mark.parametrize("model", ["sradsgan", "srgan"])
def test_two_ranks_match_the_jax_mesh_step(run, model, monkeypatch):
    """Three steps against the JAX ``Trainer`` on two devices: the losses
    of each step and every parameter and running statistic after them, at
    the one-process parity bars."""
    jt = run["jax"][model]
    kwargs, d_kw = GANS[model]
    alpha = torch.rand((BATCH, 1, 1, 1), generator=torch.Generator()
                       .manual_seed(ALPHA_SEED)).numpy()
    monkeypatch.setattr(jax.random, "uniform",
                        lambda *a, **k: jnp.asarray(alpha))
    lsgan = jt.cfg.gan.gan_type == "lsgan"
    expected_d = _np(jt.state.d_stats) if lsgan else None
    got = run["ranks"][0][model]
    batches = dp_check.gan_batches(DATA_SEED, STEPS, BATCH, 8, 2)
    for step, batch in enumerate(batches):
        if lsgan:
            triples = _reference_d_stats(jt, jt.state, batch, expected_d)
        jt.state, want = jt._jit_step(jt.state, jax_shard(batch, jt.mesh),
                                      jax.random.PRNGKey(step))
        if lsgan:
            expected_d = _replay(triples, jt.state.d_stats)
        for key, value in got["losses"][step].items():
            assert value == pytest.approx(float(want[key]), rel=5e-4,
                                          abs=1e-4), (step, key)
    lr = jt.cfg.optim.lr
    d_stats = expected_d if lsgan else jt.state.d_stats
    wants = {"generator": _g_state(model, jt.state),
             "discriminator": _d_state(d_kw, jt.state.d_params, d_stats)}
    _, ref = _one_process_gan(run, model)  # for the module structure
    for net, want in wants.items():
        state = got["state"][net]
        assert set(state) == set(want), net
        noise = zero_by_math(getattr(ref, net))
        for key, value in state.items():
            if key in noise:  # Adam's steps are at most lr each
                assert value.abs().max() <= STEPS * lr * 1.01 + 1e-7, key
            elif key.endswith("running_mean"):
                np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                           atol=3e-3, err_msg=(net, key))
            elif key.endswith("running_var"):
                np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                           rtol=5e-3, err_msg=(net, key))
            elif not key.endswith("num_batches_tracked"):
                np.testing.assert_allclose(value.numpy(), want[key].numpy(),
                                           atol=1e-4, rtol=1e-3,
                                           err_msg=(net, key))


@pytest.mark.parametrize("scenario", ["sradsgan", "srgan", "diffusion",
                                      "epoch"])
def test_the_ranks_end_bit_equal(run, scenario):
    """After their steps the two ranks hold the same bits: the averaged
    gradients, the weight clip and Adam leave nothing to drift."""
    first, second = (r[scenario]["state"] for r in run["ranks"])
    nets = (("unet", first, second),) if scenario == "diffusion" else (
        (net, first[net], second[net]) for net in first)
    for net, a, b in nets:
        assert set(a) == set(b) and a, net
        for key in a:
            assert torch.equal(a[key], b[key]), (scenario, net, key)


@pytest.mark.parametrize("model", ["sradsgan", "srgan"])
def test_the_ranks_step_eagerly(run, model):
    """A rank of a data mesh never captures its step into a CUDA graph
    (its collectives stay outside a graph): every checked step eager."""
    for ranks in run["ranks"]:
        assert ranks[model]["graph_stats"] == {"eager": STEPS, "captured": 0,
                                               "replayed": 0}


def test_an_epoch_over_an_uneven_set(run, tmp_path):
    """``Trainer.train()`` for one epoch over 11 images at batch 4: both
    ranks take 2 steps, and end where one process ends."""
    cfg = load_config(f"{run['work']}/epoch.json")
    cfg.save_dir = str(tmp_path)
    ref = Trainer(cfg, device="cpu")
    dp_check.load_gan_weights(ref, run["weights"]["sradsgan"])
    want_val = ref.train()
    assert ref.step == 2
    for rank, ranks in enumerate(run["ranks"]):
        got = ranks["epoch"]
        assert got["steps"] == 2, rank
        for key, value in want_val.items():
            assert got["val"][key] == pytest.approx(value, rel=1e-6), key
        lr = cfg.optim.lr
        for net in ("generator", "discriminator"):
            module = getattr(ref, net)
            noise = zero_by_math(module)
            for key, value in module.state_dict().items():
                mine = got["state"][net][key]
                if key in noise:  # Adam's steps of noise: at most lr each
                    assert (mine - value).abs().max() <= 2 * 2 * lr * 1.01
                elif key.endswith("running_mean"):
                    # shifted by the noise-driven biases before the norm
                    np.testing.assert_allclose(mine.numpy(), value.numpy(),
                                               rtol=0, atol=2 * 2 * lr * 1.01,
                                               err_msg=(rank, net, key))
                else:
                    np.testing.assert_allclose(mine.numpy(), value.numpy(),
                                               rtol=0, atol=1e-6,
                                               err_msg=(rank, net, key))


@pytest.mark.parametrize("label,cap", [("whole", None), ("first_batch", 1)])
def test_a_sweep_over_uneven_ranks(run, label, cap):
    """The sweep's means over 9 images (or the first batch of 3), 5 and 4
    (2 and 1) a rank, equal the one-process sweep's."""
    ref = Trainer(load_config(f"{run['work']}/val.json"), device="cpu")
    dp_check.load_gan_weights(ref, run["weights"]["sradsgan"])
    want = ref.validate(cap)
    assert set(want) == {"psnr", "ssim", "ergas", "bc_psnr", "bc_ssim"}
    for ranks in run["ranks"]:
        got = ranks[f"val_{label}"]["val"]
        assert set(got) == set(want)
        for key, value in want.items():
            assert abs(got[key] - value) <= 1e-6 * max(1.0, abs(value)), key


def test_two_ranks_tile_a_scene_as_one_process(run):
    """Every rank returns the whole scene, bit-equal to the other's and to
    one process's within 1e-6 of max|ref| (the ranks forward chunks of 2
    tiles where one process forwards 4), with the two kinds of turn timed
    once each on rank 0."""
    from sradsgan_tpu_torch.evaluation.tiled import tiled_super_resolve

    model = models.create_generator("sradsgan", TILED["scale"],
                                    **TILED["model_kwargs"])
    model.load_state_dict(torch.load(f"{run['work']}/tiled_g.pt",
                                     weights_only=True))
    image = dp_check.tiled_scene(TILED["seed"], TILED["height"],
                                 TILED["width"])
    want = tiled_super_resolve(model.eval(), image, TILED["scale"],
                               TILED["tile"], TILED["halo"],
                               TILED["batch_tiles"], device="cpu")
    scenes = [r["tiled"]["scene"].numpy() for r in run["ranks"]]
    assert scenes[0].shape == want.shape == (72, 40, 3)
    np.testing.assert_array_equal(scenes[0], scenes[1])
    assert np.abs(scenes[0] - want).max() <= 1e-6 * np.abs(want).max()
    assert run["ranks"][0]["tiled"]["launches"] == dict.fromkeys(
        dp_check.kernel_wrappers(), 0)  # the CPU runs the plain versions
    turns = run["ranks"][0]["tiled"]["turn_ms"]
    assert len(turns["one"]) == len(turns["mesh"]) == 1
    assert run["ranks"][1]["tiled"]["turn_ms"]["one"] == []


@pytest.mark.parametrize("drop_last", [False, True])
def test_sharded_loader_matches_jax(drop_last):
    """The same paths per shard as the JAX loader's ``shard_index`` /
    ``shard_count`` (24 images, batches of 4, two shards)."""
    cfg = DataConfig(synthetic=True, synthetic_size=24, crop_size=16)
    ds = build_train_dataset(cfg, 2)
    jds = jax_train_dataset(cfg, 2)
    for shard in range(WORLD):
        kw = dict(shuffle=True, seed=7, num_workers=2, drop_last=drop_last,
                  shard_index=shard, shard_count=WORLD)
        got = [b["path"] for b in DataLoader(ds, 4, **kw)]
        want = [b["path"] for b in JaxLoader(jds, 4, **kw)]
        assert got == want and len(got) == 3


def test_sharded_loader_gives_every_rank_the_one_process_steps():
    """11 images at a global batch of 4 over two ranks: 2 steps each (the
    JAX loader's stride would give rank 0 a third), and the ranks' rows of
    step i are rows r::2 of the one-process loader's batch i."""
    cfg = DataConfig(synthetic=True, synthetic_size=11, crop_size=16)
    ds = build_train_dataset(cfg, 2)
    whole = [b["path"] for b in DataLoader(ds, 4, seed=3, num_workers=2)]
    shards = [[b["path"] for b in DataLoader(ds, 2, seed=3, num_workers=2,
                                              shard_index=r,
                                              shard_count=WORLD)]
              for r in range(WORLD)]
    assert [len(s) for s in shards] == [2, 2]
    assert len(DataLoader(ds, 2, shard_index=0, shard_count=WORLD)) == 2
    for i, batch in enumerate(whole):
        for r in range(WORLD):
            assert shards[r][i] == batch[r::WORLD]
    assert len(JaxLoader(jax_train_dataset(cfg, 2), 2, shard_index=0,
                         shard_count=WORLD)) == 3


def test_global_batch_norm_at_world_one_is_batch_norm(tmp_path):
    """On a gloo group of one, the global statistics are the batch's: the
    output and the running statistics of ``nn.BatchNorm2d`` in train mode,
    and the first and second derivatives (``gradcheck``,
    ``gradgradcheck``, float64) go through the all-reduces."""
    import torch.distributed as dist
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = port_mesh.Mesh(0, 1, torch.device("cpu"), dist.group.WORLD)
        gen = torch.Generator().manual_seed(0)
        x = (torch.randn(3, 4, 5, 6, generator=gen, dtype=torch.float64)
             * 2 + 3).requires_grad_()
        bn = torch.nn.BatchNorm2d(4).double().train()
        ref = torch.nn.BatchNorm2d(4).double().train()
        with torch.no_grad():
            for m in (bn, ref):
                m.weight.copy_(torch.linspace(0.5, 2, 4))
                m.bias.copy_(torch.linspace(-1, 1, 4))
        out = global_batch_norm(x, bn, mesh)
        want = ref(x)
        torch.testing.assert_close(out, want, rtol=1e-12, atol=1e-12)
        for key in ("running_mean", "running_var", "num_batches_tracked"):
            torch.testing.assert_close(getattr(bn, key), getattr(ref, key),
                                       rtol=1e-12, atol=1e-12)
        g = torch.randn(out.shape, generator=gen, dtype=torch.float64)
        got = torch.autograd.grad((out * g).sum(), (x, bn.weight, bn.bias))
        expect = torch.autograd.grad((want * g).sum(),
                                     (x, ref.weight, ref.bias))
        for a, b in zip(got, expect):
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-12)
        small = x[:2, :, :3, :3].detach().clone().requires_grad_()
        assert torch.autograd.gradcheck(
            lambda inp: global_batch_norm(inp, bn, mesh), (small,))
        assert torch.autograd.gradgradcheck(
            lambda inp: global_batch_norm(inp, bn, mesh), (small,))
    finally:
        dist.destroy_process_group()


def test_num_devices_round_trips_a_jax_config(tmp_path):
    """``num_devices`` is read from a JAX config and written back; a value
    that differs from the processes launched raises."""
    from sradsgan_tpu.core.config import load_config as jax_load
    cfg = jax_config("sradsgan", 4)
    cfg.num_devices = 2
    jax_save_config(cfg, str(tmp_path / "jax.json"))
    port = load_config(str(tmp_path / "jax.json"))
    assert port.num_devices == 2
    port.num_devices = 3
    save_config(port, str(tmp_path / "port.json"))
    assert jax_load(str(tmp_path / "port.json")).num_devices == 3
    assert models.config_for_model("sradsgan", 4).num_devices == -1
    with pytest.raises(ValueError, match="num_devices=2 but 1 process"):
        port_mesh.create_mesh(2, "cpu")
    port.num_devices = 2
    with pytest.raises(ValueError, match="torchrun --nproc_per_node=2"):
        Trainer(port, device="cpu")


def test_the_ranks_time_their_steps_in_turns_when_asked(run):
    """A scenario with ``turns`` times its step after the checked steps
    (one value a turn); one without times nothing."""
    for ranks in run["ranks"]:
        turns = ranks["diffusion"]["turn_ms"]
        assert len(turns) == 2 and all(0 < t < float("inf") for t in turns)
        assert ranks["sradsgan"]["turn_ms"] == []


def test_a_world_of_one_keeps_the_device_it_is_given(monkeypatch):
    """Without a launcher or a store there is no group, and an unindexed
    CUDA device stays unindexed: no card is made current, so a caller's
    own ``torch.cuda.set_device`` holds."""
    for key in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(port_mesh, "_ACTIVE_MESH", None)
    current = []
    monkeypatch.setattr(torch.cuda, "set_device", current.append)
    mesh = port_mesh.create_mesh(-1, "cuda")
    assert (mesh.rank, mesh.world, mesh.group) == (0, 1, None)
    assert mesh.device == torch.device("cuda") and current == []
    assert port_mesh.active_mesh() is mesh


def test_all_reduce_sums_is_one_float64_vector(tmp_path):
    """A few numbers, floats and 0-dim tensors of any dtype, summed over a
    gloo group of one and without a group: one float64 vector."""
    import torch.distributed as dist
    values = [1.5, torch.tensor(2.25, dtype=torch.float32),
              torch.tensor(3, dtype=torch.int64)]
    none = port_mesh.Mesh(0, 1, torch.device("cpu"))
    got = port_mesh.all_reduce_sums(values, none)
    assert got.dtype == torch.float64 and got.tolist() == [1.5, 2.25, 3.0]
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            rank=0, world_size=1)
    try:
        mesh = port_mesh.Mesh(0, 1, torch.device("cpu"), dist.group.WORLD)
        assert port_mesh.all_reduce_sums(values, mesh).tolist() == [
            1.5, 2.25, 3.0]
    finally:
        dist.destroy_process_group()


def test_shard_batch_takes_strided_rows_and_refuses_a_ragged_batch():
    mesh = port_mesh.Mesh(1, 2, torch.device("cpu"))
    batch = {"lr": np.arange(6), "path": list("abcdef")}
    got = port_mesh.shard_batch(batch, mesh)
    assert got["lr"].tolist() == [1, 3, 5] and got["path"] == ["b", "d", "f"]
    with pytest.raises(ValueError, match="does not split over 2 ranks"):
        port_mesh.shard_batch({"lr": np.arange(5)}, mesh)
    one = port_mesh.Mesh(0, 1, torch.device("cpu"))
    assert port_mesh.shard_batch(batch, one) is batch


def test_flat_collectives_run_over_buckets_of_one_dtype(monkeypatch):
    """The gradient all-reduce and the broadcast move a few flat buffers:
    runs of one dtype of at most BUCKET_BYTES (a larger tensor alone), each
    result copied back into its tensor."""
    monkeypatch.setattr(port_mesh, "BUCKET_BYTES", 64)
    tensors = [torch.arange(10.0), torch.arange(6.0),
               torch.ones(3, dtype=torch.float64),
               torch.arange(30.0).reshape(5, 6),
               torch.arange(2, dtype=torch.int64)]
    runs = port_mesh._buckets(tensors)
    # 40 + 24 bytes of float32; the float64; 120 bytes alone; the int64
    assert [len(r) for r in runs] == [2, 1, 1, 1]
    for run in runs:
        assert len({t.dtype for t in run}) == 1
        size = sum(t.numel() * t.element_size() for t in run)
        assert size <= 64 or len(run) == 1
    assert [t for r in runs for t in r] == tensors
    want = [t * 2 for t in tensors]
    port_mesh._flat_collective(tensors, lambda flat: flat.mul_(2))
    for got, expect in zip(tensors, want):
        assert torch.equal(got, expect)
