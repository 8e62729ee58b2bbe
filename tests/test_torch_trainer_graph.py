"""The train step replayed from a CUDA graph (``train/trainer.py``).

On a card without a data mesh the first step of a key runs eagerly, the
second captures the step and replays it, the later ones replay it.  The
card tests (marked ``gpu``; they skip where no CUDA device is present) hold
a graphed trainer to an eager one from the same weights, batches and
penalty weights over six steps, through ``set_lr``, ``load_checkpoint`` and
a batch of another size; the CPU tests hold the CPU and the data mesh to
the eager step, and the graph's key and drop points.  This file imports
neither JAX nor the JAX package, so on a machine without them run it as

    python -m pytest --noconftest -m gpu tests/test_torch_trainer_graph.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from sradsgan_tpu_torch.models import config_for_model  # noqa: E402
from sradsgan_tpu_torch.parallel.mesh import Mesh  # noqa: E402
from sradsgan_tpu_torch.train.state import get_lr, set_lr  # noqa: E402
from sradsgan_tpu_torch.train.trainer import Trainer, _graphable  # noqa: E402
from sradsgan_tpu_torch.utils.spans import recording  # noqa: E402

# small widths of three kinds of step: WGAN-GP through the six kernels,
# lsgan with a BatchNorm G, the pixel loss alone
MODELS = {"sradsgan": dict(base_filters=16, n_groups=1, n_blocks=1),
          "srgan": dict(base_filters=8, num_residuals=1),
          "edsr": dict(base_filters=8, num_residuals=1)}
# the rest of the registry, each the way its recipe trains
OTHERS = {"drcan": dict(n_feats=8, n_resgroups=1, n_resblocks=1),
          "dssr": dict(n_feats=8, n_groups=1, n_blocks=1),
          "sragan": dict(base_filters=16, n_groups=1, n_blocks=2,
                         rab_tail="fused"),
          "ndsrgan": dict(nf=8, nc=4, n_dcrdb=1),
          "amssrn": dict(n_feats=8, n_blocks=1),
          "hat": dict(embed_dim=12, depths=(2,), num_heads=(2,),
                      window_size=4)}
# HAT with the published model's options (the exact GELU, a conv per
# upsample stage) and MLP ratio, at small widths
PUBLISHED_HAT = dict(OTHERS["hat"], mlp_ratio=2.0, gelu="exact",
                     share_upsample=False)
STEPS = 6
ALPHA_SEED = 11


def _trainer(model, tmp_path, device="cpu", bf16=False, tag="",
             model_kwargs=None, **fields):
    cfg = config_for_model(model, 2, bf16=bf16,
                           model_kwargs=model_kwargs
                           or {**MODELS, **OTHERS}[model],
                           save_dir=str(tmp_path / f"{model}{tag}"),
                           **fields)
    return Trainer(cfg, device=device)


def _batches(n, batch=4, lr_size=16, seed=0):
    rng = np.random.default_rng(seed)
    return [{"lr": rng.random((batch, lr_size, lr_size, 3),
                              dtype=np.float32),
             "hr": rng.random((batch, 2 * lr_size, 2 * lr_size, 3),
                              dtype=np.float32)} for _ in range(n)]


def _rel(got, want) -> float:
    return float((got - want).abs().max()) / max(
        float(want.abs().max()), 1e-12)


def _nets(trainer):
    return [(name, net) for name, net in (("g", trainer.generator),
                                          ("d", trainer.discriminator))
            if net is not None]


def _zero_by_math(net) -> set:
    """Biases whose gradient is zero in exact arithmetic, so rounding
    noise alone, which Adam turns into steps of about lr: a conv's before a
    BatchNorm, and an SGAM key conv's (the softmax removes it)."""
    names = {n for n, _ in net.named_parameters()
             if n.endswith("key_conv.bias")}
    layers = list(net.named_modules())
    for (name, m), (_, nxt) in zip(layers, layers[1:]):
        if (isinstance(m, torch.nn.Conv2d) and m.bias is not None
                and isinstance(nxt, torch.nn.BatchNorm2d)):
            names.add(f"{name}.bias")
    return names


def _gaps(got, want) -> dict:
    """The largest gap of each kind of state between two trainers:
    ``param`` and ``grad`` max|difference| over max|want| a tensor, the
    biases zero by the math left out; ``noise`` their max|difference|;
    ``mean`` the running means' max|difference| (a mean takes the noise of
    the bias before it); ``var`` the running variances' relative gap."""
    out = dict.fromkeys(("param", "grad", "noise", "mean", "var"), 0.0)
    for (_, g_net), (_, w_net) in zip(_nets(got), _nets(want)):
        zero = _zero_by_math(w_net)
        w_params = dict(w_net.named_parameters())
        for n, p in g_net.named_parameters():
            w = w_params[n]
            if n in zero:
                out["noise"] = max(out["noise"], float(
                    (p.detach() - w.detach()).abs().max()))
                continue
            out["param"] = max(out["param"], _rel(p.detach(), w.detach()))
            if p.grad is not None:
                out["grad"] = max(out["grad"], _rel(p.grad, w.grad))
        w_bufs = dict(w_net.named_buffers())
        for n, b in g_net.named_buffers():
            if n.endswith("running_mean"):
                out["mean"] = max(out["mean"],
                                  float((b - w_bufs[n]).abs().max()))
            elif n.endswith("running_var"):
                out["var"] = max(out["var"], _rel(b, w_bufs[n]))
    return out


def _loss_gap(got, want) -> float:
    """The losses' largest |difference| over max(|want|, 1e-3)."""
    return max(float((got[k].double() - v.double()).abs()) / max(
        abs(float(v)), 1e-3) for k, v in want.items())


# The largest gaps a graphed trainer may read against an eager one after
# its steps (``_loss_gap``, ``_gaps``): the card tests take cuDNN's
# deterministic algorithms (the ``cuda`` fixture), without which two eager
# float32 trainers drift apart as far as a graphed one does (cuDNN's
# float32 weight gradients are not bit-reproducible, and Adam turns their
# rounding into steps of about lr where a gradient is near zero).  With
# them both precisions read 0: the bounds leave room for a reordered sum.
# The biases zero by the math and the running means after them are held to
# the steps' worst, 2 * lr a step.
TOL = {False: {"loss": 1e-6, "param": 1e-6, "grad": 1e-6, "var": 1e-6},
       True: {"loss": 1e-5, "param": 1e-5, "grad": 1e-5, "var": 1e-5}}


def _step_both(graphed, eager, batches, gens, bf16, where):
    for i, batch in enumerate(batches):
        got = graphed.train_step(batch, gens[0])
        want = eager.train_step(batch, gens[1])
        assert set(got) == set(want)
        assert _loss_gap(got, want) <= TOL[bf16]["loss"], (where, i)
    gaps, tol = _gaps(graphed, eager), TOL[bf16]
    for kind in ("param", "grad", "var"):
        assert gaps[kind] <= tol[kind], (where, kind, gaps)
    noise = 2.02 * graphed.step * graphed.cfg.optim.lr + 1e-7
    assert gaps["noise"] <= noise and gaps["mean"] <= noise, (where, gaps)


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # full float32 in the convs, which cuDNN would run in TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    # a reproducible eager step to hold the graph to (TOL)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    return torch.device("cuda")


def _pair(model, tmp_path, cuda, bf16, **fields):
    """A graphed trainer and an eager one (``graphed`` off after it was
    built; its Adams capturable all the same, so both take the same
    update)."""
    graphed = _trainer(model, tmp_path, cuda, bf16, "_graphed", **fields)
    eager = _trainer(model, tmp_path, cuda, bf16, "_eager", **fields)
    eager.graphed = False
    gens = [torch.Generator().manual_seed(ALPHA_SEED) for _ in range(2)]
    return graphed, eager, gens


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "mixed"])
@pytest.mark.parametrize("model", list(MODELS))
def test_a_graphed_step_follows_the_eager_one(cuda, tmp_path, model, bf16):
    graphed, eager, gens = _pair(model, tmp_path, cuda, bf16)
    _step_both(graphed, eager, _batches(STEPS), gens, bf16, "steps")
    assert graphed.graph_stats == {"eager": 1, "captured": 1,
                                   "replayed": STEPS - 2}
    assert eager.graph_stats == {"eager": STEPS, "captured": 0,
                                 "replayed": 0}
    assert graphed.step == eager.step == STEPS
    # the returned losses are copies: the next replay leaves them alone
    held = graphed.train_step(_batches(1, seed=1)[0], gens[0])
    kept = {k: v.clone() for k, v in held.items()}
    graphed.train_step(_batches(1, seed=2)[0], gens[0])
    assert all(torch.equal(held[k], kept[k]) for k in kept)


@pytest.mark.gpu
@pytest.mark.parametrize("model", list(OTHERS) + ["relativistic"])
def test_every_registry_step_replays(cuda, tmp_path, model):
    """The rest of the registry, and SRADSGAN's step with the relativistic
    losses: captured, replayed, on the eager trajectory."""
    fields = {}
    if model == "relativistic":
        model, fields = "sradsgan", {"gan.relativistic": True}
    graphed, eager, gens = _pair(model, tmp_path, cuda, False, **fields)
    _step_both(graphed, eager, _batches(4), gens, False, model)
    assert graphed.graph_stats == {"eager": 1, "captured": 1, "replayed": 2}


@pytest.mark.gpu
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "mixed"])
def test_the_published_hat_step_replays(cuda, tmp_path, bf16):
    """HAT with the published options, as the benchmark's HAT cell trains
    it: captured, replayed, on the eager trajectory, in float32 and mixed
    precision."""
    graphed, eager, gens = _pair("hat", tmp_path, cuda, bf16,
                                 model_kwargs=PUBLISHED_HAT)
    _step_both(graphed, eager, _batches(STEPS), gens, bf16, "published")
    assert graphed.graph_stats == {"eager": 1, "captured": 1,
                                   "replayed": STEPS - 2}
    assert graphed.generator.upsample.upsampling.share_stages is False


@pytest.mark.gpu
@pytest.mark.parametrize("model", ["sradsgan", "srgan"])
def test_set_lr_and_load_checkpoint_capture_anew(cuda, tmp_path, model):
    graphed, eager, gens = _pair(model, tmp_path, cuda, False)
    batches = _batches(3 * STEPS)
    _step_both(graphed, eager, batches[:STEPS], gens, False, "start")
    for t in (graphed, eager):
        for opt in (t.g_opt, t.d_opt):
            if opt is not None:
                set_lr(opt, get_lr(opt) * 0.5)
    _step_both(graphed, eager, batches[STEPS:2 * STEPS], gens, False,
               "set_lr")
    assert graphed.graph_stats == {"eager": 2, "captured": 2,
                                   "replayed": 2 * STEPS - 4}
    path = eager.save_checkpoint(0, include_optimizer=True)
    graphed.load_checkpoint(path)
    assert graphed.g_opt.param_groups[0]["capturable"]
    _step_both(graphed, eager, batches[2 * STEPS:], gens, False,
               "load_checkpoint")
    assert graphed.graph_stats == {"eager": 3, "captured": 3,
                                   "replayed": 3 * STEPS - 6}


@pytest.mark.gpu
def test_a_batch_of_another_size_steps_eagerly(cuda, tmp_path):
    graphed, eager, gens = _pair("sradsgan", tmp_path, cuda, False)
    full, small = _batches(3), _batches(1, batch=2, seed=5)
    _step_both(graphed, eager, full, gens, False, "full")
    _step_both(graphed, eager, small, gens, False, "small")
    assert graphed.graph_stats == {"eager": 2, "captured": 1, "replayed": 1}
    # back to the first size: eager again (the graph went with the new key)
    _step_both(graphed, eager, _batches(2, seed=6), gens, False, "back")
    assert graphed.graph_stats == {"eager": 3, "captured": 2, "replayed": 1}


@pytest.mark.gpu
def test_a_replayed_step_records_only_its_replay(cuda, tmp_path):
    graphed, _, gens = _pair("sradsgan", tmp_path, cuda, False)
    steps = []
    for batch in _batches(3):
        with recording() as records:
            graphed.train_step(batch, gens[0])
        steps.append([(s.name, records[s.parent].name if s.parent >= 0
                       else None) for s in records])
    inner = {"train.g_forward", "train.vgg", "train.g_backward",
             "train.g_optim", "train.d_forward", "train.penalty",
             "train.d_backward", "train.d_optim"}
    assert {n for n, _ in steps[0]} == inner | {"train.step"}
    capture = dict(steps[1])
    assert {n for n, _ in steps[1]} == inner | {"train.step",
                                               "train.capture",
                                               "train.replay"}
    assert capture["train.g_forward"] == "train.capture"
    assert capture["train.replay"] == "train.step"
    assert steps[2] == [("train.step", None), ("train.replay", "train.step")]


# --- the CPU: every step eager -------------------------------------------


@pytest.mark.parametrize("model", list(MODELS))
def test_the_cpu_step_never_builds_a_graph(tmp_path, model):
    """Six steps, a new lr, a checkpoint reload and a batch of another
    size on the CPU: every step eager, no graph, Adam not capturable."""
    trainer = _trainer(model, tmp_path)
    for batch in _batches(3, lr_size=8):
        trainer.train_step(batch)
    set_lr(trainer.g_opt, 1e-5)
    trainer.train_step(_batches(1, lr_size=8)[0])
    trainer.load_checkpoint(trainer.save_checkpoint(0,
                                                    include_optimizer=True))
    trainer.train_step(_batches(1, lr_size=8)[0])
    trainer.train_step(_batches(1, batch=2, lr_size=8)[0])
    assert trainer.graph_stats == {"eager": 6, "captured": 0, "replayed": 0}
    assert trainer._graph is None and trainer._warm_key is None
    assert not trainer.graphed
    for opt in (trainer.g_opt, trainer.d_opt):
        if opt is not None:
            assert not opt.param_groups[0]["capturable"]


@pytest.mark.parametrize("world, group, graphed", [
    (1, False, True), (1, True, False), (2, True, False)],
    ids=["one_process", "group_of_one", "two_ranks"])
def test_only_a_card_without_a_group_graphs(tmp_path, world, group,
                                            graphed):
    """The decision alone, for a CUDA device's mesh: a world of one without
    a group graphs, any process group steps eagerly (its collectives stay
    outside a graph); the CPU never graphs, and a CPU trainer's decision,
    made once, is off."""
    cpu = torch.device("cpu")
    assert not _graphable(cpu, Mesh(0, world, cpu, object() if group
                                    else None))
    assert not _trainer("sradsgan", tmp_path).graphed
    cuda = torch.device("cuda", 0)
    assert _graphable(cuda, Mesh(0, world, cuda, object() if group
                                 else None)) is graphed


def test_the_key_is_the_shapes_dtypes_and_lrs(tmp_path):
    trainer = _trainer("sradsgan", tmp_path)
    lr, hr = torch.zeros(4, 3, 8, 8), torch.zeros(4, 3, 16, 16)
    assert trainer._graph_key(lr, hr) is None  # the CPU
    trainer.graphed = True
    key = trainer._graph_key(lr, hr)
    assert key == trainer._graph_key(lr.clone(), hr.clone())
    assert key != trainer._graph_key(lr[:2], hr[:2])
    assert key != trainer._graph_key(lr.double(), hr.double())
    set_lr(trainer.d_opt, 1e-5)
    assert key != trainer._graph_key(lr, hr)


def test_a_reload_or_chain_init_drops_the_graph(tmp_path):
    trainer = _trainer("sradsgan", tmp_path)
    trainer.train_step(_batches(1, lr_size=8)[0])
    path = trainer.save_checkpoint(0)
    for reload in (trainer.load_checkpoint, trainer._chain_init):
        trainer._graph, trainer._warm_key = object(), ("key",)
        reload(path)
        assert trainer._graph is None and trainer._warm_key is None


def test_a_capturable_state_loads_on_the_cpu(tmp_path):
    """An optimizer state saved by a graphed trainer (capturable, its step
    count on the card) resumes on the CPU as the CPU's Adam, and the
    trajectory matches one that never saved."""
    batches = _batches(3, lr_size=8)
    ref = _trainer("srgan", tmp_path, tag="_ref")
    trainer = _trainer("srgan", tmp_path)
    for t in (ref, trainer):
        t.train_step(batches[0])
    path = trainer.save_checkpoint(0, include_optimizer=True)
    state = torch.load(path, weights_only=True)
    for key in ("g_opt", "d_opt"):
        for group in state[key]["param_groups"]:
            group["capturable"] = True
    torch.save(state, path)
    trainer.load_checkpoint(path)
    assert not trainer.g_opt.param_groups[0]["capturable"]
    for batch in batches[1:]:
        got, want = trainer.train_step(batch), ref.train_step(batch)
        for k, v in want.items():
            assert float(got[k]) == pytest.approx(float(v), rel=1e-6), k


def test_a_penalty_draw_is_the_eager_steps(tmp_path):
    """Every step's penalty weights (one draw, on the CPU, for the eager,
    captured and replayed steps alike) are the generator's draws in order;
    a rank of a data mesh takes its rows of the global batch's draws; none
    without a penalty."""
    trainer = _trainer("sradsgan", tmp_path)
    gens = [torch.Generator().manual_seed(ALPHA_SEED) for _ in range(2)]
    for _ in range(3):
        want = torch.rand((4, 1, 1, 1), generator=gens[1])
        assert torch.equal(trainer._penalty_draw(4, gens[0]), want)
    cpu = torch.device("cpu")
    for rank in (0, 1):
        trainer.mesh = Mesh(rank, 2, cpu, None)
        draws = [torch.Generator().manual_seed(ALPHA_SEED) for _ in range(2)]
        want = torch.rand((8, 1, 1, 1), generator=draws[1])[rank::2]
        assert torch.equal(trainer._penalty_draw(4, draws[0]), want)
    for model in ("srgan", "edsr"):
        other = _trainer(model, tmp_path)
        assert other._penalty_draw(4, gens[0]) is None
