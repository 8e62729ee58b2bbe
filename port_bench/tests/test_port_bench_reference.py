"""The plain reference against the program's plain path (its CPU
versions of the six ops) at tiny widths, on the same weights and batch:
the generators', the D's and VGG19's forwards, the step's losses and
gradients, and a served request through the bucket pad and crop.  The test
may import the program; the reference may not."""

import numpy as np
import pytest
import torch

from port_bench import compare, train
from port_bench.reference import models
from port_bench.reference.step import ReferenceStep, serve
from port_bench.weights import make_weights

SEED = 2_147_483_659
WIDTHS = {"sradsgan": {"base_filters": 16, "n_groups": 2, "n_blocks": 2},
          "sragan": {"base_filters": 16, "n_groups": 2, "n_blocks": 2}}
RECIPE = {"gan": "wgan-gp", "pixel": "l1", "weight_pixel": 1.0,
          "weight_content": 0.01, "weight_gan": 0.001, "lambda_gp": 10.0,
          "penalty_weight": "lambda + 1", "clip": 0.01, "lr": 2e-4,
          "betas": [0.9, 0.999], "eps": 1e-8}


def config(model):
    return {"model": model, "scale": 4, "widths": WIDTHS[model],
            "recipe": RECIPE,
            "precision": {"train_bf16": False, "serve_dtype": "float32"}}


def before_batch_norm(net):
    """The biases of the convolutions that a BatchNorm follows."""
    out = set()
    for prefix, m in net.named_modules():
        kids = list(m.named_children())
        for (name, a), (_, b) in zip(kids, kids[1:]):
            if (isinstance(b, torch.nn.BatchNorm2d)
                    and getattr(a, "bias", None) is not None):
                out.add(f"{prefix}.{name}.bias".lstrip("."))
    return out


def close(a, b, rel):
    a, b = np.asarray(a), np.asarray(b)
    return np.abs(a - b).max() <= rel * np.abs(b).max()


@pytest.mark.parametrize("model", ["sradsgan", "sragan"])
def test_forwards_match_the_program(model):
    from sradsgan_tpu_torch.losses.vgg import VGG19Features
    from sradsgan_tpu_torch.models import create_discriminator
    from sradsgan_tpu_torch.models import create_generator

    torch.manual_seed(0)
    w = train.reference_weights(config(model), SEED, "cpu")
    pairs = [(create_generator(model, 4, **WIDTHS[model]),
              models.build(model, "cpu", **WIDTHS[model]), "g",
              torch.rand(2, 3, 12, 12)),
             (create_discriminator(model),
              models.build("discriminator", "cpu"), "d",
              torch.rand(2, 3, 48, 48)),
             (VGG19Features(), models.build("vgg", "cpu"), "vgg",
              torch.rand(2, 3, 48, 48))]
    for program, reference, key, x in pairs:
        program.load_state_dict(w[key])
        reference.load_state_dict(w[key])
        with torch.no_grad():
            assert close(program.train()(x), reference.train()(x), 1e-5), key
            assert close(program.eval()(x), reference.eval()(x), 1e-5), key


@pytest.mark.parametrize("model", ["sradsgan", "sragan"])
def test_step_matches_the_program(model):
    cfg = config(model)
    mix = {"batch": 4, "lr_size": 8, "workers": 1}
    w = train.reference_weights(cfg, SEED, "cpu")
    trainer = train.program_trainer(cfg, mix, w, "cpu", "/nonexistent")
    g = torch.Generator().manual_seed(5)
    lr, hr = torch.rand(4, 3, 8, 8, generator=g), torch.rand(4, 3, 32, 32,
                                                             generator=g)
    alpha_gen = torch.Generator().manual_seed(9)
    out = trainer.train_step({"lr": lr, "hr": hr}, alpha_gen)
    ref = ReferenceStep(cfg, w, "cpu")
    r = ref.step(lr, hr, torch.rand((4, 1, 1, 1),
                                    generator=torch.Generator().manual_seed(9)))
    for k in compare.LOSS_KEYS:
        assert float(out[k]) == pytest.approx(r["losses"][k], rel=1e-5), k
    for key, net in (("g", trainer.generator), ("d", trainer.discriminator)):
        grads = r["grads"][key]
        scale = float(np.median([float(t.norm()) for t in grads.values()]))
        moved = ref.params()[key]
        skip = before_batch_norm(net)
        for n, p in net.named_parameters():
            if n in skip:
                continue  # its gradient is round-off: a BN follows it
            norm = float(grads[n].norm())
            gap = float((p.grad - grads[n]).norm())
            assert gap <= 1e-4 * max(norm, scale), n
            # Adam moves each element by about lr * sign(g): compare the
            # leaf's step, not elements whose tiny gradient may flip
            step_p = float((p.detach() - w[key][n]).norm())
            step_r = float((moved[n].detach() - w[key][n]).norm())
            assert step_p == pytest.approx(step_r, rel=2e-2, abs=1e-7), n
    trainer.logger.close()


def test_served_request_matches_the_predictor():
    from sradsgan_tpu_torch.models import create_generator
    from sradsgan_tpu_torch.serving import Predictor

    g = models.build("sradsgan", "cpu", **WIDTHS["sradsgan"])
    w = make_weights(g, SEED, "generator")
    g.load_state_dict(w)
    program = create_generator("sradsgan", 4, **WIDTHS["sradsgan"])
    program.load_state_dict(w)
    predictor = Predictor(program, 4, buckets=(8, 12, 16), device="cpu")
    rng = np.random.default_rng(1)
    for shape in ((3, 8, 8, 3), (1, 9, 14, 3), (1, 5, 6, 3)):
        lr = rng.random(shape, dtype=np.float32)
        want = serve(g.eval(), lr, (8, 12, 16), 4, "cpu")
        got = predictor(lr)
        assert got.shape == want.shape == (shape[0], 4 * shape[1],
                                           4 * shape[2], 3)
        assert close(got, want, 1e-5)


def test_reference_imports_nothing_of_the_program():
    import subprocess
    import sys

    code = ("import sys; import port_bench.reference.models, "
            "port_bench.reference.step; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         cwd=str(__import__('pathlib').Path(
                             __file__).resolve().parents[2])).stdout
    top = set(eval(out))
    assert not top & {"sradsgan_tpu_torch", "sradsgan_tpu", "jax", "jaxlib",
                      "flax"}
