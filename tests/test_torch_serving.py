"""The port's serving path against the JAX package's, and the port's
boundaries: no JAX or PIL at import, no silent CPU, no silent fallback, and
gradients through every kernel op."""

import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxGenerator)
from sradsgan_tpu.serving import Predictor as JaxPredictor  # noqa: E402
from sradsgan_tpu_torch.models import create_generator  # noqa: E402
from sradsgan_tpu_torch.ops import pooling, sgam_flash, spatial_gate  # noqa
from sradsgan_tpu_torch.serving import Predictor  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import sradsgan_state_dict  # noqa

REPO = Path(__file__).resolve().parent.parent
SCALE = 4
SMALL = dict(base_filters=16, n_groups=2, n_blocks=2)


@pytest.fixture(scope="module")
def generators():
    gen = JaxGenerator(scale=SCALE, **SMALL)
    params = jax.tree.map(np.asarray, gen.init(
        jax.random.PRNGKey(3), jnp.zeros((1, 12, 12, 3)))["params"])
    rng = np.random.default_rng(0)

    def draw(path, leaf):  # as in test_torch_sradsgan.py: order-one outputs
        name = path[-1].key
        if name == "gamma":
            return np.full(leaf.shape, 0.6, np.float32)
        std = (0.05 if name == "bias" else
               0.5 / np.sqrt(np.prod(leaf.shape[:-1])))
        return rng.normal(0, std, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map_with_path(draw, params)
    model = create_generator("sradsgan", SCALE, **SMALL)
    model.load_state_dict(sradsgan_state_dict(params))
    return gen, {"params": params}, model


@pytest.mark.parametrize("shape,kw", [
    ((2, 10, 9, 3), dict(buckets=(12,))),                   # bucket padding
    ((40, 40, 3), dict(buckets=(16,), tile=16, halo=4)),    # halo tiling
])
def test_predictor_matches_jax(generators, shape, kw):
    gen, variables, model = generators
    x = np.random.default_rng(1).random(shape).astype(np.float32)
    want = JaxPredictor(gen, variables, SCALE, **kw)(x)
    got = Predictor(model, SCALE, device="cpu", **kw)(x)
    assert got.shape == want.shape
    assert got.shape[-3:-1] == (shape[-3] * SCALE, shape[-2] * SCALE)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=3e-5)


def test_predictor_defaults_to_cuda_and_says_so(generators):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default is usable")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        Predictor(generators[2], SCALE)


def test_port_imports_no_jax_flax_or_pil(tmp_path):
    """Importing the port (the zoo's seven model modules too) and
    chip_smoke, and running the evaluation commands that the card's machine
    runs (no Pillow, no matplotlib there): ``validate-by-class`` and
    ``train`` with its final table, both with LPIPS, ``train --model
    sragan``, on the synthetic set at tiny sizes, ``export`` of a tiny
    HAT read back by ``serving.load_exported``, and ``diffusion-train``
    with the diffusion modules, the data mesh and the ranks' worker of the
    data-parallel checks, the reference and torchvision weight readers, the
    report and wandb utilities, the block library (spectral norm,
    ESRGAN nets, extractors, AA-conv, the extra losses), the degradation
    and kernel ops, and the data variants and offline tools (their PIL,
    scipy, matplotlib and lmdb imports are inside the calls: importing the
    port imports no scipy)."""
    tiny = json.dumps({"base_filters": 16, "n_groups": 1, "n_blocks": 1})
    flags = ["--device", "cpu", "--data", "synthetic", "--scale", "2",
             "--crop-size", "32", "--lpips", "--save-dir", str(tmp_path),
             "--model-kwargs", tiny]
    sragan = json.dumps({"base_filters": 16, "n_groups": 1, "n_blocks": 2})
    commands = [["validate-by-class"] + flags,
                ["train", "--steps", "1", "--batch-size", "2", "--no-bf16"]
                + flags,
                ["train", "--model", "sragan", "--steps", "1",
                 "--batch-size", "2", "--no-bf16", "--no-final-eval"]
                + flags[:-1] + [sragan],
                ["export", "--model", "hat", "--device", "cpu", "--scale",
                 "2", "--lr-size", "8", "--out", str(tmp_path / "hat.pt2"),
                 "--model-kwargs", json.dumps(
                     {"embed_dim": 12, "depths": [1], "num_heads": [2],
                      "window_size": 4})],
                ["diffusion-train", "--device", "cpu", "--data",
                 "synthetic", "--scale", "2", "--crop-size", "16",
                 "--batch-size", "2", "--n-iter", "1", "--timesteps", "4",
                 "--no-bf16", "--save-dir", str(tmp_path), "--unet-kwargs",
                 json.dumps({"inner_channel": 32, "channel_mults": [1, 2],
                             "res_blocks": 1})]]
    code = ("import json, sys\n"
            "import sradsgan_tpu_torch, sradsgan_tpu_torch.serving\n"
            "import sradsgan_tpu_torch.cli, sradsgan_tpu_torch.models\n"
            "import sradsgan_tpu_torch.tools.from_jax, chip_smoke\n"
            "import sradsgan_tpu_torch.train.trainer\n"
            "import sradsgan_tpu_torch.train.state\n"
            "import sradsgan_tpu_torch.losses.gan\n"
            "import sradsgan_tpu_torch.models.discriminators\n"
            "import sradsgan_tpu_torch.tools.profile_train\n"
            "import sradsgan_tpu_torch.tools.profile_serving\n"
            "import sradsgan_tpu_torch.ops.rab_tail\n"
            "import sradsgan_tpu_torch.ops.resize\n"
            "import sradsgan_tpu_torch.config\n"
            "import sradsgan_tpu_torch.data.datasets\n"
            "import sradsgan_tpu_torch.data.loader\n"
            "import sradsgan_tpu_torch.metrics.fidelity\n"
            "import sradsgan_tpu_torch.utils.logging\n"
            "import sradsgan_tpu_torch.evaluation.validate\n"
            "import sradsgan_tpu_torch.losses.lpips\n"
            "import sradsgan_tpu_torch.utils.plotting\n"
            "import sradsgan_tpu_torch.models.edsr\n"
            "import sradsgan_tpu_torch.models.srgan\n"
            "import sradsgan_tpu_torch.models.drcan\n"
            "import sradsgan_tpu_torch.models.dssr\n"
            "import sradsgan_tpu_torch.models.sragan\n"
            "import sradsgan_tpu_torch.models.ndsrgan\n"
            "import sradsgan_tpu_torch.models.amssrn\n"
            "import sradsgan_tpu_torch.models.hat\n"
            "import sradsgan_tpu_torch.diffusion.gaussian\n"
            "import sradsgan_tpu_torch.diffusion.unet\n"
            "import sradsgan_tpu_torch.diffusion.config\n"
            "import sradsgan_tpu_torch.diffusion.trainer\n"
            "import sradsgan_tpu_torch.parallel.mesh\n"
            "import sradsgan_tpu_torch.tools.dp_check\n"
            "import sradsgan_tpu_torch.tools.from_reference\n"
            "import sradsgan_tpu_torch.tools.convert_torch\n"
            "import sradsgan_tpu_torch.utils.report\n"
            "import sradsgan_tpu_torch.utils.wandb_logger\n"
            "import sradsgan_tpu_torch.nn.attention\n"
            "import sradsgan_tpu_torch.nn.spectral_norm\n"
            "import sradsgan_tpu_torch.nn.esrgan\n"
            "import sradsgan_tpu_torch.nn.extractors\n"
            "import sradsgan_tpu_torch.nn.augmented_conv\n"
            "import sradsgan_tpu_torch.losses.extra\n"
            "import sradsgan_tpu_torch.ops.degrade\n"
            "import sradsgan_tpu_torch.ops.kernel_ops\n"
            "import sradsgan_tpu_torch.tools.prepare_data\n"
            "import sradsgan_tpu_torch.tools.scene_classification\n"
            "import sradsgan_tpu_torch.tools.dryrun\n"
            "from sradsgan_tpu_torch.data.datasets import (\n"
            "    AugmentedCropDataset, BlurDegradedDataset,\n"
            "    LMDBTripletDataset, NoisyDataset, TripletFolderDataset)\n"
            "assert 'scipy' not in sys.modules and 'lmdb' not in sys.modules\n"
            f"for argv in {commands!r}:\n"
            "    assert sradsgan_tpu_torch.cli.main(argv) == 0\n"
            "import numpy as np\n"
            "from sradsgan_tpu_torch.serving import load_exported\n"
            f"run = load_exported({str(tmp_path / 'hat.pt2')!r})\n"
            "assert run(np.zeros((1, 8, 8, 3))).shape == (1, 16, 16, 3)\n"
            "from sradsgan_tpu_torch.data.datasets import SyntheticDataset\n"
            "SyntheticDataset(2, 4, 16).load(0)\n"
            "print(json.dumps({m: m in sys.modules\n"
            "                  for m in ('jax', 'flax', 'PIL',\n"
            "                            'matplotlib', 'lmdb',\n"
            "                            'sradsgan_tpu')}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert json.loads(out.stdout.strip().splitlines()[-1]) == {
        "jax": False, "flax": False, "PIL": False, "matplotlib": False,
        "lmdb": False, "sradsgan_tpu": False}


def _kernel_args():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(0, 1, (2, 8, 9, 9)).astype(np.float32))
    w = torch.from_numpy(rng.normal(0, 1, (1, 2, 7, 7)).astype(np.float32))
    q = torch.from_numpy(rng.normal(0, 1, (2, 30, 8)).astype(np.float32))
    v = torch.from_numpy(rng.normal(0, 1, (2, 30, 64)).astype(np.float32))
    return {"pool": (pooling, "avg_max_pool", (x,)),
            "gate": (spatial_gate, "spatial_gate", (x, w)),
            "attention": (sgam_flash, "position_attention", (q, q, v))}


def _backward_kernel_args():
    (_, _, (x, w)), (_, _, (q, _, v)) = (_kernel_args()[k]
                                         for k in ("gate", "attention"))
    lse = torch.zeros(q.shape[:2])
    return {"gate_bwd": (spatial_gate.spatial_gate_bwd_cuda, (x, w, x)),
            "attention_bwd": (sgam_flash.position_attention_bwd_cuda,
                              (q, q, v, v, v, lse))}


@pytest.mark.parametrize("op", ["gate_bwd", "attention_bwd"])
def test_backward_kernel_wrapper_refuses_a_cpu_tensor(op):
    fn, args = _backward_kernel_args()[op]
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        fn(*args)
    assert fn.launches == 0


def test_build_without_nvcc_raises(tmp_path, monkeypatch):
    """No toolkit, or a toolkit without nvcc: the build raises; nothing
    falls back to the plain versions."""
    from torch.utils import cpp_extension

    from sradsgan_tpu_torch.ops import _build
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="need nvcc"):
        _build.build(tmp_path / "a")
    monkeypatch.setattr(cpp_extension, "CUDA_HOME", str(tmp_path))
    with pytest.raises(FileNotFoundError):
        _build.build(tmp_path / "b")
    assert not (tmp_path / "b" / _build.LIB_NAME).exists()


@pytest.mark.parametrize("op", ["pool", "gate", "attention"])
def test_kernel_wrapper_refuses_a_cpu_tensor(op):
    module, name, args = _kernel_args()[op]
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        getattr(module, f"{name}_cuda")(*args)
    assert getattr(module, f"{name}_cuda").launches == 0


@pytest.mark.parametrize("op", ["pool", "gate", "attention"])
def test_kernel_op_refuses_to_be_differentiated(op):
    """The ops no longer refuse autograd: gradients flow into every input
    through their ``autograd.Function``s, and under no-grad the forward
    alone runs."""
    module, name, args = _kernel_args()[op]
    fn = getattr(module, name)
    grad_args = [a.clone().requires_grad_() for a in args]
    out = fn(*grad_args)
    outs = out if isinstance(out, tuple) else (out,)
    grads = torch.autograd.grad([o.sum() for o in outs], grad_args)
    for a, g in zip(grad_args, grads):
        assert g.shape == a.shape and torch.isfinite(g).all()
        assert g.abs().max() > 0
    with torch.no_grad():
        again = fn(*grad_args)
    for o, a in zip(outs, again if isinstance(again, tuple) else (again,)):
        assert not a.requires_grad
        torch.testing.assert_close(a, o.detach(), rtol=0, atol=0)
