"""The exported model of the port (``serving.export_model`` /
``serving.load_exported``, ``cli export``) on the CPU.

- Round trips at tiny widths: the tiny flagship (two groups of two RABs)
  with its tails unfused and fused, HAT and EDSR, exported at batch 1 of
  12^2, loaded and run, equal to the eager generator within 1e-6 of
  max|ref| (the same plain versions on the same inputs).
- The flagship's graph holds the kernels as the registered ops, one node a
  launch as the module structure gives them (unfused: a pool and a gate for
  each of its local attentions and one position attention; fused: a RAB
  tail for each and one position attention), and none of their plain
  expansions: no channel or spatial mean, no sigmoid beyond the channel
  gates' own, no batched matmul or softmax beyond the CGAM's own.
- Each of the six registered ops passes ``torch.library.opcheck``'s
  schema, fake-implementation and traced-dispatch checks on CPU tensors
  (its plain version); ``tests/test_torch_gpu_kernels.py`` runs the same
  on the card.
- ``cli export`` writes an artifact that a fresh interpreter, importing the
  port alone, loads and runs.
- The JAX package's ``export_model`` on the same weights (through the
  bridge) and input gives the port artifact's output within 1e-5 of
  max|ref|.
"""

import collections
import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu import serving as jax_serving  # noqa: E402
from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxGenerator)
from sradsgan_tpu_torch.evaluation.tiled import forward_numpy  # noqa: E402
from sradsgan_tpu_torch.models import create_generator  # noqa: E402
from sradsgan_tpu_torch.nn.attention import (ChannelGate,  # noqa: E402
                                             LocalAttention)
from sradsgan_tpu_torch.serving import export_model, load_exported  # noqa
from sradsgan_tpu_torch.tools.from_jax import sradsgan_state_dict  # noqa

REPO = __import__("pathlib").Path(__file__).resolve().parent.parent
LR, SCALE = 12, 4
FLAGSHIP = dict(base_filters=16, n_groups=2, n_blocks=2)
MODELS = {
    "sradsgan": ("sradsgan", FLAGSHIP),
    "sradsgan_fused": ("sradsgan", dict(FLAGSHIP, rab_tail="fused")),
    "hat": ("hat", dict(embed_dim=12, depths=(2,), num_heads=(2,))),
    "edsr": ("edsr", dict(base_filters=16, num_residuals=2)),
}
OPS = ("avg_max_pool", "spatial_gate", "position_attention", "rab_tail")


def _generator(case):
    name, kwargs = MODELS[case]
    model = create_generator(name, SCALE, **kwargs).eval()
    with torch.no_grad():  # the attention gains away from their zero init
        for n, p in model.named_parameters():
            if n.rpartition(".")[2] == "gamma":
                p.fill_(0.5)
    return model


def _lr(batch=1, seed=0):
    return np.random.default_rng(seed).random((batch, LR, LR, 3),
                                              dtype=np.float32)


def _calls(program) -> collections.Counter:
    """call_function targets of the program's graph and its submodules'."""
    counts = collections.Counter()
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            counts.update(str(n.target) for n in module.graph.nodes
                          if n.op == "call_function")
    return counts


@pytest.mark.parametrize("case", MODELS)
def test_round_trip_matches_the_eager_generator(case, tmp_path):
    model = _generator(case)
    path = export_model(model, LR, str(tmp_path / f"{case}.pt2"),
                        device="cpu")
    x = _lr()
    got = load_exported(path)(x)
    want = forward_numpy(model, x, "cpu")
    assert got.shape == want.shape == (1, LR * SCALE, LR * SCALE, 3)
    assert np.abs(got - want).max() <= 1e-6 * np.abs(want).max()


@pytest.mark.parametrize("case", ["sradsgan", "sradsgan_fused"])
def test_flagship_graph_holds_the_registered_ops(case, tmp_path):
    model = _generator(case)
    path = export_model(model, LR, str(tmp_path / "m.pt2"), device="cpu")
    calls = _calls(torch.export.load(path))
    ops = {op: calls[f"sradsgan_tpu_torch.{op}.default"] for op in OPS}
    tails = sum(isinstance(m, LocalAttention) for m in model.modules())
    assert tails == FLAGSHIP["n_groups"] * (FLAGSHIP["n_blocks"] + 1)
    if case == "sradsgan":
        assert ops == {"avg_max_pool": tails, "spatial_gate": tails,
                       "position_attention": 1, "rab_tail": 0}
    else:
        assert ops == {"avg_max_pool": 0, "spatial_gate": 0,
                       "position_attention": 1, "rab_tail": tails}
    gates = sum(isinstance(m, ChannelGate) for m in model.modules())
    assert calls["aten.mean.dim"] == 0
    assert calls["aten.sigmoid.default"] == (gates if case == "sradsgan"
                                             else 0)
    assert calls["aten.bmm.default"] == 2  # the CGAM's energy and output
    assert calls["aten.softmax.int"] == 1


def test_cli_export_artifact_runs_in_a_fresh_interpreter(tmp_path):
    out = tmp_path / "m.pt2"
    kwargs = json.dumps(dict(FLAGSHIP, rab_tail="fused"))
    subprocess.run(
        [sys.executable, "-m", "sradsgan_tpu_torch.cli", "export",
         "--device", "cpu", "--scale", str(SCALE), "--lr-size", str(LR),
         "--out", str(out), "--model-kwargs", kwargs],
        cwd=REPO, check=True, capture_output=True, text=True, timeout=120)
    code = ("import json, sys, numpy as np\n"
            "from sradsgan_tpu_torch.serving import load_exported\n"
            f"sr = load_exported({str(out)!r})(np.full((1, {LR}, {LR}, 3),"
            " 0.5, np.float32))\n"
            "print(json.dumps({'shape': list(sr.shape),\n"
            "                  'finite': bool(np.isfinite(sr).all()),\n"
            "                  'jax': 'jax' in sys.modules,\n"
            "                  'sradsgan_tpu': 'sradsgan_tpu' in sys.modules"
            "}))\n")
    run = subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True,
                         capture_output=True, text=True, timeout=120)
    assert json.loads(run.stdout.strip().splitlines()[-1]) == {
        "shape": [1, LR * SCALE, LR * SCALE, 3], "finite": True,
        "jax": False, "sradsgan_tpu": False}


def test_port_artifact_matches_the_jax_artifact(tmp_path):
    """Both packages' ``export_model`` on the same flagship weights (fan-in
    scale, gains 0.6) and input."""
    from test_torch_sradsgan import random_params

    gen = JaxGenerator(scale=SCALE, base_filters=16, n_groups=2, n_blocks=2)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, LR, LR, 3)))["params"]
    params = random_params(shapes, seed=SCALE)
    jax_path = jax_serving.export_model(gen, {"params": params}, LR,
                                        str(tmp_path / "jax.bin"))
    model = create_generator("sradsgan", SCALE, **FLAGSHIP)
    model.load_state_dict(sradsgan_state_dict(params))
    path = export_model(model, LR, str(tmp_path / "port.pt2"), device="cpu")
    x = _lr(seed=4)
    want = np.asarray(jax_serving.load_exported(jax_path)(x))
    got = load_exported(path)(x)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _op_args(name):
    g = torch.Generator().manual_seed(0)

    def randn(*shape, std=1.0):
        return torch.randn(shape, generator=g) * std

    x, w = randn(2, 16, 9, 11), randn(1, 2, 7, 7, std=0.3)
    q, k, v = randn(2, 30, 8), randn(2, 30, 8), randn(2, 30, 64)
    return {
        "avg_max_pool": (x,), "spatial_gate": (x, w),
        "spatial_gate_bwd": (x, w, randn(*x.shape)),
        "position_attention": (q, k, v, True),
        "position_attention_bwd": (q, k, v, randn(*v.shape),
                                   randn(*v.shape), randn(2, 30)),
        "rab_tail": (x, randn(*x.shape), randn(16, 4, std=0.3),
                     randn(4, 16, std=0.3), w, randn(16, 16, std=0.25),
                     randn(16, std=0.05))}[name]


@pytest.mark.parametrize("name", ["avg_max_pool", "spatial_gate",
                                  "spatial_gate_bwd", "position_attention",
                                  "position_attention_bwd", "rab_tail"])
def test_registered_op_on_the_cpu(name):
    op = getattr(torch.ops.sradsgan_tpu_torch, name).default
    torch.library.opcheck(op, _op_args(name), test_utils=(
        "test_schema", "test_faketensor", "test_aot_dispatch_dynamic"))
