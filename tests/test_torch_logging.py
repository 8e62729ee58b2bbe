"""The port's run outputs against the JAX package's: the TensorBoard sinks
of ``utils/logging.py``, the figures of ``utils/plotting.py``, the cost
report of ``utils/report.py`` and the wandb shim.

The two ``Logger``s get the same calls; their event files, read back with
TensorBoard's ``EventAccumulator``, must hold the same scalars, the same
encoded images and the same histograms (a set of more than 100 000 values
subsampled alike).  ``tests/test_torch_epoch_loop.py`` holds the trainers'
tags and steps to each other.
"""

import glob
import os
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.models.sradsgan import (  # noqa: E402
    SRADSGANGenerator as JaxGenerator)
from sradsgan_tpu.utils import logging as jax_logging  # noqa: E402
from sradsgan_tpu.utils import plotting as jax_plotting  # noqa: E402
from sradsgan_tpu.utils import report as jax_report  # noqa: E402
from sradsgan_tpu_torch.models import create_generator  # noqa: E402
from sradsgan_tpu_torch.tools.from_jax import sradsgan_state_dict  # noqa
from sradsgan_tpu_torch.utils import logging as port_logging  # noqa: E402
from sradsgan_tpu_torch.utils import plotting, report  # noqa: E402
from sradsgan_tpu_torch.utils.wandb_logger import WandbLogger  # noqa: E402


def read_events(log_dir):
    """{kind: {tag: [(step, value), ...]}} of the event files in
    ``log_dir``: scalars as floats, images as their encoded bytes and
    size, histograms as their fields.  TensorBoard reads them through its
    stub of TensorFlow (importing TensorFlow would take seconds)."""
    sys.modules.setdefault("tensorboard.compat.notf",
                           types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_accumulator import (
        EventAccumulator)

    acc = EventAccumulator(log_dir, size_guidance={"scalars": 0,
                                                   "images": 0,
                                                   "histograms": 0})
    acc.Reload()
    tags = acc.Tags()
    out = {"scalars": {t: [(e.step, e.value) for e in acc.Scalars(t)]
                       for t in tags["scalars"]},
           "images": {t: [(e.step, e.width, e.height, e.encoded_image_string)
                          for e in acc.Images(t)] for t in tags["images"]},
           "histograms": {}}
    for t in tags["histograms"]:
        out["histograms"][t] = [
            (e.step, v.min, v.max, v.num, v.sum, v.sum_squares,
             tuple(v.bucket_limit), tuple(v.bucket))
            for e in acc.Histograms(t) for v in [e.histogram_value]]
    return out


def test_the_loggers_write_the_same_events(tmp_path):
    pytest.importorskip("tensorboardX")
    pytest.importorskip("tensorboard")
    rng = np.random.default_rng(0)
    images = [rng.random((8, 6, 3)) * 1.2 - 0.1 for _ in range(3)]
    values = [rng.normal(size=300_001), rng.normal(size=2_000)]
    loggers = {"jax": jax_logging.Logger("m", str(tmp_path / "jax")),
               "port": port_logging.Logger("m", str(tmp_path / "port"))}
    for logger in loggers.values():
        assert logger.writer is not None
        for step in (50, 100):
            logger.scalar_summary("loss_G", 0.25 + step / 1e3, step)
            logger.scalar_summary("loss_D", -1.5 / step, step)
        logger.image_summary("sample/sr_hr_bicubic", images, 100)
        logger.histo_summary("g_params", values[0], 7)
        logger.histo_summary("d_params", values[1], 7)
    loggers["jax"].writer.close()
    loggers["port"].close()
    assert loggers["port"].writer is None
    got, want = (read_events(str(tmp_path / side)) for side in ("port", "jax"))
    assert want["scalars"].keys() == {"loss_G", "loss_D"}
    assert want["images"].keys() == {f"sample/sr_hr_bicubic/{i}"
                                     for i in range(3)}
    assert want["histograms"]["g_params"][0][3] == 75_001  # every 4th
    assert got == want


def test_the_sinks_do_nothing_without_a_writer(tmp_path, monkeypatch):
    """``use_tensorboard=False``, and a machine where tensorboardX does not
    import: no writer, no file, no error."""
    monkeypatch.setitem(sys.modules, "tensorboardX", None)
    for logger in (port_logging.Logger("m", str(tmp_path / "a")),
                   port_logging.Logger("m", str(tmp_path / "b"),
                                       use_tensorboard=False)):
        assert logger.writer is None
        logger.scalar_summary("x", 1.0, 0)
        logger.image_summary("y", [np.zeros((4, 4, 3))], 0)
        logger.histo_summary("z", np.zeros(10), 0)
        logger.close()
    assert not os.path.exists(tmp_path / "a")


def test_image_summary_skips_without_pillow(tmp_path, monkeypatch, capsys):
    pytest.importorskip("tensorboardX")
    logger = port_logging.Logger("m", str(tmp_path))
    monkeypatch.setitem(sys.modules, "PIL", None)
    logger.image_summary("sample", [np.zeros((4, 4, 3))], 1)
    logger.close()
    assert "Pillow does not import" in capsys.readouterr().err


def test_plot_curves_and_its_absence(tmp_path, monkeypatch, capsys):
    history = {"loss_G": [1.0, 0.5], "loss_D": [], "psnr": [20.0, 21.0]}
    assert plotting.plot_curves(history, str(tmp_path / "c" / "curves.png"))
    assert os.path.getsize(tmp_path / "c" / "curves.png") > 0
    assert not plotting.plot_curves({"psnr": []}, str(tmp_path / "e.png"))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    assert not plotting.plot_curves(history, str(tmp_path / "n.png"))
    assert "matplotlib does not import" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "n.png")


def test_attention_overlay_and_gif_are_the_jax_files(tmp_path, monkeypatch):
    """Byte for byte the files of the JAX package's functions; without
    Pillow nothing is written."""
    rng = np.random.default_rng(1)
    image, mask = rng.random((12, 10, 3)), rng.random((12, 10))
    assert plotting.show_attention_on_image(image, mask,
                                            str(tmp_path / "port.png"))
    jax_plotting.show_attention_on_image(image, mask,
                                         str(tmp_path / "jax.png"))
    frames = []
    for i in range(3):
        frames.append(str(tmp_path / f"f{i}.png"))
        plotting.save_image(rng.random((8, 8, 3)), frames[-1])
    assert plotting.make_gif(frames, str(tmp_path / "port.gif"), fps=4)
    jax_plotting.make_gif(frames, str(tmp_path / "jax.gif"), fps=4)
    for ext in ("png", "gif"):
        assert (tmp_path / f"port.{ext}").read_bytes() == (
            tmp_path / f"jax.{ext}").read_bytes()
    assert not plotting.make_gif([], str(tmp_path / "none.gif"))
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert not plotting.make_gif(frames, str(tmp_path / "no_pil.gif"))
    assert not plotting.show_attention_on_image(image, mask,
                                                str(tmp_path / "no_pil.png"))
    assert not glob.glob(str(tmp_path / "no_pil.*"))


def test_count_params_is_the_jax_count_for_carried_weights():
    small = dict(base_filters=16, n_groups=2, n_blocks=2)
    gen = JaxGenerator(scale=4, **small)
    shapes = jax.eval_shape(gen.init, jax.random.PRNGKey(0),
                            jax.ShapeDtypeStruct((1, 12, 12, 3),
                                                 jnp.float32))["params"]
    params = jax.tree.map(lambda s: np.zeros(s.shape, np.float32), shapes)
    model = create_generator("sradsgan", 4, **small)
    model.load_state_dict(sradsgan_state_dict(params))
    assert report.count_params(model) == jax_report.count_params(params)


def test_network_report_flops_and_trace(tmp_path):
    model = create_generator("edsr", 2, base_filters=8, num_residuals=1)
    x = torch.rand(1, 3, 6, 6)
    flops = report.flops_estimate(model, x)
    # the convs' multiply-adds: 3x3 convs at 6^2 (3->8, 8->8 x3, 8->3) and
    # the upsample conv 8->32, two a multiply-add
    macs = 36 * 9 * (3 * 8 + 3 * 8 * 8 + 8 * 32) + 144 * 9 * 8 * 3
    assert flops == 2 * macs
    path = report.print_network_to_file(model, x, str(tmp_path), "G")
    report.print_network_to_file(model, x, str(tmp_path), "G again")
    text = open(path).read()
    n = report.count_params(model)
    assert text.startswith(f"=== G ===\nparams: {n} ({n / 1e6:.3f} M)\n"
                           f"flops (FlopCounterMode, batch 1): "
                           f"{flops:.3e} ({flops / 1e9:.3f} G)\n")
    assert "=== G again ===" in text
    with report.trace(str(tmp_path / "trace")):
        model(x)
    (trace,) = glob.glob(str(tmp_path / "trace" / "trace_*.json"))
    assert os.path.getsize(trace) > 0


def test_wandb_shim_is_a_no_op_without_wandb(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)
    run = WandbLogger(config={"lr": 1e-4})
    assert not run.enabled
    run.log_metrics({"psnr": 30.0}, step=1)
    run.log_image("sr", np.zeros((4, 4, 3)))
    run.log_checkpoint("ckpt.pt")
    run.finish()
