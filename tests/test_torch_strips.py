"""The row-strip formulations of the gate forward and backward and the fused
RAB tail against the JAX package, on the CPU.

The kernels in ``csrc/spatial_gate.cu``, ``csrc/spatial_gate_bwd.cu`` and
``csrc/rab_tail.cu`` cut an
image into strips of whole rows, each with halos (statistics 6 or 3 rows
beyond the strip, zeros outside the image), combine the image-wide pools and
the weight gradient from per-strip partials in strip order, and exchange
the halo rows between the blocks of a cluster.  A CUDA kernel cannot run
here, so the same cutting is written in plain PyTorch beside each kernel
(``spatial_gate_plain_strips``, ``spatial_gate_bwd_plain_strips``,
``rab_tail_plain_strips``) and held against the JAX package: the Pallas
forward ``slam._fwd_pallas`` in interpret mode (1e-5 of max |ref|), the
Pallas backward kernel ``slam._bwd_pallas`` in interpret mode with
``slam._dw_contraction`` (1e-5), and the
fused tail's jnp reference ``rab_tail._forward_jnp`` (1e-6; ``max_t``
exact, ``max_u`` bit-equal to the maximum of ``t * gate_c``).  Strip
heights of one row, of fewer rows than the stencil reaches, of rows that do
not divide the image, and of the whole image.  Inputs are
drawn with numpy from a seed and handed to both sides; the JAX side is NHWC,
the port NCHW.  The GPU tests hold the kernels against these helpers too.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from sradsgan_tpu.ops.pallas import rab_tail as jax_rab_tail  # noqa: E402
from sradsgan_tpu.ops.pallas import slam  # noqa: E402
from sradsgan_tpu_torch.ops import rab_tail  # noqa: E402
from sradsgan_tpu_torch.ops import spatial_gate as sg  # noqa: E402

PLANES = [(11, 13), (27, 31)]
ROWS = [1, 2, 5, None]          # None: the whole image in one strip
CHANNELS = 8
BATCH = 2
GATE_TOL = 1e-5                 # of max |ref|: another order of summation
TAIL_ATOL = 1e-6
TAIL_NAMES = ("out", "gate_c", "gate_s", "mean_u", "max_u", "avg_t", "max_t")


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(
        np.asarray(a, np.float32).transpose(0, 3, 1, 2)))


def _oihw(w_hwio):
    return torch.from_numpy(np.ascontiguousarray(
        w_hwio.transpose(3, 2, 0, 1)))


@functools.lru_cache(maxsize=None)
def _gate_fwd_case(plane, ties):
    """NCHW input, OIHW taps and the Pallas forward's output for them."""
    h, w = plane
    rng = np.random.default_rng(h + 100 * ties + 7)
    x = rng.normal(0, 1, (BATCH, h, w, CHANNELS))
    if ties:  # a few integer values: most channel maxima are tied
        x = np.round(1.5 * x)
    x = x.astype(np.float32)
    kernel = rng.normal(0, 0.3, (7, 7, 2, 1)).astype(np.float32)  # HWIO
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SRADSGAN_TPU_PALLAS_INTERPRET", "1")
        out = slam._fwd_pallas(jnp.asarray(x), jnp.asarray(kernel))
    return _nchw(x), _oihw(kernel), _nchw(out)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("plane", PLANES + [(5, 9)])  # and one under 7 rows
def test_gate_forward_by_strips_matches_the_pallas_kernel(plane, rows, ties):
    """The cutting of ``csrc/spatial_gate.cu``: each strip's gate from the
    statistics on its rows and 3 rows beside them."""
    x, w, want = _gate_fwd_case(plane, ties)
    got = sg.spatial_gate_plain_strips(x, w, rows or plane[0])
    err = float((got - want).abs().max())
    assert err <= GATE_TOL * float(want.abs().max()), err


@functools.lru_cache(maxsize=None)
def _gate_case(plane, ties):
    """NHWC inputs and the JAX package's (dx, dw) for them."""
    h, w = plane
    rng = np.random.default_rng(h + 100 * ties)
    x = rng.normal(0, 1, (BATCH, h, w, CHANNELS))
    if ties:  # a few integer values: most channel maxima are tied
        x = np.round(1.5 * x)
    x = x.astype(np.float32)
    g = rng.normal(0, 1, x.shape).astype(np.float32)
    kernel = rng.normal(0, 0.3, (7, 7, 2, 1)).astype(np.float32)  # HWIO
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SRADSGAN_TPU_PALLAS_INTERPRET", "1")
        mp.setenv("SRADSGAN_TPU_SLAM_IMPL", "pallas")
        dx, ds, mean, mx = slam._bwd_pallas(*map(jnp.asarray, (x, g, kernel)))
    dw = slam._dw_contraction(ds, mean, mx, 7, 3, h, w, jnp.float32)
    return (x, g, kernel, np.asarray(dx).transpose(0, 3, 1, 2),
            np.asarray(dw).transpose(3, 2, 0, 1))


@pytest.mark.parametrize("output", ["dx", "dw"])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("plane", PLANES)
def test_gate_backward_by_strips_matches_the_pallas_kernel(plane, rows, ties,
                                                           output):
    x, g, kernel, dx_want, dw_want = _gate_case(plane, ties)
    dx, dw = sg.spatial_gate_bwd_plain_strips(
        _nchw(x), _oihw(kernel), _nchw(g), rows or plane[0])
    got, want = (dx, dx_want) if output == "dx" else (dw, dw_want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=GATE_TOL * np.abs(want).max())


def test_gate_backward_strips_have_tied_maxima_in_the_tie_case():
    x = _nchw(_gate_case(PLANES[0], True)[0])
    assert ((x == x.amax(1, keepdim=True)).sum(1) > 1).any()


@pytest.mark.parametrize("rows", [1, 4])
def test_gate_backward_by_strips_equals_the_plain_backward(rows):
    """The helper against the op's own plain backward (what the CPU path
    runs), on a plane narrower than the stencil."""
    rng = np.random.default_rng(5)
    x, g = (torch.from_numpy(rng.normal(0, 1, (1, 3, 9, 4)).astype(
        np.float32)) for _ in range(2))
    w = torch.from_numpy(rng.normal(0, 0.3, (1, 2, 7, 7)).astype(np.float32))
    want = sg.spatial_gate_bwd_plain(x, w, g)
    got = sg.spatial_gate_bwd_plain_strips(x, w, g, rows)
    for a, r in zip(got, want):
        assert (a - r).abs().max() <= GATE_TOL * r.abs().max()


@functools.lru_cache(maxsize=None)
def _tail_case(plane, ties):
    """NHWC inputs of the fused tail and the JAX reference's outputs."""
    h, w = plane
    c = CHANNELS
    rng = np.random.default_rng(h + 7 + 100 * ties)
    hidden = 2
    t = rng.normal(0, 1, (BATCH, h, w, c))
    if ties:  # tied maxima over H, W and over C
        t = np.round(1.5 * t)
    f32 = lambda a: np.asarray(a, np.float32)  # noqa: E731
    args = tuple(map(f32, (
        t, rng.normal(0, 1, t.shape),
        np.abs(rng.normal(0, 0.3, (c, hidden))) + 0.05,
        rng.normal(0, 0.3, (hidden, c)) + 0.1,
        rng.normal(0, 0.3, (7, 7, 2, 1)),
        rng.normal(0, 0.5 / np.sqrt(c), (c, c)),
        rng.normal(0, 0.05, (c,)))))
    want = jax_rab_tail._forward_jnp(*map(jnp.asarray, args))
    return args, dict(zip(TAIL_NAMES, map(np.asarray, want)))


def _tail_port_args(args):
    t, x_res, w1, w2, slam_w, fuse_w, fuse_b = args
    return (_nchw(t), _nchw(x_res), torch.from_numpy(w1),
            torch.from_numpy(w2), _oihw(slam_w), torch.from_numpy(fuse_w),
            torch.from_numpy(fuse_b))


@pytest.mark.parametrize("name", TAIL_NAMES)
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("plane", PLANES)
def test_fused_tail_by_strips_matches_the_jax_reference(plane, rows, ties,
                                                        name):
    args, want = _tail_case(plane, ties)
    got = dict(zip(TAIL_NAMES, rab_tail.rab_tail_plain_strips(
        *_tail_port_args(args), rows or plane[0])))
    value = got[name].numpy()
    if name == "out":
        value = value.transpose(0, 2, 3, 1)
    # max_t is a plain maximum of t: exact.  max_u is the maximum of
    # t * gate_c, and the two frameworks' gate_c differ in the last bits.
    np.testing.assert_allclose(value, want[name], rtol=0,
                               atol=0 if name == "max_t" else TAIL_ATOL)


@pytest.mark.parametrize("rows", ROWS)
@pytest.mark.parametrize("plane", PLANES)
def test_fused_tail_strips_keep_max_u_an_element_of_u(plane, rows):
    """Bit for bit the maximum of t * gate_c with the helper's own gate_c,
    whatever the cutting: the backward finds the tied maxima by equality."""
    args = _tail_port_args(_tail_case(plane, True)[0])
    got = rab_tail.rab_tail_plain_strips(*args, rows or plane[0])
    gate_c, max_u = got[1], got[4]
    assert torch.equal(max_u, (args[0] * gate_c[:, :, None, None]).amax(1))


def test_fused_tail_strips_take_bf16_inputs():
    """bf16 activations, float32 parameters and byproducts, as the plain
    version: the strips change the cutting, not the types."""
    args = _tail_port_args(_tail_case(PLANES[0], False)[0])
    args = (args[0].bfloat16(), args[1].bfloat16()) + args[2:]
    want = rab_tail.rab_tail_plain(*args)
    got = rab_tail.rab_tail_plain_strips(*args, 2)
    assert got[0].dtype == torch.bfloat16
    assert all(g.dtype == torch.float32 for g in got[1:])
    for a, r in zip(got, want):
        assert (a.float() - r.float()).abs().max() <= 2e-2 * r.abs().max()
