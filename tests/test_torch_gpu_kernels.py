"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Edge shapes that chip_smoke.py does not cover: single elements, images
smaller than the 7x7 stencil or the 16x16 tile, ragged tiles, tied maxima,
attention lengths around the key-tile size and every instantiated width,
for the forward kernels and the backward ones; the attention kernels also
at lengths off every tile, on each launch configuration (few or many
blocks), at energies of +-30, with a whole key tile of equal energies and
twice over for equal bits; the fused RAB tail at
ragged tiles, images under its halo, 16 and 256 channels, with its backward
and inside a RAB; the gate's double backward
on the card; and the dispatch that sends CUDA tensors to the kernels.  The
three row-strip kernels (gate forward and backward, fused RAB tail) also
at heights under and off their strips and bands, odd widths, 1 to 256
channels, batches from 1 to 37, a 216x216 image, planes and views off the 16-byte
grid, tied maxima, saturated gates, twice over for equal bits, and against
the strip-wise plain helpers; the gate forward also at strips of 1 to 5
rows, beyond one wave of blocks, 20 times over for equal bits, inside a
captured CUDA graph and on two streams at once.  SRAGAN, the second model
on the kernels' path: its forward against the plain path and its forward's
and train step's launches, unfused and fused.  The six registered ops
(``torch.ops.sradsgan_tpu_torch.*``) at the main path's shapes: schema,
fake implementation and traced dispatch (``torch.library.opcheck``), and
one launch a call.  Marked ``gpu``; they skip
where no CUDA device is present.  This file imports neither JAX nor the
JAX package, so on a machine without them run it as

    python -m pytest --noconftest -m gpu tests/test_torch_gpu_kernels.py
"""

import pytest

torch = pytest.importorskip("torch")

from sradsgan_tpu_torch.models.sradsgan import RAB  # noqa: E402
from sradsgan_tpu_torch.ops import (pooling, rab_tail, sgam_flash,  # noqa
                                    spatial_gate)

pytestmark = pytest.mark.gpu
# max |kernel - plain| over max |plain|: float32 sums in another order,
# bfloat16 outputs may round one bf16 ulp apart
TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
DTYPES = [torch.float32, torch.bfloat16]


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # full float32 in the plain convs, which cuDNN would run in TF32
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    return torch.device("cuda")


def _randn(shape, dtype, device, seed=0, std=1.0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * std).to(device, dtype)


def _close(got, want, dtype, floor=0.0):
    """Within TOL of max |want|, or of ``floor`` where the reference is
    smaller (a gradient that is zero by the math rounds to noise)."""
    err = (got.float() - want.float()).abs().max()
    bound = TOL[dtype] * max(float(want.float().abs().max()), floor)
    assert err <= bound, float(err)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (2, 3, 1, 7),
                                   (5, 64, 54, 54), (1, 16, 33, 257)])
def test_pool_kernel(cuda, dtype, shape):
    x = _randn(shape, dtype, cuda) - 3.0  # all-negative rows are common
    avg, mx = pooling.avg_max_pool_cuda(x)
    avg_p, mx_p = pooling.avg_max_pool_plain(x)
    torch.cuda.synchronize()
    _close(avg, avg_p, dtype)
    assert torch.equal(mx, mx_p)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(1, 1, 1, 1), (1, 4, 3, 5),
                                   (2, 64, 17, 33), (1, 8, 70, 70)])
def test_gate_kernel(cuda, dtype, shape):
    x = _randn(shape, dtype, cuda)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    got = spatial_gate.spatial_gate_cuda(x, w)
    want = spatial_gate.spatial_gate_plain(x, w)
    torch.cuda.synchronize()
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100])
@pytest.mark.parametrize("d_qk,d_v", sgam_flash.KERNEL_WIDTHS)
def test_attention_kernel(cuda, dtype, n, d_qk, d_v):
    q = _randn((3, n, d_qk), dtype, cuda, seed=2)
    k = _randn((3, n, d_qk), dtype, cuda, seed=3)
    v = _randn((3, n, d_v), dtype, cuda, seed=4)
    got = sgam_flash.position_attention_cuda(q, k, v)
    want = sgam_flash.position_attention_plain(q, k, v)
    torch.cuda.synchronize()
    _close(got, want, dtype)


GATE_BWD_SHAPES = [(1, 1, 1, 1), (1, 4, 3, 5), (2, 64, 17, 33),
                   (1, 8, 70, 70), (2, 256, 27, 27), (2, 64, 54, 54)]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", GATE_BWD_SHAPES)
def test_gate_bwd_kernel(cuda, dtype, shape, ties):
    x = _randn(shape, torch.float32, cuda)
    if ties:  # a few integer values: most channel maxima are tied
        x = x.mul(1.5).round()
    x = x.to(dtype)
    g = _randn(shape, dtype, cuda, seed=5)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    dx, dw = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
    dx_p, dw_p = spatial_gate.spatial_gate_bwd_plain(x, w, g)
    torch.cuda.synchronize()
    assert dx.dtype == dtype and dw.dtype == torch.float32
    _close(dx, dx_p, dtype)
    _close(dw, dw_p, dtype)


# heights under a band and off the strips, odd widths, C = 1, 3, 64, 256,
# B = 1 to 37 (strips of one row up to several), the discriminator's
# shape, and images of a few hundred rows or columns
STRIP_SHAPES = [(1, 1, 3, 5), (2, 3, 5, 9), (1, 64, 13, 17), (3, 64, 27, 31),
                (1, 256, 27, 27), (16, 256, 27, 27), (1, 64, 54, 54),
                (4, 64, 54, 54), (8, 64, 54, 54), (16, 64, 54, 54),
                (37, 64, 54, 54), (1, 64, 216, 216), (2, 8, 300, 70),
                (1, 256, 60, 60)]


def _off_grid(t):
    """A contiguous copy of t that starts one element off the 16-byte grid."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.data_ptr() % 16 and view.is_contiguous()
    return view


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_gate_kernel_over_strip_shapes(cuda, dtype, shape):
    """Against the plain version, and against the strip-wise plain helper
    at the kernel's own strips; a second launch gives the same bits."""
    from sradsgan_tpu_torch.ops import _build
    x = _randn(shape, dtype, cuda)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    got = spatial_gate.spatial_gate_cuda(x, w)
    again = spatial_gate.spatial_gate_cuda(x, w)
    rows = _build.plan("sg_spatial_gate", x.device, shape, dtype)["rows"]
    torch.cuda.synchronize()
    _close(got, spatial_gate.spatial_gate_plain(x, w), dtype)
    _close(got, spatial_gate.spatial_gate_plain_strips(x, w, rows), dtype)
    assert torch.equal(got, again)


@pytest.mark.parametrize("rows", [1, 2, 3, 5])
@pytest.mark.parametrize("shape", [(2, 8, 11, 13), (3, 64, 27, 31),
                                   (1, 64, 216, 216)])
def test_gate_kernel_matches_the_strip_helper(cuda, shape, rows):
    """Strips of 1 to 5 rows (a halo of 3 rows reaching over 3 to 1 strips
    beside each), tied channel maxima, against the same cutting in plain
    PyTorch."""
    x = _randn(shape, torch.float32, cuda).mul(1.5).round()
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    got = spatial_gate.spatial_gate_cuda(x, w, min(rows, shape[2]))
    torch.cuda.synchronize()
    _close(got, spatial_gate.spatial_gate_plain_strips(x, w, rows),
           torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 54, 54), (3, 64, 27, 31),
                                   (2, 256, 27, 27), (1, 16, 216, 216)])
def test_gate_kernel_takes_views_off_the_16_byte_grid(cuda, dtype, shape):
    x = _off_grid(_randn(shape, dtype, cuda))
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    got = spatial_gate.spatial_gate_cuda(x, w)
    torch.cuda.synchronize()
    _close(got, spatial_gate.spatial_gate_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gate_kernel_with_saturated_gates(cuda, dtype):
    """Pre-activations of +-30 and beyond: gates that round to 0 and 1."""
    x = _randn((4, 64, 54, 54), dtype, cuda)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=1.8)
    planes = torch.stack([x.float().mean(1), x.float().amax(1)], 1)
    assert torch.nn.functional.conv2d(planes, w, padding=3).abs().max() > 30
    got = spatial_gate.spatial_gate_cuda(x, w)
    torch.cuda.synchronize()
    assert torch.isfinite(got.float()).all()
    _close(got, spatial_gate.spatial_gate_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 16, 1, 9), (3, 8, 2, 40),
                                   (1, 64, 6, 6), (4, 3, 5, 1)])
def test_gate_kernel_under_the_stencil(cuda, dtype, shape):
    """Images of 1 to 6 rows (or one column): the halo is all border."""
    x = _randn(shape, dtype, cuda)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    got = spatial_gate.spatial_gate_cuda(x, w)
    torch.cuda.synchronize()
    _close(got, spatial_gate.spatial_gate_plain(x, w), dtype)


@pytest.mark.parametrize("rows", [None, 1])
@pytest.mark.parametrize("dtype", DTYPES)
def test_gate_kernel_beyond_one_wave(cuda, dtype, rows):
    """More blocks than the card holds at once (37 images of 54 one-row
    strips): the outputs' launch, started early, waits for the statistics
    launch whose last blocks start only as others end."""
    x = _randn((37, 64, 54, 54), dtype, cuda)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    got = spatial_gate.spatial_gate_cuda(x, w, rows)
    torch.cuda.synchronize()
    _close(got, spatial_gate.spatial_gate_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(16, 64, 54, 54), (1, 64, 216, 216)])
def test_gate_kernel_is_bit_equal_over_20_calls(cuda, dtype, shape):
    """The order in which blocks run changes no bit."""
    x = _randn(shape, dtype, cuda)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    outs = [spatial_gate.spatial_gate_cuda(x, w) for _ in range(20)]
    torch.cuda.synchronize()
    assert all(torch.equal(outs[0], o) for o in outs[1:])
    _close(outs[0], spatial_gate.spatial_gate_plain(x, w), dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gate_kernel_in_a_cuda_graph(cuda, dtype):
    """Three calls captured in a graph (each two launches, the second a
    programmatic dependent launch), replayed twice, then an eager call."""
    x = _randn((4, 64, 54, 54), dtype, cuda)
    x2 = _randn((2, 256, 27, 27), dtype, cuda, seed=3)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    spatial_gate.spatial_gate_cuda(x, w)  # build and plan outside the capture
    spatial_gate.spatial_gate_cuda(x2, w)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        a = spatial_gate.spatial_gate_cuda(x, w)
        b = spatial_gate.spatial_gate_cuda(x2, w)
        c = spatial_gate.spatial_gate_cuda(x, w)
    want, want2 = (spatial_gate.spatial_gate_plain(x, w),
                   spatial_gate.spatial_gate_plain(x2, w))
    for _ in range(2):
        for t in (a, b, c):
            t.zero_()
        graph.replay()
        torch.cuda.synchronize()
        _close(a, want, dtype)
        _close(b, want2, dtype)
        assert torch.equal(a, c)
    eager = spatial_gate.spatial_gate_cuda(x, w)
    torch.cuda.synchronize()
    assert torch.equal(eager, a)


def test_gate_kernel_on_a_second_stream(cuda):
    """Calls on two streams at once give the bits of calls on one."""
    x = _randn((16, 64, 54, 54), torch.float32, cuda)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    want = spatial_gate.spatial_gate_cuda(x, w)
    side = torch.cuda.Stream()
    torch.cuda.synchronize()
    with torch.cuda.stream(side):
        on_side = [spatial_gate.spatial_gate_cuda(x, w) for _ in range(5)]
    on_main = [spatial_gate.spatial_gate_cuda(x, w) for _ in range(5)]
    torch.cuda.synchronize()
    assert all(torch.equal(want, o) for o in on_side + on_main)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_gate_bwd_kernel_over_strip_shapes(cuda, dtype, shape):
    """dx and dw against the plain version; a second launch gives the same
    bits (dw is summed in a fixed order, no atomics)."""
    x = _randn(shape, dtype, cuda)
    g = _randn(shape, dtype, cuda, seed=5)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    dx, dw = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
    dx2, dw2 = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
    dx_p, dw_p = spatial_gate.spatial_gate_bwd_plain(x, w, g)
    torch.cuda.synchronize()
    _close(dx, dx_p, dtype)
    _close(dw, dw_p, dtype)
    assert torch.equal(dx, dx2) and torch.equal(dw, dw2)


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("shape", [(2, 8, 11, 13), (3, 64, 27, 31),
                                   (1, 64, 216, 216)])
def test_gate_bwd_kernel_matches_the_strip_helper(cuda, shape, rows):
    """The second reference: the same cutting into strips with halos, in
    plain PyTorch, with tied channel maxima."""
    x = _randn(shape, torch.float32, cuda).mul(1.5).round()
    g = _randn(shape, torch.float32, cuda, seed=5)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    got = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
    want = spatial_gate.spatial_gate_bwd_plain_strips(x, w, g, rows)
    torch.cuda.synchronize()
    for a, r in zip(got, want):
        _close(a, r, torch.float32)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 54, 54), (3, 64, 27, 31),
                                   (2, 256, 27, 27), (1, 16, 216, 216)])
def test_gate_bwd_kernel_takes_views_off_the_16_byte_grid(cuda, dtype,
                                                          shape):
    """x and g one element off the grid (and so apart in phase from dx); in
    bf16 the 54x54 and 27x31 planes are no multiple of 16 bytes either, so
    odd and even channels start at different phases."""
    x = _off_grid(_randn(shape, dtype, cuda))
    g = _off_grid(_randn(shape, dtype, cuda, seed=5))
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    dx, dw = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
    dx_p, dw_p = spatial_gate.spatial_gate_bwd_plain(x, w, g)
    torch.cuda.synchronize()
    _close(dx, dx_p, dtype)
    _close(dw, dw_p, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gate_bwd_kernel_with_saturated_gates(cuda, dtype):
    """Taps six times the usual: pre-activations of +-30 and beyond, gates
    that round to 0 and 1.  ds all but vanishes, so dw is held to the bar
    of a gradient of order one."""
    shape = (4, 64, 54, 54)
    x = _randn(shape, dtype, cuda)
    g = _randn(shape, dtype, cuda, seed=5)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=1.8)
    planes = torch.stack([x.float().mean(1), x.float().amax(1)], 1)
    assert torch.nn.functional.conv2d(planes, w, padding=3).abs().max() > 30
    dx, dw = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
    dx_p, dw_p = spatial_gate.spatial_gate_bwd_plain(x, w, g)
    torch.cuda.synchronize()
    assert torch.isfinite(dx.float()).all() and torch.isfinite(dw).all()
    _close(dx, dx_p, dtype)
    _close(dw, dw_p, dtype, floor=1.0)


def test_gate_bwd_kernel_without_its_dw_stage_gives_the_same_dx(cuda):
    x = _randn((2, 64, 54, 54), torch.float32, cuda)
    g = _randn((2, 64, 54, 54), torch.float32, cuda, seed=5)
    w = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)
    dx, _ = spatial_gate.spatial_gate_bwd_cuda(x, w, g)
    dx_only, _ = spatial_gate.spatial_gate_bwd_cuda(x, w, g, with_dw=False)
    assert torch.equal(dx, dx_only)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 729])
@pytest.mark.parametrize("d_qk,d_v", sgam_flash.KERNEL_WIDTHS)
def test_attention_bwd_kernel(cuda, dtype, n, d_qk, d_v):
    q = _randn((3, n, d_qk), dtype, cuda, seed=2, std=0.5)
    k = _randn((3, n, d_qk), dtype, cuda, seed=3, std=0.5)
    v = _randn((3, n, d_v), dtype, cuda, seed=4)
    dout = _randn((3, n, d_v), dtype, cuda, seed=6)
    out, lse = sgam_flash.position_attention_cuda(q, k, v, with_lse=True)
    _close(out, sgam_flash.position_attention_cuda(q, k, v), dtype)
    want_lse = torch.logsumexp(q.float() @ k.float().transpose(1, 2), -1)
    _close(lse, want_lse, torch.float32)
    got = sgam_flash.position_attention_bwd_cuda(q, k, v, out, dout, lse)
    want = sgam_flash.position_attention_bwd_plain(q, k, v, dout)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == dtype
        # one key: softmax is 1 whatever q and k, so dq = dk = 0 exactly
        _close(a, b, dtype, floor=1.0 if n == 1 else 0.0)


def _attention_check(q, k, v, dout, dtype):
    """Forward, log-sum-exp and backward on the card against the plain
    versions in float64 on the card's own (rounded) inputs; a second launch
    must give the same bits (no atomics)."""
    out, lse = sgam_flash.position_attention_cuda(q, k, v, with_lse=True)
    assert torch.equal(out, sgam_flash.position_attention_cuda(q, k, v))
    q64, k64, v64, do64 = (t.double() for t in (q, k, v, dout))
    _close(out, sgam_flash.position_attention_plain_chunked(q64, k64, v64),
           dtype)
    assert torch.isfinite(out.float()).all()
    if q.shape[1] > 4096:
        return
    _close(lse, torch.logsumexp(q64 @ k64.transpose(1, 2), -1),
           torch.float32)
    got = sgam_flash.position_attention_bwd_cuda(q, k, v, out, dout, lse)
    again = sgam_flash.position_attention_bwd_cuda(q, k, v, out, dout, lse)
    want = sgam_flash.position_attention_bwd_plain(q64, k64, v64, do64)
    torch.cuda.synchronize()
    for a, a2, b in zip(got, again, want):
        assert torch.equal(a, a2)
        # one key: softmax is 1 whatever q and k, so dq = dk = 0 exactly
        _close(a, b, dtype, floor=1.0 if q.shape[1] == 1 else 0.0)


# lengths off every tile (16-row fragments, 64-key tiles, 128-row blocks),
# batches that give fewer blocks than the card has multiprocessors (the
# split-key forward, the one-warp backward) and more (the full blocks, in
# bf16 the warpgroup kernels)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,n", [(1, 1), (2, 63), (1, 65), (3, 129),
                                 (1, 2916), (16, 729), (24, 2916),
                                 (300, 129), (1, 9000)])
def test_attention_kernels_ragged_and_launch_configurations(cuda, dtype, b,
                                                            n):
    q = _randn((b, n, 8), dtype, cuda, seed=2, std=0.5)
    k = _randn((b, n, 8), dtype, cuda, seed=3, std=0.5)
    v = _randn((b, n, 64), dtype, cuda, seed=4)
    dout = _randn((b, n, 64), dtype, cuda, seed=6)
    _attention_check(q, k, v, dout, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 20])
def test_attention_kernels_at_large_energies(cuda, dtype, b):
    """q, k of scale 1.7: energies reach +-30 and beyond, where a product of
    reduced precision would show in the exponent."""
    q = _randn((b, 1000, 8), dtype, cuda, seed=2, std=1.7)
    k = _randn((b, 1000, 8), dtype, cuda, seed=3, std=1.7)
    v = _randn((b, 1000, 64), dtype, cuda, seed=4)
    dout = _randn((b, 1000, 64), dtype, cuda, seed=6)
    assert (q.float() @ k.float().transpose(1, 2)).abs().max() > 30
    _attention_check(q, k, v, dout, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 80])
def test_attention_kernels_with_a_tile_of_equal_energies(cuda, dtype, b):
    """Keys 64..127 (one whole key tile) are the same vector, and so are
    all keys of a second input: uniform weights within the tile, and a
    running max that a tile leaves as it was."""
    n = 200
    q = _randn((b, n, 8), dtype, cuda, seed=2, std=0.5)
    k = _randn((b, n, 8), dtype, cuda, seed=3, std=0.5)
    v = _randn((b, n, 64), dtype, cuda, seed=4)
    dout = _randn((b, n, 64), dtype, cuda, seed=6)
    k[:, 64:128] = k[:, 64:65]
    _attention_check(q, k.contiguous(), v, dout, dtype)
    k[:] = 0  # every energy 0: the output is the mean of v
    out = sgam_flash.position_attention_cuda(q, k, v)
    _close(out, v.float().mean(1, keepdim=True).expand_as(v), dtype)


def test_attention_kernels_take_an_unaligned_view(cuda):
    """A contiguous view that starts off the 16-byte grid."""
    q1 = _randn((2 * 40 * 2 + 1,), torch.bfloat16, cuda, seed=2)[1:].view(
        2, 40, 2)
    assert q1.data_ptr() % 16 and q1.is_contiguous()
    v1 = _randn((2, 40, 16), torch.bfloat16, cuda, seed=4)
    _attention_check(q1, q1, v1, v1, torch.bfloat16)


def _rab_tail_args(shape, dtype, device, ties=False):
    b, c, h, w = shape
    hidden = max(c // 16, 1)
    t = _randn(shape, torch.float32, device, seed=8)
    if ties:  # a few integer values: tied maxima over H, W and over C
        t = t.mul(1.5).round()
    # live hidden units, scaled so that the channel gate stays away from
    # saturation at every width (a gate that rounds to 1.0 in float32 and
    # not in float64 would tie maxima of u on one side only)
    w1 = (_randn((c, hidden), torch.float32, device, 11, 0.02).abs()
          + 0.05) * (16 / c)
    return (t.to(dtype), _randn(shape, dtype, device, seed=9), w1,
            _randn((hidden, c), torch.float32, device, 12, 0.1),
            _randn((1, 2, 7, 7), torch.float32, device, 13, 0.3),
            _randn((c, c), torch.float32, device, 14, 0.5 / c ** 0.5),
            _randn((c,), torch.float32, device, 15, 0.05))


# ragged strips, H or W under the 3-pixel halo, C = 16 (one hidden unit,
# a quarter of a pass of the fuse) and 256 (four passes), B = 1
RAB_TAIL_SHAPES = [(1, 16, 1, 1), (1, 16, 2, 5), (2, 64, 17, 33),
                   (1, 64, 54, 54), (2, 256, 20, 17), (3, 48, 16, 16),
                   (1, 32, 70, 3)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", RAB_TAIL_SHAPES)
def test_rab_tail_kernel(cuda, dtype, shape):
    args = _rab_tail_args(shape, dtype, cuda)
    got = rab_tail.rab_tail_cuda(*args)
    want = rab_tail.rab_tail_plain(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype
    for g, r in zip(got, want):
        _close(g, r, dtype)
    # the maxima are exact: max_t as it stands, max_u as the maximum of the
    # products with the kernel's own gate_c
    t32 = args[0].float()
    assert torch.equal(got[6], want[6])
    assert torch.equal(got[4], (t32 * got[1][:, :, None, None]).amax(1))


def _check_rab_tail(args, dtype):
    """All seven outputs against the plain version, the maxima exact, and a
    second launch for equal bits."""
    got = rab_tail.rab_tail_cuda(*args)
    again = rab_tail.rab_tail_cuda(*args)
    want = rab_tail.rab_tail_plain(*args)
    torch.cuda.synchronize()
    assert got[0].dtype == dtype
    for g, r in zip(got, want):
        _close(g, r, dtype)
    t32 = args[0].float()
    assert torch.equal(got[6], want[6])
    assert torch.equal(got[4], (t32 * got[1][:, :, None, None]).amax(1))
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    return got


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", STRIP_SHAPES)
def test_rab_tail_kernel_over_strip_shapes(cuda, dtype, shape, ties):
    """``ties``: a few integer values of t, so that maxima are tied over
    H, W (the CLAM's pool) and over C (the SLAM's)."""
    args = _rab_tail_args(shape, dtype, cuda, ties)
    if ties and shape[1] > 1 and shape[2] * shape[3] > 100:
        t = args[0].float()
        assert ((t == t.amax(1, keepdim=True)).sum(1) > 1).any()
        assert ((t == t.amax((2, 3), keepdim=True)).sum((2, 3)) > 1).any()
    _check_rab_tail(args, dtype)


@pytest.mark.parametrize("rows", [1, 5])
@pytest.mark.parametrize("shape", [(2, 16, 11, 13), (3, 64, 27, 31),
                                   (1, 64, 216, 216)])
def test_rab_tail_kernel_matches_the_strip_helper(cuda, shape, rows):
    args = _rab_tail_args(shape, torch.float32, cuda, ties=True)
    got = rab_tail.rab_tail_cuda(*args)
    want = rab_tail.rab_tail_plain_strips(*args, rows)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        _close(g, r, torch.float32)
    assert torch.equal(got[6], want[6])


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("shape", [(2, 64, 54, 54), (3, 64, 27, 31),
                                   (1, 48, 216, 216)])
def test_rab_tail_kernel_takes_views_off_the_16_byte_grid(cuda, dtype,
                                                          shape):
    args = _rab_tail_args(shape, dtype, cuda)
    _check_rab_tail((_off_grid(args[0]), _off_grid(args[1])) + args[2:],
                    dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rab_tail_kernel_with_saturated_gates(cuda, dtype):
    """Both gates driven to 0 and 1: the SLAM's taps six times the usual
    (pre-activations beyond +-30), the CLAM's second layer forty times."""
    args = list(_rab_tail_args((4, 64, 54, 54), dtype, cuda))
    args[3] = args[3] * 40.0
    args[4] = args[4] * 6.0
    got = _check_rab_tail(tuple(args), dtype)
    gate_c, gate_s = got[1], got[2]
    # the inputs did saturate both gates at both ends
    assert gate_c.min() < 1e-4 and gate_c.max() > 1 - 1e-4
    assert gate_s.min() < 1e-4 and gate_s.max() > 1 - 1e-4
    assert all(torch.isfinite(g.float()).all() for g in got)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("shape", [(1, 16, 2, 5), (2, 64, 17, 33),
                                   (2, 256, 20, 17)])
def test_rab_tail_backward_on_cuda(cuda, shape, ties):
    """The op's backward on the card (its SLAM part launches the gate's
    backward kernel) against the same op on the CPU in float64."""
    args = _rab_tail_args(shape, torch.float32, cuda, ties)
    g = _randn(shape, torch.float32, cuda, seed=10)
    leaves = [a.clone().requires_grad_() for a in args]
    before = (rab_tail.rab_tail_cuda.launches,
              spatial_gate.spatial_gate_bwd_cuda.launches)
    got = torch.autograd.grad(rab_tail.fused_rab_tail(*leaves), leaves, g)
    assert (rab_tail.rab_tail_cuda.launches,
            spatial_gate.spatial_gate_bwd_cuda.launches) == (before[0] + 1,
                                                             before[1] + 1)
    ref = [a.detach().cpu().double().requires_grad_() for a in args]
    want = torch.autograd.grad(rab_tail.fused_rab_tail(*ref), ref,
                               g.cpu().double())
    for a, r in zip(got, want):
        err = (a.cpu().double() - r).abs().max()
        assert err <= 1e-4 * r.abs().max(), float(err)


def test_fused_rab_block_on_cuda(cuda):
    """A fused RAB on the card against the unfused one: forward, and the
    gradients of every parameter."""
    unfused, fused = RAB(64).to(cuda), RAB(64, "fused").to(cuda)
    with torch.no_grad():
        for p in unfused.parameters():
            p.copy_(_randn(p.shape, torch.float32, cuda, seed=p.numel() % 97,
                           std=0.5 / max(p[0].numel(), 1) ** 0.5))
        unfused.ca.fc1.weight.abs_().add_(0.05)
    fused.load_state_dict(unfused.state_dict())
    x = _randn((2, 64, 30, 21), torch.float32, cuda)
    want, got = unfused(x), fused(x)
    _close(got, want, torch.float32)
    g_want = torch.autograd.grad(want.square().sum(),
                                 list(unfused.parameters()))
    g_got = torch.autograd.grad(got.square().sum(), list(fused.parameters()))
    for a, r in zip(g_got, g_want):
        assert (a - r).abs().max() <= 1e-4 * r.abs().max()


@pytest.mark.parametrize("shape", [(2, 64, 20, 19), (2, 256, 27, 27)])
def test_gate_double_backward_on_cuda(cuda, shape):
    """The WGAN-GP's second order through the gate on the card (K2 and K4
    in the first order) against autograd of the plain gate."""
    x0 = _randn(shape, torch.float32, cuda)
    a = _randn(shape, torch.float32, cuda, seed=7)
    w0 = _randn((1, 2, 7, 7), torch.float32, cuda, seed=1, std=0.3)

    def second_order(gate):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        (gx,) = torch.autograd.grad((gate(x, w) * a).sum(), x,
                                    create_graph=True)
        return torch.autograd.grad((gx * gx).sum(), (x, w))

    before = spatial_gate.spatial_gate_bwd_cuda.launches
    got = second_order(spatial_gate.spatial_gate)
    assert spatial_gate.spatial_gate_bwd_cuda.launches > before
    want = second_order(spatial_gate.spatial_gate_plain)
    torch.cuda.synchronize()
    for g, r in zip(got, want):
        err = (g - r).abs().max()
        assert err <= 1e-4 * r.abs().max(), float(err)


def test_backward_dispatch_launches_the_kernels_on_cuda(cuda):
    x = _randn((2, 8, 9, 9), torch.float32, cuda).requires_grad_()
    w = _randn((1, 2, 7, 7), torch.float32, cuda).requires_grad_()
    before = spatial_gate.spatial_gate_bwd_cuda.launches
    spatial_gate.spatial_gate(x, w).sum().backward()
    assert spatial_gate.spatial_gate_bwd_cuda.launches == before + 1
    q = _randn((2, 40, 8), torch.float32, cuda).requires_grad_()
    v = _randn((2, 40, 64), torch.float32, cuda).requires_grad_()
    fwd = sgam_flash.position_attention_cuda.launches
    bwd = sgam_flash.position_attention_bwd_cuda.launches
    sgam_flash.position_attention(q, q, v).sum().backward()
    assert sgam_flash.position_attention_cuda.launches == fwd + 1
    assert sgam_flash.position_attention_bwd_cuda.launches == bwd + 1
    assert q.grad.abs().max() > 0 and v.grad.abs().max() > 0


def test_wrappers_refuse_what_the_kernels_do_not_take(cuda):
    x = _randn((2, 8, 9, 9), torch.float32, cuda)
    w = _randn((1, 2, 7, 7), torch.float32, cuda)
    with pytest.raises(ValueError, match="contiguous"):
        pooling.avg_max_pool_cuda(x.transpose(2, 3))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        pooling.avg_max_pool_cuda(x.half())
    with pytest.raises(ValueError, match="float32"):
        spatial_gate.spatial_gate_cuda(x, w.to(torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel"):
        q = _randn((1, 10, 3), torch.float32, cuda)
        sgam_flash.position_attention_cuda(q, q, q)
    with pytest.raises(ValueError, match="g must be a contiguous"):
        spatial_gate.spatial_gate_bwd_cuda(x, w, x.transpose(2, 3))
    args = _rab_tail_args((2, 16, 9, 9), torch.float32, cuda)
    with pytest.raises(ValueError, match="x_res must be a contiguous"):
        rab_tail.rab_tail_cuda(args[0], args[1].to(torch.bfloat16), *args[2:])
    with pytest.raises(ValueError, match="fuse_w must be a contiguous"):
        rab_tail.rab_tail_cuda(*args[:5], args[5].t(), args[6])
    with pytest.raises(ValueError, match="at most 256 channels"):
        rab_tail.rab_tail_cuda(*_rab_tail_args((1, 272, 4, 4),
                                               torch.float32, cuda))
    q = _randn((1, 10, 8), torch.float32, cuda)
    v = _randn((1, 10, 64), torch.float32, cuda)
    out, lse = sgam_flash.position_attention_cuda(q, q, v, with_lse=True)
    with pytest.raises(ValueError, match="lse must be"):
        sgam_flash.position_attention_bwd_cuda(q, q, v, out, v, lse.double())


def test_dispatch_launches_the_kernel_on_cuda(cuda):
    x = _randn((2, 8, 9, 9), torch.float32, cuda)
    before = pooling.avg_max_pool_cuda.launches
    pooling.avg_max_pool(x)
    assert pooling.avg_max_pool_cuda.launches == before + 1


def _launches():
    return {"avg_max_pool": pooling.avg_max_pool_cuda,
           "spatial_gate": spatial_gate.spatial_gate_cuda,
           "position_attention": sgam_flash.position_attention_cuda,
           "spatial_gate_bwd": spatial_gate.spatial_gate_bwd_cuda,
           "position_attention_bwd": sgam_flash.position_attention_bwd_cuda,
           "rab_tail": rab_tail.rab_tail_cuda}


def _sragan(rab, **kw):
    """A SRAGAN generator of 2 groups x 2 blocks at 64 filters (the
    attention kernel's (8, 64) width), conv weights at fan-in scale and
    both gains 0.5, so that every tail and the PAM matter."""
    from sradsgan_tpu_torch.models import create_generator

    model = create_generator("sragan", 4, n_groups=2, n_blocks=2,
                             rab_tail=rab, **kw)
    g = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("gamma"):
                p.fill_(0.5)
            elif p.dim() == 4:
                p.copy_(torch.randn(p.shape, generator=g) * 0.5
                        / p[0].numel() ** 0.5)
    return model.eval()


@pytest.mark.parametrize("rab", ["unfused", "fused"])
def test_sragan_forward_on_cuda(cuda, rab):
    """The card's SRAGAN forward against the plain path on the CPU, and
    its launches: per tail (two blocks and the group's, twice) a pool and
    a gate, or one fused tail; the PAM once."""
    model = _sragan(rab)
    x = _randn((2, 3, 20, 20), torch.float32, "cpu", seed=4).sigmoid()
    with torch.no_grad():
        want = model(x)
        model.to(cuda)
        for fn in _launches().values():
            fn.launches = 0
        got = model(x.to(cuda)).cpu()
    counts = {k: fn.launches for k, fn in _launches().items()}
    tails = 2 * (2 + 1)
    fused = rab == "fused"
    assert counts == {"avg_max_pool": 0 if fused else tails,
                      "spatial_gate": 0 if fused else tails,
                      "position_attention": 1, "spatial_gate_bwd": 0,
                      "position_attention_bwd": 0,
                      "rab_tail": tails if fused else 0}
    assert float((got - want).abs().max()) <= 1e-4 * float(
        want.abs().max())


@pytest.mark.parametrize("rab", ["unfused", "fused"])
def test_sragan_train_step_launches_on_cuda(cuda, rab):
    """One float32 WGAN-GP step of a SRAGAN trainer (1 group x 2 blocks, the
    CBAM D): the launches the module structure gives (chip_smoke.py's
    step_launches), finite losses."""
    import numpy as np

    from sradsgan_tpu_torch.models import config_for_model
    from sradsgan_tpu_torch.train.trainer import Trainer

    cfg = config_for_model("sragan", 4, bf16=False, model_kwargs=dict(
        n_groups=1, n_blocks=2, rab_tail=rab))
    trainer = Trainer(cfg, device=cuda)
    rng = np.random.default_rng(0)
    batch = {"lr": rng.random((2, 8, 8, 3), dtype=np.float32),
             "hr": rng.random((2, 32, 32, 3), dtype=np.float32)}
    for fn in _launches().values():
        fn.launches = 0
    losses = trainer.train_step(batch)
    torch.cuda.synchronize()
    counts = {k: fn.launches for k, fn in _launches().items()}
    tails, fused = 1 * (2 + 1), rab == "fused"
    assert counts == {"avg_max_pool": (0 if fused else tails) + 4,
                      "spatial_gate": (0 if fused else tails) + 4,
                      "position_attention": 1,
                      "spatial_gate_bwd": tails + 5,
                      "position_attention_bwd": 1,
                      "rab_tail": tails if fused else 0}
    assert all(torch.isfinite(v) for v in losses.values())


# The registered ops at the main path's shapes (the x4 step at batch 16):
# the checks of torch.library.opcheck that apply to an op without autograd
# of its own (the autograd.Functions own the gradients), then one call,
# which must launch that kernel once.
OPCHECK_TESTS = ("test_schema", "test_faketensor", "test_aot_dispatch_dynamic")
MAIN_SHAPE = (16, 64, 54, 54)


def _op_args(name, device):
    x = _randn(MAIN_SHAPE, torch.float32, device)
    w = _randn((1, 2, 7, 7), torch.float32, device, seed=1, std=0.3)
    q, k = (_randn((16, 2916, 8), torch.float32, device, seed=s)
            for s in (2, 3))
    v = _randn((16, 2916, 64), torch.float32, device, seed=4)
    if name == "avg_max_pool":
        return (x,)
    if name == "spatial_gate":
        return x, w
    if name == "spatial_gate_bwd":
        return x, w, _randn(MAIN_SHAPE, torch.float32, device, seed=5)
    if name == "position_attention":
        return q, k, v, True
    if name == "position_attention_bwd":
        out, lse = sgam_flash.position_attention_cuda(q, k, v, with_lse=True)
        return q, k, v, out, _randn(v.shape, torch.float32, device, 6), lse
    return _rab_tail_args(MAIN_SHAPE, torch.float32, device)


@pytest.mark.parametrize("name", sorted(_launches()))
def test_registered_op(cuda, name):
    op = getattr(torch.ops.sradsgan_tpu_torch, name).default
    args = _op_args(name, cuda)
    torch.library.opcheck(op, args, test_utils=OPCHECK_TESTS)
    wrapper = _launches()[name]
    before = wrapper.launches
    op(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1
