"""The port's HAT with the published options (``gelu="exact"``,
``share_upsample=False``) against the benchmark's plain reference of the
published model (``port_bench/reference/hat_x4.py``, loaded by path), on the
CPU at the reference's ``TINY_WIDTHS``: embed 48, one group of two HABs
(the first unshifted, the second shifted by half a window), window 4, MLP
ratio 2 (so the OCAB's MLP, of ratio 2 in the program and of the model's
ratio in the reference, is one width).

Both load one state dict, drawn with fan-in scale so that activations are
of order one and with the bias tables at unit scale so that they move the
softmax; LayerNorm gains one and shifts zero, as the benchmark's weights.

Tolerances, each a share of max|reference|:

- forward 1e-5, gradients 3e-5 per tensor: the two run the same float32
  arithmetic in other layouts ((B, N, heads, d) against the published (B,
  heads, N, d), unfold against pad and strided windows), so they part by
  a reordered sum's rounding: 1.1e-6 of the output and 2.6e-6 of the
  worst gradient (``conv_last.bias``) at these weights;
- the tanh GELU lies 1.2e-4 (forward) and 4.5e-3 (gradient) from the
  exact one, and one upsample conv shared by both x2 stages lies at order
  one: each fails both by more than three times
  (``test_each_departure_fails_the_tolerances``).
"""

from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from port_bench.harness import reference_module  # noqa: E402
from sradsgan_tpu_torch.models import create_generator  # noqa: E402
from sradsgan_tpu_torch.models import hat  # noqa: E402
from sradsgan_tpu_torch.utils import spans  # noqa: E402

REFERENCE = reference_module(str(Path(__file__).resolve().parents[1]
                                 / "port_bench" / "reference" / "hat_x4.py"))
TINY = dict(REFERENCE.TINY_WIDTHS)
# the published depths, heads and window at the tiny embedding: the calls
# a forward makes are the published model's (42)
PUBLISHED_DEPTHS = dict(TINY, depths=[6] * 6, num_heads=[6] * 6,
                        window_size=16)
FWD_BAR, GRAD_BAR = 1e-5, 3e-5
# (h, w) of the LR input: a window multiple, and one the forward pads to
# 12 x 16 and crops back
SIZES = [(8, 8), (10, 13)]
# the program with one departure from the published model
DEPARTURES = {"tanh_gelu": dict(gelu="tanh"),
              "shared_upsample": dict(share_upsample=True)}


def _weights(model, seed=0):
    gen = torch.Generator().manual_seed(seed)
    out = {}
    for name, v in model.state_dict().items():
        owner, _, leaf = name.rpartition(".")
        if isinstance(model.get_submodule(owner), torch.nn.LayerNorm):
            out[name] = (torch.ones_like(v) if leaf == "weight"
                         else torch.zeros_like(v))
        elif leaf == "relative_position_bias_table":
            out[name] = torch.randn(v.shape, generator=gen)
        elif v.dim() > 1:
            out[name] = torch.randn(v.shape, generator=gen) * (
                v[0].numel() ** -0.5)
        else:
            out[name] = torch.randn(v.shape, generator=gen) * 0.05
    return out


def _pair(**departure):
    ref = REFERENCE.build("cpu", **TINY)
    weights = _weights(ref)
    ref.load_state_dict(weights)
    prog = create_generator("hat", 4, **{**TINY, **departure})
    # a shared upsample conv takes the first stage's weights
    prog.load_state_dict(weights,
                         strict=not departure.get("share_upsample", False))
    return prog, ref


def _input(h, w, seed=1):
    return torch.rand((2, 3, h, w), generator=torch.Generator().manual_seed(
        seed))


def _forward_gap(prog, ref, size) -> float:
    x = _input(*size)
    with torch.no_grad():
        got, want = prog(x), ref(x)
    assert got.shape == want.shape == (2, 3, 4 * size[0], 4 * size[1])
    return float((got - want).abs().max() / want.abs().max())


def _grad_gaps(prog, ref, size=(10, 13)) -> dict:
    """Each leaf's max|gradient difference| over its max|reference
    gradient| under an L1 loss, and the losses' relative gap."""
    x = _input(*size)
    target = torch.rand((2, 3, 4 * size[0], 4 * size[1]),
                        generator=torch.Generator().manual_seed(2))
    losses = []
    for net in (prog, ref):
        loss = (net(x) - target).abs().mean()
        loss.backward()
        losses.append(float(loss.detach()))
    want = dict(ref.named_parameters())
    gaps = {n: float((p.grad - want[n].grad).abs().max()
                     / want[n].grad.abs().max())
            for n, p in prog.named_parameters()}
    gaps["loss"] = abs(losses[0] - losses[1]) / losses[1]
    return gaps


@pytest.mark.parametrize("size", SIZES, ids=["multiple", "padded"])
def test_forward_matches_the_published_reference(size):
    prog, ref = _pair()
    assert _forward_gap(prog, ref, size) <= FWD_BAR


def test_gradients_match_the_published_reference():
    prog, ref = _pair()
    gaps = _grad_gaps(prog, ref)
    assert set(gaps) == {n for n, _ in ref.named_parameters()} | {"loss"}
    worst = max(gaps, key=gaps.get)
    assert gaps[worst] <= GRAD_BAR, (worst, gaps[worst])


@pytest.mark.parametrize("departure", sorted(DEPARTURES))
def test_each_departure_fails_the_tolerances(departure):
    prog, ref = _pair(**DEPARTURES[departure])
    assert _forward_gap(prog, ref, SIZES[1]) > 3 * FWD_BAR
    assert max(_grad_gaps(prog, ref).values()) > 3 * GRAD_BAR


def test_the_default_options_keep_the_jax_packages_model():
    """The defaults build today's model: its parameter names and count
    (the published options add the second stage's conv and nothing else)
    and the tanh GELU; an unknown GELU is refused."""
    widths = {k: v for k, v in TINY.items()
              if k not in ("gelu", "share_upsample")}
    default = create_generator("hat", 4, **widths, seed=3)
    published = create_generator("hat", 4, **TINY, seed=3)
    names = dict(default.named_parameters())
    extra = {n: p for n, p in published.named_parameters()
             if n not in names}
    assert sum(p.numel() for p in default.parameters()) == 305_951
    assert set(names) <= set(dict(published.named_parameters()))
    assert set(extra) == {"upsample.upsampling.2.weight",
                          "upsample.upsampling.2.bias"}
    assert [n for n, _ in default.named_modules()] == [
        n for n, _ in published.named_modules()
        if not n.startswith("upsample.upsampling.2")]
    assert not default.layers[0].residual_group.blocks[0].mlp.exact_gelu
    assert published.layers[0].residual_group.overlap_attn.mlp.exact_gelu
    with pytest.raises(ValueError, match="gelu"):
        create_generator("hat", 4, **widths, gelu="erf")


def _logits(b, h, w, widths) -> int:
    """B_ * heads * Nq * Nk summed over one forward's attention calls at a
    (b, h, w) input that is a window multiple."""
    ws = widths["window_size"]
    ows = ws + int(widths["overlap_ratio"] * ws)
    windows = b * (h // ws) * (w // ws)
    return sum(windows * heads * ws * ws * (depth * ws * ws + ows * ows)
               for depth, heads in zip(widths["depths"],
                                       widths["num_heads"]))


@pytest.mark.parametrize("case", ["tiny", "published_depths"])
def test_the_attention_counters_and_spans(case):
    """A forward makes sum(depths) + len(depths) attention calls (42 at
    the published depths) with their logit elements, and records one
    ``hat.window_attention`` span a HAB and one ``hat.overlap_attention``
    an OCAB."""
    widths, (b, h, w) = {"tiny": (TINY, (2, 10, 13)),
                         "published_depths": (PUBLISHED_DEPTHS,
                                              (1, 16, 16))}[case]
    model = create_generator("hat", 4, **widths)
    calls, logits = hat._attend.calls, hat._attend.logit_elements
    with spans.recording() as records, torch.no_grad():
        model(torch.rand(b, 3, h, w))
    ws = widths["window_size"]
    padded = (-(-h // ws) * ws, -(-w // ws) * ws)
    blocks, groups = sum(widths["depths"]), len(widths["depths"])
    assert hat._attend.calls - calls == blocks + groups
    assert hat._attend.logit_elements - logits == _logits(b, *padded,
                                                          widths)
    names = [s.name for s in records]
    assert names.count("hat.window_attention") == blocks
    assert names.count("hat.overlap_attention") == groups
    assert len(names) == blocks + groups
    assert all(f"``{n}``" in spans.__doc__ for n in set(names))
    if case == "published_depths":
        assert blocks + groups == 42
