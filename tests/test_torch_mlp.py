"""The bf16 MLP's route on the CPU: ``MlpStack`` with the plain epilogues
(``nn/mlp_epilogue.py``) against autograd through the chain it replaced
(``ProductF32``, PyTorch's bias add, ``relu`` and cast), the epilogues'
plain versions at their edges, and the counter ``mlp.fused_layers``.

The written-out backward rounds at the chain's points, so outputs, input
grads and weight grads are held bit for bit. The bias grads are the same
bf16 values summed in f32 in another order on the card; here they are held
to 1e-5 of the f32 sum of |g_z| a column, the bound the card tests use.
"""

import pytest
import torch

from recmodels_tpu_torch.nn import mlp as mlp_mod
from recmodels_tpu_torch.nn.mlp import ProductF32, mlp_apply, mlp_init
from recmodels_tpu_torch.nn.mlp_epilogue import (
    act_backward, act_backward_reference, bias_act, bias_act_reference,
)
from recmodels_tpu_torch.utils import profiling

BIAS_SUM_TOL = 1e-5


def old_chain(layers, x, final_linear):
    """The bf16 route before ``MlpStack``: autograd through ``ProductF32``,
    the f32 bias add, ``relu`` and the cast of each layer."""
    h = x.to(torch.bfloat16)
    n = len(layers)
    for i, layer in enumerate(layers):
        h = ProductF32.apply(h, layer["w"].to(torch.bfloat16)) + layer["b"]
        if not (final_linear and i == n - 1):
            h = torch.relu(h)
        h = h.to(torch.bfloat16)
    return h.float()


def _layers(gen, in_dim, hidden, out_dim):
    layers = mlp_init(gen, in_dim, hidden, out_dim=out_dim)
    for layer in layers:  # live biases: init leaves them at zero
        layer["b"] = torch.randn(layer["b"].shape, generator=gen) * 0.3
    return layers


def _run(fn, layers, x, x_grad, seed=1):
    """fn's output and the grads of <output, cotangent> w.r.t. every
    weight, bias and (if ``x_grad``) x."""
    params = [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in layers]
    x = x.clone().requires_grad_(x_grad)
    out = fn(params, x)
    cot = torch.randn(out.shape, generator=torch.Generator().manual_seed(seed))
    leaves = [t for p in params for t in (p["w"], p["b"])] + ([x] if x_grad else [])
    return out, torch.autograd.grad((out * cot).sum(), leaves)


def _bias_close(got, want, gz_abs_sum):
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert torch.all((got - want).abs() <= BIAS_SUM_TOL * gz_abs_sum + 1e-30)


# (in, hidden, out_dim): a [B, 1] logit layer, a linear layer of many
# outputs, and a stack whose last layer has a ReLU (final_linear False)
@pytest.mark.parametrize("final_linear,dims", [
    (True, (37, (64, 40), 1)),
    (True, (37, (64,), 24)),
    (False, (13, (48, 24, 16), None)),
])
@pytest.mark.parametrize("x_grad", [True, False])
def test_mlp_stack_equals_autograd_through_the_old_chain(final_linear, dims, x_grad):
    gen = torch.Generator().manual_seed(3)
    layers = _layers(gen, *dims)
    x = torch.randn(50, dims[0], generator=gen)
    got_out, got = _run(lambda p, h: mlp_apply(p, h, final_linear, torch.bfloat16), layers, x, x_grad)
    want_out, want = _run(lambda p, h: old_chain(p, h, final_linear), layers, x, x_grad)
    assert torch.equal(got_out, want_out)
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if j < 2 * len(layers) and j % 2 == 1:  # a bias: the f32 sum of g_z's column
            continue
        assert torch.equal(g, w), j
    # each bias grad against the column sums of its layer's g_z
    params = [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in layers]
    zs = []
    h = x.to(torch.bfloat16)
    for i, p in enumerate(params):
        z = ProductF32.apply(h, p["w"].to(torch.bfloat16)) + p["b"]
        z.retain_grad()
        zs.append(z)
        h = (z if final_linear and i == len(params) - 1 else torch.relu(z)).to(torch.bfloat16)
    cot = torch.randn(got_out.shape, generator=torch.Generator().manual_seed(1))
    (h.float() * cot).sum().backward()
    for i, z in enumerate(zs):
        _bias_close(got[2 * i + 1], want[2 * i + 1], z.grad.abs().sum(dim=0))


def test_stack_input_grad_takes_the_inputs_dtype_and_is_left_out_when_not_wanted(monkeypatch):
    """The stack's input grad is the input's (bf16); where x needs no grad
    the first layer's input-grad product is not computed: one product fewer
    in the backward."""
    gen = torch.Generator().manual_seed(5)
    layers = _layers(gen, 12, (16, 8), 1)
    x = torch.randn(20, 12, generator=gen).to(torch.bfloat16)
    calls = []
    real = mlp_mod._mm_f32
    monkeypatch.setattr(mlp_mod, "_mm_f32", lambda a, b: calls.append(1) or real(a, b))
    for x_grad, products in ((True, 3 + 6), (False, 3 + 5)):
        calls.clear()
        out, grads = _run(lambda p, h: mlp_apply(p, h, True, torch.bfloat16), layers, x, x_grad)
        assert len(calls) == products
        if x_grad:
            assert grads[-1].dtype == torch.bfloat16


def test_served_forward_takes_the_epilogue_alone(monkeypatch):
    """Under no_grad the layers run without ``MlpStack`` and give its
    output's bits."""
    gen = torch.Generator().manual_seed(7)
    layers = _layers(gen, 30, (32, 16), 1)
    x = torch.randn(40, 30, generator=gen)
    params = [{k: v.clone().requires_grad_(True) for k, v in layer.items()} for layer in layers]
    trained = mlp_apply(params, x, True, torch.bfloat16)

    def refuse(*args):
        raise AssertionError("MlpStack ran under no_grad")

    monkeypatch.setattr(mlp_mod.MlpStack, "apply", refuse)
    with torch.no_grad():
        served = mlp_apply(params, x, True, torch.bfloat16)
    assert torch.equal(served, trained.detach())


def test_fused_layers_counter(monkeypatch):
    """Each bf16 call adds its layers to ``mlp.fused_layers``, with grads or
    without; the f32 route adds nothing."""
    monkeypatch.setattr(profiling, "_counters", {})
    gen = torch.Generator().manual_seed(9)
    layers = _layers(gen, 10, (8, 8, 8), 1)
    x = torch.randn(6, 10, generator=gen)
    mlp_apply(layers, x, True, torch.float32)
    assert profiling.snapshot()["counters"].get("mlp.fused_layers", 0) == 0
    _run(lambda p, h: mlp_apply(p, h, True, torch.bfloat16), layers, x, True)
    assert profiling.snapshot()["counters"]["mlp.fused_layers"] == 4
    with torch.no_grad():
        mlp_apply(layers, x, True, torch.bfloat16)
    assert profiling.snapshot()["counters"]["mlp.fused_layers"] == 8


def test_f32_route_is_pytorchs_chain():
    gen = torch.Generator().manual_seed(11)
    layers = _layers(gen, 9, (7,), 1)
    x = torch.randn(5, 9, generator=gen)
    want = torch.relu(x @ layers[0]["w"] + layers[0]["b"]) @ layers[1]["w"] + layers[1]["b"]
    assert torch.equal(mlp_apply(layers, x, True, torch.float32), want)


def test_plain_epilogues_propagate_nan_as_torch():
    """NaN passes ``relu`` (``torch.relu`` keeps it), and a NaN output
    passes its grad (``threshold_backward`` masks only ``h <= 0``)."""
    z = torch.tensor([[float("nan"), -1.0, 2.0, 0.0]])
    b = torch.zeros(4)
    h = bias_act_reference(z, b, relu=True)
    assert torch.isnan(h[0, 0]) and h[0, 1] == 0 and h[0, 2] == 2 and h[0, 3] == 0
    torch.testing.assert_close(h, torch.relu(z + b).to(torch.bfloat16), rtol=0, atol=0, equal_nan=True)
    assert torch.isnan(bias_act_reference(z, b, relu=False)[0, 0])
    g = torch.tensor([[3.0, 5.0, float("nan"), 7.0]])
    gz, gb = act_backward_reference(g, h)
    assert gz[0, 0] == 3 and gz[0, 1] == 0 and torch.isnan(gz[0, 2]) and gz[0, 3] == 0
    assert gb[0] == 3 and gb[1] == 0 and torch.isnan(gb[2]) and gb[3] == 0
    zs = torch.randn(64, 4, generator=torch.Generator().manual_seed(0))
    zs[0, 0] = float("nan")
    hz = torch.relu(zs.requires_grad_(True))
    gs = torch.randn(64, 4, generator=torch.Generator().manual_seed(1)).to(torch.bfloat16).float()
    (want,) = torch.autograd.grad(hz, zs, gs)
    got, _ = act_backward_reference(gs, hz.detach().to(torch.bfloat16))
    assert torch.equal(got.float(), want)


def test_mask_reads_bf16_outputs_that_round_to_zero():
    """The mask reads bf16 h: outputs in (0, 2^-134] round to bf16 zero and
    drop their grad (the f32 chain passed it); 2^-134 ties to even, and the
    next f32 value up rounds to bf16's least subnormal, 2^-133."""
    tiny = torch.tensor([2.0 ** -140, 2.0 ** -134, torch.nextafter(torch.tensor(2.0 ** -134), torch.tensor(1.0)).item(),
                         2.0 ** -133])
    h = bias_act_reference(tiny[None], torch.zeros(4), relu=True)
    assert h.float().tolist() == [[0.0, 0.0, 2.0 ** -133, 2.0 ** -133]]
    gz, _ = act_backward_reference(torch.ones(1, 4), h)
    assert gz.float().tolist() == [[0.0, 0.0, 1.0, 1.0]]


def test_plain_backward_rounds_an_f32_cotangent_once():
    """An f32 cotangent (the layer above's input grad) rounds to bf16 once:
    g_z is ``g.to(bf16)`` masked, g_b its f32 column sums."""
    gen = torch.Generator().manual_seed(13)
    g = torch.randn(33, 17, generator=gen)
    h = torch.relu(torch.randn(33, 17, generator=gen)).to(torch.bfloat16)
    gz, gb = act_backward_reference(g, h)
    want = torch.where(h > 0, g.to(torch.bfloat16), torch.zeros((), dtype=torch.bfloat16))
    assert gz.dtype == torch.bfloat16 and torch.equal(gz, want)
    assert torch.equal(gb, want.float().sum(dim=0))
    gz_lin, gb_lin = act_backward_reference(g.to(torch.bfloat16), None)
    assert torch.equal(gz_lin, g.to(torch.bfloat16)) and torch.equal(gb_lin, gz_lin.float().sum(dim=0))


def test_epilogue_entries_dispatch_by_device():
    """A CPU tensor takes the plain version; a device with no kernel raises."""
    gen = torch.Generator().manual_seed(15)
    z, b = torch.randn(8, 16, generator=gen), torch.randn(16, generator=gen)
    assert torch.equal(bias_act(z, b, True), bias_act_reference(z, b, True))
    h = bias_act_reference(z, b, True)
    got, want = act_backward(z, h), act_backward_reference(z, h)
    assert all(torch.equal(x, y) for x, y in zip(got, want))
    with pytest.raises(ValueError, match="no kernel"):
        bias_act(z.to("meta"), b.to("meta"), True)
    with pytest.raises(ValueError, match="no kernel"):
        act_backward(z.to("meta"), None)
