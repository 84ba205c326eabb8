"""Operations and bytes that a Wukong training step needs
(``reference/wukong.py``), from the configuration and the batch: what its
whole-step share of the peak and its FM kernels' roofline share divide by.
As ``counts.py``: each input byte read once, each output byte written once;
a multiply-add is 2.

* ``step_flops``: the products of the forward (the bag sums, the bottom MLP,
  each layer's FM ``X^T Y`` and ``X Z``, its LCB ``W_L X``, its MLP_F, layer
  1's projection ``P X``, the top MLP), and in training twice those
  products again (each operand's grad) and the bag sums again; the
  LayerNorms', the residual's and the optimizers' elementwise work left out.
* ``fm_bytes``: the FM kernels' (``csrc/wukong_fm.cu``) bytes a step, every
  layer forward and back: forward X read, ``a`` and ``l`` written (bf16),
  LN_F's mean and rstd written (f32); backward X, ``g_a``, ``g_L`` and
  ``g_res`` read and ``g_x`` written (bf16), the mean and rstd read; the
  weights and their grads (under 0.1% of it) left out.
* ``ln_bytes``: the residual LayerNorm kernels' (``csrc/wukong_ln.cu``)
  bytes a step, every layer forward and back: forward the FMB's ``h``, the
  LCB's ``l`` and the residual ``r`` read, the sum ``s`` and ``X'`` written
  (bf16), each row's mean and rstd written (f32); backward ``g`` and ``s``
  read, ``g_s`` and the FMB's rows ``g_h`` written (bf16), the mean and
  rstd read; the scale, the shift and their grads left out.

``kernels_roofline`` divides such bytes by the device time of the kernels
that move them, for the readers ``wukong_fm_roofline`` and
``wukong_ln_roofline``.
"""

from __future__ import annotations

from benchmark import counts, program_trace
from benchmark.counts_dcnv2 import _mlp
from benchmark.profile import short_name


def layer_widths(cfg: dict) -> list:
    """Embeddings into each layer: the bottom's and one a slot, then n_F + n_L."""
    m = cfg["n_fmb"] + cfg["n_lcb"]
    return [cfg["n_slots"] + 1] + [m] * (cfg["n_layers"] - 1)


def forward_flops(cfg: dict) -> dict:
    """An example's forward products by part."""
    d, k, m = cfg["embed_dim"], cfg["fm_rank"], cfg["n_fmb"] + cfg["n_lcb"]
    ns = layer_widths(cfg)
    return {"bags": (sum(cfg["hotness"]) - cfg["n_slots"]) * d,
            "bottom": _mlp([cfg["n_dense"], *cfg["bottom"]]),
            "fm": sum(2 * (2 * n * d * k) for n in ns),
            "lcb": sum(2 * n * cfg["n_lcb"] * d for n in ns),
            "mlp_f": sum(_mlp([n * k, *cfg["fmb_hidden"], cfg["n_fmb"] * d]) for n in ns),
            "proj": sum(2 * n * m * d for n in ns if n != m),
            "top": _mlp([m * d, *cfg["top"], 1])}


def step_flops(cfg: dict, b: int, train: bool = True) -> int:
    """The model's operations for ``b`` examples: forward, and with
    ``train`` the backward too."""
    f = forward_flops(cfg)
    total = sum(f.values())
    if train:
        total += 2 * (total - f["bags"]) + f["bags"]
    return b * total


def fm_bytes(cfg: dict, b: int, elem: int = 2) -> int:
    """The FM kernels' bytes for ``b`` examples through every layer, forward
    and backward (``elem``: the bytes of an activation)."""
    d, k, n_l = cfg["embed_dim"], cfg["fm_rank"], cfg["n_lcb"]
    total = 0
    for n in layer_widths(cfg):
        forward = (n * d + n * k + n_l * d) * elem + 2 * 4
        backward = (3 * n * d + n * k + n_l * d) * elem + 2 * 4
        total += forward + backward
    return b * total


def ln_bytes(cfg: dict, b: int, elem: int = 2) -> int:
    """The residual LayerNorm kernels' bytes for ``b`` examples through
    every layer, forward and backward (``elem``: the bytes of an
    activation)."""
    d, n_f, m = cfg["embed_dim"], cfg["n_fmb"], cfg["n_fmb"] + cfg["n_lcb"]
    forward = 4 * m * d * elem + m * 2 * 4
    backward = (3 * m * d + n_f * d) * elem + m * 2 * 4
    return b * cfg["n_layers"] * (forward + backward)


def kernels_roofline(ctx: dict, kernels: tuple, nbytes) -> float | None:
    """A roofline share of Wukong kernels selected by name (``kernel_map.json``
    does not name them): ``nbytes(cfg, batch, elem)`` at the card's bandwidth
    over their device time a traced step, in %. None outside a traced Wukong
    training run, where the counter ``wukong.fm_layers`` is 0 or missing (no
    layer took the kernels), or where the kernels did not run."""
    t, cfg = ctx.get("trace"), ctx.get("config", {})
    if ctx.get("kind") != "train" or t is None or not t.steps or cfg.get("model") != "wukong":
        return None
    if not program_trace.counter("wukong.fm_layers"):
        return None
    measured = sum(d for n, _, d in t.device_ops if short_name(n).split("::")[-1] in kernels) / 1e6 / t.steps
    elem = 2 if cfg.get("compute_dtype") == "bfloat16" else 4
    bound = counts.bound_ms(ctx.get("card", ""), nbytes=nbytes(cfg, ctx["batch_size"], elem))
    if bound is None or measured <= 0:
        return None
    return 100.0 * bound / measured
