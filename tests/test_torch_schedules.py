"""The port's learning-rate schedules (``recmodels_tpu_torch/train/schedules.py``)
against the JAX package's, which are optax's: each kind, with and without a
warmup, at the steps around the warmup's end and the schedule's end and past
it. Both compute in f32 by the same formulas; ``cos`` and ``pow`` of PyTorch
and of XLA may land an ulp or two apart, hence rtol 1e-6 (8 f32 ulps)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from recmodels_tpu.train.schedules import build_lr_schedule as jbuild
from recmodels_tpu_torch.train.schedules import KINDS, build_lr_schedule

BASE, TOTAL, WARMUP = 0.05, 100, 10
RTOL = 1e-6


def _steps(warmup: int) -> list[int]:
    w = max(warmup, 1)
    return sorted({0, 1, w - 1, w, w + 1, (w + TOTAL) // 2, TOTAL - 1, TOTAL, TOTAL + 7})


@pytest.mark.parametrize("warmup", [0, WARMUP], ids=["no-warmup", "warmup"])
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_matches_optax(kind, warmup):
    kw = dict(kind=kind, warmup_steps=warmup, total_steps=TOTAL, end_scale=0.1, decay_rate=0.9,
              decay_every=20)
    port, jax_ = build_lr_schedule(BASE, **kw), jbuild(BASE, **kw)
    if kind == "constant" and not warmup:
        assert port == jax_ == BASE and isinstance(port, float)
        return
    for step in _steps(warmup):
        got = port(torch.tensor(step, dtype=torch.int32))
        want = np.float32(jax_(jnp.asarray(step, jnp.int32)))
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(got.item(), want, rtol=RTOL, atol=0, err_msg=f"step {step}")


def test_schedule_reads_the_step_tensor_where_it_lies():
    """The lr is a tensor computed from the step tensor on its device: no
    Python number in between (a graph replays the step it reads)."""
    s = build_lr_schedule(BASE, "cosine", warmup_steps=WARMUP, total_steps=TOTAL)
    step = torch.tensor(3, dtype=torch.int32)
    a = s(step)
    step.add_(4)
    b = s(step)
    assert a.item() == pytest.approx(BASE * 3 / WARMUP, rel=1e-6)
    assert b.item() == pytest.approx(BASE * 7 / WARMUP, rel=1e-6)
    assert s(torch.tensor(3, dtype=torch.int32, device="meta")).device.type == "meta"


def test_unknown_schedule_raises():
    with pytest.raises(ValueError, match="unknown lr schedule 'step'"):
        build_lr_schedule(BASE, "step")
