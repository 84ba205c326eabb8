"""The data axis: one process group over which the batch is split and the
tables' rows are sharded (port of ``recmodels_tpu/parallel/mesh.py``).

JAX names one flat ``data`` axis of a device mesh and lets XLA lower the
collectives onto it. Here the axis is a ``torch.distributed`` process group
(NCCL between cards, gloo between CPU processes), and ``Mesh`` is the group,
its size, this process's rank in it and the device its tensors live on.
Starting the processes and initialising the group is the caller's.

The device follows from the backend: an NCCL group works on
``cuda:<local rank>`` (ranks fill one host's cards in order), a gloo group
on ``cpu``. A tensor on another device is refused, not moved: nothing
copies between host and card behind the caller's back.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist

DATA_AXIS = "data"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A process group seen from one of its ranks."""

    group: object  # the process group; None is torch.distributed's default group
    size: int
    rank: int
    device: torch.device

    def require(self, what: str, t: torch.Tensor) -> None:
        """Raise unless ``t`` lies on the mesh's device."""
        if t.device != self.device:
            raise ValueError(f"{what} lies on {t.device}; this mesh's collectives run on {self.device}")

    def sum_(self, tensors: list) -> None:
        """Each tensor summed over the ranks, in place (``lax.psum``)."""
        self._all_reduce(tensors, mean=False)

    def mean_(self, tensors: list) -> None:
        """Each tensor summed over the ranks and then divided by their
        number, in place (``lax.pmean``)."""
        self._all_reduce(tensors, mean=True)

    def _all_reduce(self, tensors: list, mean: bool) -> None:
        """One all-reduce per dtype, on a flat buffer of every tensor of
        that dtype, copied back in place."""
        by_dtype: dict = {}
        for t in tensors:
            by_dtype.setdefault(t.dtype, []).append(t)
        for group in by_dtype.values():
            flat = torch.cat([t.reshape(-1) for t in group])
            dist.all_reduce(flat, group=self.group)
            if mean:
                flat.div_(self.size)
            parts = flat.split([t.numel() for t in group])
            torch._foreach_copy_(group, [p.view(t.shape) for p, t in zip(parts, group)])

    def all_to_all(self, t: torch.Tensor) -> torch.Tensor:
        """``lax.all_to_all`` over the leading axis of ``t`` ([size, ...]):
        block s of the result is block ``rank`` of rank s's ``t``."""
        out = torch.empty_like(t)
        dist.all_to_all_single(out, t, group=self.group)
        return out


def make_mesh(n_devices: int | None = None, group=None) -> Mesh:
    """The mesh of ``group`` (default: the default process group, which the
    caller has initialised). Raises when the group's size is not
    ``n_devices``, for a backend other than NCCL and gloo, and for an NCCL
    group in a process that has no card."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: initialise torch.distributed first (init_process_group)")
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    if n_devices is not None and size != n_devices:
        raise ValueError(f"make_mesh: the group has {size} ranks, not {n_devices}")
    backend = dist.get_backend(group)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: an NCCL group needs a CUDA device, and none is available")
        device = torch.device("cuda", rank % torch.cuda.device_count())
    elif backend == "gloo":
        device = torch.device("cpu")
    else:
        raise ValueError(f"make_mesh: backend {backend!r}; the port runs on nccl (cards) or gloo (CPU)")
    return Mesh(group=group, size=size, rank=rank, device=device)
