"""Data parallelism across ranks (port of sylph_tpu/parallel/mesh.py).

The JAX package runs one program over a 1-D ``"data"`` mesh: the batch's
leading axis is split over the devices, parameters are replicated, and
XLA's collectives (``pmean``, a tiled ``all_gather``) join the shards. The
port runs one process per rank instead and joins them with
``torch.distributed``:

  * ``create_mesh`` -- the rank's ``DataGroup``: its rank, the world size,
    the backend, its device and the process group. It reads torchrun's
    environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) or takes an explicit ``init_method`` (a ``file://``
    store suits tests). Without either it is a world of one, and no process
    group is made;
  * ``shard_batch`` -- this rank's contiguous slice of the leading axis, the
    shard ``P("data")`` puts on device ``rank`` of a JAX mesh;
  * ``cross_rank_mean`` -- the mean over ranks (JAX ``_pmean`` and
    ``_cross_device_mean``);
  * ``all_reduce_mean_`` -- averages tensors in place, one collective per
    dtype over a flat buffer (a step's ~900 gradients are one all-reduce);
  * ``gather_class_codes`` -- a tiled all-gather of fixed-shape code rows,
    the same on every rank.

The backend is NCCL for a CUDA device and gloo for ``device="cpu"``; gloo on
CUDA tensors (several ranks sharing one card) only where the caller names
it. A group never changes its backend or device on its own, and asking for
CUDA without a card raises.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np
import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


@dataclass
class DataGroup:
    """One rank's view of the data-parallel group. ``group`` is None in a
    world of one made without a process group."""
    rank: int
    world: int
    backend: Optional[str]
    device: torch.device
    group: Any = None

    @classmethod
    def single(cls, device: Union[str, torch.device] = "cuda"
               ) -> "DataGroup":
        """A world of one on ``device``, with no process group."""
        return cls(0, 1, None, _resolve(device, 0))

    @property
    def is_main(self) -> bool:
        """Rank 0: the rank that writes checkpoints, metrics and files."""
        return self.rank == 0

    def barrier(self) -> None:
        if self.group is None:
            return
        if self.backend == "nccl":
            dist.barrier(group=self.group, device_ids=[self.device.index])
        else:
            dist.barrier(group=self.group)

    def gather_objects(self, obj) -> List:
        """Every rank's ``obj`` (picklable), in rank order."""
        if self.group is None:
            return [obj]
        out = [None] * self.world
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def close(self) -> None:
        """Destroy the process group, where there is one."""
        if self.group is not None and dist.is_initialized():
            dist.destroy_process_group()
        self.group = None


def _resolve(device: Union[str, torch.device], local_rank: int
             ) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is False; "
            "pass device='cpu' to run on the CPU")
    if dev.index is None:
        dev = torch.device("cuda", local_rank)
    if dev.index >= torch.cuda.device_count():
        raise RuntimeError(
            f"{dev} does not exist ({torch.cuda.device_count()} card(s)); "
            "name the card, e.g. device='cuda:0'")
    return dev


def _backend_for(dev: torch.device, backend: Optional[str]) -> str:
    """NCCL for a CUDA device and gloo for the CPU, unless ``backend`` names
    one; NCCL needs a CUDA device."""
    want = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if want not in BACKENDS:
        raise ValueError(f"backend {want!r}: one of {BACKENDS}")
    if want == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device; use gloo "
                         "for device='cpu'")
    return want


def create_mesh(device: Union[str, torch.device] = "cuda",
                backend: Optional[str] = None, *,
                init_method: Optional[str] = None,
                rank: Optional[int] = None,
                world_size: Optional[int] = None) -> DataGroup:
    """This process's ``DataGroup``.

    ``rank`` and ``world_size`` default to the ``RANK`` and ``WORLD_SIZE``
    variables torchrun sets; ``init_method`` defaults to ``env://`` where
    they are set. With neither, the group is a world of one and no process
    group is made. ``device``: ``"cuda"`` is ``cuda:LOCAL_RANK``; a named
    card (``"cuda:0"``) is taken as named, so several ranks may share it.
    ``backend``: NCCL for a CUDA device and gloo for the CPU by default;
    gloo on a CUDA device must be named, and NCCL needs one. A process
    group made earlier is reused when it agrees with what is asked."""
    env = os.environ
    if rank is None:
        rank = int(env.get("RANK", 0))
    if world_size is None:
        world_size = int(env.get("WORLD_SIZE", 1))
    dev = _resolve(device, int(env.get("LOCAL_RANK", rank)))
    want = _backend_for(dev, backend)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_available() and dist.is_initialized():
        have = dist.get_backend()
        if have != want or dist.get_world_size() != world_size:
            raise RuntimeError(
                f"a process group exists ({have}, world "
                f"{dist.get_world_size()}); asked for {want}, world "
                f"{world_size}")
        return DataGroup(dist.get_rank(), world_size, have, dev,
                         dist.group.WORLD)
    if init_method is None:
        if "WORLD_SIZE" not in env:
            if world_size != 1:
                raise ValueError(f"world_size {world_size} needs an "
                                 "init_method or torchrun's environment")
            return DataGroup(0, 1, None, dev)
        init_method = "env://"
    dist.init_process_group(want, init_method=init_method, rank=rank,
                            world_size=world_size)
    return DataGroup(rank, world_size, want, dev, dist.group.WORLD)


def _slice(x, group: DataGroup):
    if isinstance(x, dict):
        return {k: _slice(v, group) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_slice(v, group) for v in x)
    if not isinstance(x, (torch.Tensor, np.ndarray)) or x.ndim == 0:
        return x
    n = x.shape[0]
    if n % group.world:
        raise ValueError(f"a leading axis of {n} does not split over "
                         f"{group.world} ranks")
    per = n // group.world
    return x[group.rank * per:(group.rank + 1) * per]


def shard_batch(batch, group: DataGroup):
    """This rank's contiguous slice of every array's leading axis (tensors
    and numpy arrays in nested dicts, lists and tuples; scalars and other
    leaves pass through). Raises when a leading size does not divide by
    the world size."""
    return _slice(batch, group)


def _sum_(tensors: Sequence[torch.Tensor], group: DataGroup) -> None:
    """All-reduce-sum in place, one flat buffer per (dtype, device)."""
    buckets: Dict = {}
    for t in tensors:
        buckets.setdefault((t.dtype, t.device), []).append(t)
    for ts in buckets.values():
        flat = torch.cat([t.reshape(-1) for t in ts])
        dist.all_reduce(flat, group=group.group)
        for t, part in zip(ts, flat.split([t.numel() for t in ts])):
            t.copy_(part.view_as(t))


def all_reduce_mean_(tensors: Sequence[torch.Tensor],
                     group: Optional[DataGroup]) -> None:
    """Average ``tensors`` over the ranks, in place: a sum, then a division
    by the world size, so that the result does not hang on the backend's
    own averaging. The identity in a world of one."""
    if group is None or group.world == 1:
        return
    _sum_(tensors, group)
    torch._foreach_div_(list(tensors), float(group.world))


def cross_rank_mean(x: torch.Tensor, group: Optional[DataGroup]
                    ) -> torch.Tensor:
    """The mean of ``x`` over the ranks, as a new tensor (JAX ``pmean``);
    ``x`` itself in a world of one."""
    if group is None or group.world == 1:
        return x
    y = x.detach().clone()
    all_reduce_mean_([y], group)
    return y


def gather_class_codes(codes: Dict[str, torch.Tensor],
                       group: Optional[DataGroup]
                       ) -> Dict[str, torch.Tensor]:
    """Each rank's code rows, (n, ...) of one shape on every rank,
    concatenated in rank order along the first axis: (world * n, ...), the
    same on every rank (JAX ``all_gather(..., tiled=True)``). Wherever
    there is a process group the rows go through its collective, a world of
    one included."""
    if group is None or group.group is None:
        return dict(codes)
    out = {}
    for k, v in codes.items():
        v = v.contiguous()
        parts = [torch.empty_like(v) for _ in range(group.world)]
        dist.all_gather(parts, v, group=group.group)
        out[k] = torch.cat(parts, 0)
    return out
