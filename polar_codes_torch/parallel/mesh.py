"""The simulator's data parallelism in PyTorch idiom.

The port of polar_codes_tpu/parallel/mesh.py. The JAX package shards the
codeword batch over a device mesh inside one program and psums the
counters; here each device is driven by its own process (`torchrun`, one
process per card), every rank runs the same job on its own batch with its
own generator, and the int64 error counters are all-reduced (SUM) over the
process group: NCCL on the card, gloo on the CPU. Codec kernels never
communicate; all collective use is in this layer.

Without a process group every function here is the identity (host_aggregate
only maps its values to NumPy): one process on one device.
"""

from __future__ import annotations

import os
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist


class GroupSum(torch.Tensor):
    """A counter that sharded_counter_step has all-reduced over the process
    group: its value is the same on every rank. torch hands the subclass on
    through every operation on it (.cpu(), .clone(), .to(), arithmetic,
    torch.stack), so a value computed from such counters stays a GroupSum,
    as a JAX global array stays global. An operation that mixes a GroupSum
    with a rank's own tensor returns a GroupSum as well; keep such mixes out
    of what host_aggregate is given. A Python number taken from one
    (.item(), int()) is a rank's own value again."""


def _group_active() -> bool:
    return dist.is_available() and dist.is_initialized()


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None,
                     device="cuda") -> Optional[torch.device]:
    """Join the process group; returns this rank's device, or None when
    there is no group to join.

    With no init_method, the group is read from the environment that
    `torchrun` sets (env://: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK);
    without WORLD_SIZE there it joins nothing. Otherwise pass the address
    (e.g. "tcp://localhost:29500"), world size and rank. The backend is
    NCCL for a CUDA device, each rank on card LOCAL_RANK (else its rank),
    and gloo for the CPU."""
    dev = torch.device(device)
    if _group_active():
        return _local_device(dev)
    if init_method is None:
        if "WORLD_SIZE" not in os.environ:
            return None
        init_method = "env://"
    kwargs = {}
    if world_size is not None:
        kwargs["world_size"] = int(world_size)
    if rank is not None:
        kwargs["rank"] = int(rank)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank if rank is not None else 0))
        torch.cuda.set_device(local)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, **kwargs)
    return _local_device(dev)


def _local_device(dev: torch.device) -> torch.device:
    if dev.type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def default_mesh(n_devices: Optional[int] = None, device="cuda") -> List[torch.device]:
    """The devices of the process group, one per rank, in rank order;
    [device] without a group. n_devices, when given, must equal the world
    size: the port runs one process per device."""
    dev = torch.device(device)
    if _group_active():
        devices: List[Optional[str]] = [None] * dist.get_world_size()
        dist.all_gather_object(devices, str(_local_device(dev)))
        mesh = [torch.device(d) for d in devices]
    else:
        mesh = [dev]
    if n_devices is not None and int(n_devices) != len(mesh):
        raise ValueError(
            f"--devices {n_devices} asks for {n_devices} devices, but the process "
            f"group has {len(mesh)}; run one process per device (torchrun "
            f"--nproc-per-node {n_devices})")
    return mesh


def distribute_keys(seed: int, rank: Optional[int] = None) -> int:
    """This rank's generator seed for a step seeded `seed`: rank 0 keeps
    the seed, so one rank reproduces the job without a group, and rank r > 0
    takes numpy's SeedSequence([seed, r]). `rank` defaults to this process's
    rank (0 without a group)."""
    if rank is None:
        rank = dist.get_rank() if _group_active() else 0
    if rank == 0:
        return int(seed)
    return int(np.random.SeedSequence([int(seed), int(rank)]).generate_state(1, np.uint64)[0])


def sharded_counter_step(step_fn: Callable[..., Dict[str, torch.Tensor]]):
    """Lift a one-device step into a group-wide one: step_fn(*args) runs on
    this rank's device and returns scalar integer counters; the lifted
    function stacks them into one int64 tensor, all-reduces it (SUM) over
    the group and returns the summed counters as GroupSum tensors. Without
    a group it is step_fn."""
    if not _group_active():
        return step_fn

    def lifted(*args):
        stats = step_fn(*args)
        names = list(stats)
        packed = torch.stack([stats[k].to(torch.int64).reshape(()) for k in names])
        dist.all_reduce(packed, op=dist.ReduceOp.SUM)
        return dict(zip(names, packed.as_subclass(GroupSum).unbind()))

    return lifted


def _tree_map(fn, tree):
    """fn on every leaf of nested dicts, lists and tuples (None stays)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return None if tree is None else fn(tree)


def _to_numpy(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


def host_aggregate(tree):
    """Every value of a nested dict, list or tuple as NumPy on this rank.

    Without a process group, or in a group of one, each value is mapped to
    NumPy. In a larger group a GroupSum (a counter that sharded_counter_step
    returned, or a tensor computed from such counters) is already the
    group's sum, the same on every rank, and is read locally: torch has no
    counterpart of a global array's "not fully addressable" state that
    tells the JAX package the same, so the type says it. Any other value is
    this rank's own and is gathered from every rank (all_gather_object),
    stacked on a new leading axis in rank order, as process_allgather
    stacks it. Every rank must call it with the same tree."""
    if not _group_active() or dist.get_world_size() == 1:
        return _tree_map(_to_numpy, tree)

    def to_host(value):
        if isinstance(value, GroupSum):
            return _to_numpy(value)
        gathered = [None] * dist.get_world_size()
        dist.all_gather_object(gathered, _to_numpy(value))
        return np.stack(gathered)

    return _tree_map(to_host, tree)
