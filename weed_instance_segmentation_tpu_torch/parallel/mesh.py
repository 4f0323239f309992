"""Process groups, the ``('data',)`` / ``('data', 'model')`` layout, and the
collectives of data-parallel and model-sharded training.

Port of ``weed_instance_segmentation_tpu/parallel/mesh.py``. JAX runs one
controller over a mesh of devices; the port runs one process per device
(a "rank") in PyTorch's own idiom:

- ``maybe_initialize_distributed`` joins the ranks into one
  ``torch.distributed`` process group, from ``WISTPU_COORDINATOR`` /
  ``WISTPU_NUM_PROCESSES`` / ``WISTPU_PROCESS_ID`` or from ``torchrun``'s
  environment (``WISTPU_MULTIHOST=auto``). The backend is ``nccl`` where
  each rank of a host has a card of its own, ``gloo`` where ranks share a
  card or run on the CPU.
- ``create_mesh(dp, mp)`` lays the ranks out as a ``DeviceMesh``:
  ``('data',)`` when ``mp`` is 1, else ``('data', 'model')`` with 'model'
  minor (rank = d·mp + m). Ranks of one model group feed the same rows, as
  the JAX package replicates the batch over 'model'.
- ``wrap_model``: ``DistributedDataParallel`` on the 1-D layout; FSDP2
  ``fully_shard`` on the 2-D one, which is hybrid sharding: parameters and
  AdamW moments sharded over 'model' and replicated over 'data'.

The layout of a sharded parameter differs from the JAX package's: its
``model_spec`` splits each leaf's largest divisible axis and replicates
leaves under 2¹⁴ elements (a hint to GSPMD), while FSDP2 splits dim 0 of
every parameter. The math does not differ: every rank computes with the
whole parameter, and the saves gather full tensors (``full_tensor``), so
the on-disk format is the same either way.

Every function here that moves data between ranks is a collective: every
rank calls it at the same point, as ``fetch_tree`` and ``gather_pyobjects``
are in JAX. A collective that fails raises; nothing falls back.
"""

from __future__ import annotations

import contextlib
import os
from datetime import timedelta
from typing import Callable, Iterable, Iterator

import torch
import torch.distributed as dist

# the collectives' timeout: long enough for the first step's kernel builds
TIMEOUT = timedelta(minutes=30)


def maybe_initialize_distributed(device: str | torch.device = 'cuda',
                                 timeout: timedelta = TIMEOUT) -> bool:
    """Join this process to the run's process group, where the environment
    names one; returns whether more than one process runs. Idempotent.

    - ``WISTPU_COORDINATOR=host:port`` with ``WISTPU_NUM_PROCESSES`` and
      ``WISTPU_PROCESS_ID``: ``init_process_group('tcp://host:port', ...)``;
    - ``WISTPU_MULTIHOST=auto``: the ``torchrun`` environment
      (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``).

    With neither, nothing is initialised and the run is one process. On a
    CUDA ``device`` each rank takes the card ``local rank % cards`` with
    ``torch.cuda.set_device``."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    coordinator = os.environ.get('WISTPU_COORDINATOR')
    if coordinator:
        kwargs = dict(init_method=f'tcp://{coordinator}',
                      world_size=int(os.environ['WISTPU_NUM_PROCESSES']),
                      rank=int(os.environ['WISTPU_PROCESS_ID']))
    elif os.environ.get('WISTPU_MULTIHOST') == 'auto':
        kwargs = dict(init_method='env://')
    else:
        return False
    world = int(kwargs.get('world_size', os.environ.get('WORLD_SIZE', 1)))
    rank = int(kwargs.get('rank', os.environ.get('RANK', 0)))
    local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
    local_rank = int(os.environ.get('LOCAL_RANK', rank))
    backend = 'gloo'
    if torch.device(device).type == 'cuda':
        cards = torch.cuda.device_count()
        if cards == 0:
            raise RuntimeError('maybe_initialize_distributed: no CUDA device is available')
        torch.cuda.set_device(local_rank % cards)
        # NCCL refuses two ranks on one card; gloo carries CUDA tensors too
        backend = 'nccl' if local_world <= cards else 'gloo'
    dist.init_process_group(backend, timeout=timeout, **kwargs)
    return dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_main() -> bool:
    """Whether this process writes the run's files: rank 0, or the only
    process."""
    return process_index() == 0


def barrier() -> None:
    if process_count() > 1:
        dist.barrier()


def rank_device(device: str | torch.device) -> torch.device:
    """``device`` as this rank uses it: a CUDA device resolves to the card
    ``maybe_initialize_distributed`` set (``torch.device('cuda')`` alone
    would mean the current card of whoever reads it)."""
    device = torch.device(device)
    if device.type == 'cuda' and device.index is None and dist.is_initialized():
        return torch.device('cuda', torch.cuda.current_device())
    return device


def create_mesh(data_parallel: int | None = None, model_parallel: int | None = None,
                device: str | torch.device = 'cuda'):
    """The ranks as a ``DeviceMesh``: ``('data',)`` of ``dp`` ranks when
    ``model_parallel`` is at most 1, else ``('data', 'model')`` of dp × mp
    with 'model' minor. ``data_parallel=None`` takes every rank left by
    the model axis. dp × mp must equal the number of processes (the JAX
    package leaves surplus devices idle; here a surplus process would have
    nothing to do). One process with dp = mp = 1 has no mesh: None."""
    mp = max(model_parallel or 1, 1)
    world = process_count()
    dp = data_parallel or max(world // mp, 1)
    if dp * mp != world:
        raise ValueError(f'mesh {dp}x{mp} needs {dp * mp} processes; this run has {world}')
    if world == 1:
        return None
    from torch.distributed.device_mesh import init_device_mesh

    device_type = torch.device(device).type
    if mp == 1:
        return init_device_mesh(device_type, (dp,), mesh_dim_names=('data',))
    return init_device_mesh(device_type, (dp, mp), mesh_dim_names=('data', 'model'))


def data_parallel_size(mesh) -> int:
    return 1 if mesh is None else mesh.size(0)


def data_coordinate(mesh) -> tuple[int, int]:
    """(this rank's coordinate on 'data', the axis size): which rows of
    each global batch the rank feeds, and in how many parts the batch is
    cut. Ranks of one model group share the coordinate."""
    if mesh is None:
        return 0, 1
    return mesh.get_local_rank('data'), mesh.size(0)


def wrap_model(model: torch.nn.Module, mesh, device: torch.device) -> torch.nn.Module:
    """``model`` as the train step drives it on ``mesh``: itself with no
    mesh; ``DistributedDataParallel`` on the 1-D layout; sharded in place by
    FSDP2 ``fully_shard`` on the 2-D one (hybrid: shards over 'model',
    replicas over 'data').

    ``find_unused_parameters`` stays False: every parameter of the model
    reaches the loss on every micro-step (a drop-path branch whose scale is
    0 is still multiplied in, not skipped), so each gets a gradient, and
    the search would cost a graph walk a step
    (``tests/test_torch_parallel.py`` holds this). The buffers are
    constants, identical on every rank (no batch statistics are updated),
    so DDP does not broadcast them on each forward."""
    if mesh is None:
        return model
    if mesh.ndim == 1:
        from torch.nn.parallel import DistributedDataParallel

        return DistributedDataParallel(
            model, device_ids=[device] if device.type == 'cuda' else None,
            process_group=mesh.get_group('data'), broadcast_buffers=False,
            find_unused_parameters=False)
    from torch.distributed.fsdp import fully_shard

    return fully_shard(model, mesh=mesh)


def is_ddp(model: torch.nn.Module) -> bool:
    from torch.nn.parallel import DistributedDataParallel

    return isinstance(model, DistributedDataParallel)


def unwrap(model: torch.nn.Module) -> torch.nn.Module:
    """The module under a DDP wrapper (its parameter names carry no
    ``module.`` prefix); an FSDP2 module is its own."""
    return model.module if is_ddp(model) else model


def no_grad_sync(model: torch.nn.Module, sync: bool):
    """The context of a micro-step's forward and backward: under DDP, one
    that does not all-reduce the gradients unless ``sync``; otherwise none.
    (FSDP2 reduce-scatters on every micro-step: see engine/steps.py.)"""
    if is_ddp(model) and not sync:
        return model.no_sync()
    return contextlib.nullcontext()


def is_sharded(tensor: torch.Tensor) -> bool:
    """Whether ``tensor`` is a ``DTensor``, as FSDP2 keeps its parameters,
    gradients and AdamW moments."""
    from torch.distributed.tensor import DTensor

    return isinstance(tensor, DTensor)


def full_tensor(tensor: torch.Tensor) -> torch.Tensor:
    """The whole tensor of a sharded ``DTensor`` (a collective over its
    mesh), or ``tensor`` itself."""
    return tensor.full_tensor() if is_sharded(tensor) else tensor


def fetch_state(items: Iterable[tuple[str, torch.Tensor]]) -> Iterator[tuple[str, torch.Tensor]]:
    """Each (name, tensor) with the tensor whole, for a rank-0 write: the
    JAX ``fetch_tree``. Gathering a sharded tensor is a collective, so every
    rank walks the same items in the same order, one at a time."""
    for name, tensor in items:
        yield name, full_tensor(tensor)


def like_parameter(param: torch.Tensor, whole: torch.Tensor) -> torch.Tensor:
    """``whole`` (a full tensor every rank holds) in ``param``'s layout:
    this rank's shard where ``param`` is a ``DTensor``."""
    if is_sharded(param):
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(whole, param.device_mesh, param.placements)
    return whole


def rank_mean(tensor: torch.Tensor) -> torch.Tensor:
    """The mean of ``tensor`` over every rank, outside autograd; ``tensor``
    itself with one process. (Ranks of one model group hold the same
    value, so this is also the mean over the data ranks.)"""
    if process_count() == 1:
        return tensor
    with torch.no_grad():
        out = tensor.detach().clone()
        dist.all_reduce(out)
        return out / dist.get_world_size()


def loss_normalisers(global_sum: Callable[[torch.Tensor], torch.Tensor],
                     ranks: int) -> dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """The criterion's normaliser hooks (``losses/criterion.py``) that make
    each rank's loss its rows' share of the global-batch loss:
    ``num_masks_reduce`` gives max(Σ_ranks count, 1) / W and
    ``class_weight_reduce`` max(Σ_ranks Σw, 1e-8) / W, the sums taken by
    ``global_sum`` over the W = ``ranks`` data ranks. The gradients that
    DDP or FSDP2 then average over ranks are those of the JAX program's
    global-batch loss. Clamping before dividing keeps a batch with fewer
    targets than ranks at the JAX ``max(global, 1)``. Neither count is
    differentiated, so the sums stay outside autograd."""
    def reducer(floor: float):
        def reduce(local: torch.Tensor) -> torch.Tensor:
            with torch.no_grad():
                return global_sum(local.detach()).clamp(min=floor) / ranks
        return reduce

    return {'num_masks_reduce': reducer(1.0), 'class_weight_reduce': reducer(1e-8)}


def loss_reducers(mesh) -> dict[str, Callable[[torch.Tensor], torch.Tensor]]:
    """:func:`loss_normalisers` over ``mesh``'s data axis (an all-reduce in
    each rank's 'data' group: a model group counts its rows once); empty
    without a data axis above 1."""
    dp = data_parallel_size(mesh)
    if dp == 1:
        return {}
    group = mesh.get_group('data')

    def all_reduce_sum(local: torch.Tensor) -> torch.Tensor:
        total = local.clone()
        dist.all_reduce(total, group=group)
        return total

    return loss_normalisers(all_reduce_sum, dp)


def gather_pyobjects(obj) -> list:
    """One picklable object from each process, in process order, on every
    process (``all_gather_object``). For small host-side state, such as the
    per-image metric entries of the sharded test phase."""
    if process_count() == 1:
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def broadcast_pyobject(obj):
    """Rank 0's ``obj`` on every process."""
    if process_count() == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=0)
    return box[0]


def rand_rows(shape: tuple, generator: torch.Generator | None, device: torch.device,
              shard: tuple[int, int] | None = None, dim: int = 0) -> torch.Tensor:
    """Uniform [0, 1) float32 of ``shape`` on ``device``. With ``shard`` =
    (index, count) they are part ``index`` along ``dim`` of one draw
    ``count`` times as large: each data rank draws the global shape and
    keeps its own rows, so W ranks see exactly the numbers one process
    draws for the whole batch (and ranks of one model group the same ones).
    The cost is W× a few small uniforms."""
    source = generator.device if generator is not None else device
    if shard is None or shard[1] == 1:
        return torch.rand(shape, generator=generator, device=source).to(device)
    index, count = shard
    full = list(shape)
    full[dim] *= count
    draw = torch.rand(full, generator=generator, device=source)
    return draw.narrow(dim, index * shape[dim], shape[dim]).to(device)
