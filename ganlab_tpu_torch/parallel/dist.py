"""Data parallelism over processes with ``torch.distributed``.

Port of ``ganlab_tpu/parallel/mesh.py``. The JAX package runs one program
over a 1-D device mesh (``shard_map``): the state is replicated, the batch
sharded on its leading axis, and the step's ``pmean`` calls are its only
communication. Here each card is one process (``torchrun --nproc-per-node
N``, which sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``), each process
holds a whole replica of the state on ``cuda:LOCAL_RANK`` and feeds its
own shard of the batch, and the step (``train/steps.py``) averages across
the processes exactly what the JAX step averages across the mesh: D's and
G's gradients after their backward passes (one flat all-reduce a network
an update, not one a parameter), the metrics, the batch mean of w that
moves the w-average, the mean path length that moves ``pl_mean`` and the
mean sign of D's scores that moves ADA's ``ada_p``. So
every replica makes the same update and the states stay identical, the
step's random generator included (each rank's draws come from the state's
generator and its rank: ``train/steps.py::fork_generators``).

``DistributedDataParallel`` is not used: the D and G updates alternate
within a step, R1 and path length differentiate through a first backward
(``create_graph=True``), and gradient accumulation runs several backward
passes per update, none of which fits DDP's one-backward-one-reduction
hooks; the all-reduce after the last backward of an update is the JAX
step's ``pmean`` at the same place.

Chunked stepping (``run.chunk_steps``; ``train/steps.py::
make_chunked_stepper``) works the same under a process group: each rank
stacks its own k batches (the JAX package's ``shard_stack``), every rank
walks the same cycle from the same step counter, and the off-run's steps
run one after another, each with its all-reduces (no CUDA graph: a
collective of the group and ``fork_generators``' host read of the
generator stay outside one).

One process (``WORLD_SIZE`` unset or 1) initializes nothing, and every
function here is then a no-op. A failing initialization raises: nothing
falls back to one process or to the CPU. The backend is the caller's:
``nccl`` where each rank has a card of its own (the CLI's default on
CUDA), ``gloo`` on the CPU and where ranks share a card (NCCL refuses two
ranks on one device).
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(backend: str | None = None, *,
               device: str | torch.device | None = None,
               rank: int | None = None, world_size: int | None = None,
               init_method: str | None = None) -> torch.device:
    """Join the process group and return this rank's device.

    ``rank`` / ``world_size`` / ``init_method`` default to the ``torchrun``
    environment (``RANK``, ``WORLD_SIZE``, ``env://``). With a world of
    one nothing is initialized and ``device`` (default ``cuda``) comes
    back as given. Otherwise ``device`` defaults to ``cuda:LOCAL_RANK``
    (which becomes the current device) and ``backend`` to ``nccl`` on
    CUDA and ``gloo`` on the CPU; pass ``device`` to place ranks
    yourself (two ranks sharing ``cuda:0`` with ``gloo``, as
    ``chip_smoke.py`` does)."""
    world = int(os.environ.get("WORLD_SIZE", "1")) if world_size is None \
        else int(world_size)
    if world <= 1:
        return torch.device("cuda" if device is None else device)
    rank = int(os.environ["RANK"]) if rank is None else int(rank)
    if device is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: device 'cuda' requested but "
                               "torch.cuda.is_available() is false")
        if device.index is not None:
            torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if dist.is_initialized():
        raise RuntimeError("initialize: a process group already exists")
    dist.init_process_group(backend, init_method=init_method or "env://",
                            rank=rank, world_size=world)
    return device


def shutdown() -> None:
    """Leave the process group, if one was joined."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    """The number of replicas: 1 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank() -> int:
    """This replica's rank: 0 without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _groups(tensors):
    """Tensors grouped by (device, dtype), in first-seen order."""
    groups: dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    return groups.values()


def _flat_collective(tensors, collective) -> None:
    """Run ``collective`` on one flat buffer per (device, dtype) group of
    ``tensors`` (on a CUDA device under NCCL, which takes no other) and
    copy the result back into them."""
    for group in _groups(tensors):
        flat = torch.cat([t.reshape(-1) for t in group])
        if dist.get_backend() == "nccl" and flat.device.type != "cuda":
            flat = flat.to(torch.device("cuda", torch.cuda.current_device()))
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_mean_(tensors) -> None:
    """Replace each tensor by its mean over the replicas, in place: one
    all-reduce of a flat buffer per (device, dtype) group. A no-op with
    one replica."""
    n = world_size()
    if n == 1:
        return

    def mean_of(flat):
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        flat.div_(n)

    _flat_collective(list(tensors), mean_of)


def mean(x: torch.Tensor) -> torch.Tensor:
    """A new tensor holding x's mean over the replicas (x itself with one
    replica)."""
    if world_size() == 1:
        return x
    out = x.detach().clone()
    all_reduce_mean_([out])
    return out


def all_reduce_grads_(module: torch.nn.Module) -> None:
    """Average the gradients of ``module``'s parameters over the replicas
    (those that have one: the same set on every replica)."""
    all_reduce_mean_(p.grad for p in module.parameters()
                     if p.grad is not None)


def broadcast_(tensors, src: int = 0) -> None:
    """Overwrite each tensor with rank ``src``'s, in place: one broadcast
    of a flat buffer per (device, dtype) group. A no-op with one
    replica."""
    if world_size() > 1:
        _flat_collective(list(tensors),
                         lambda flat: dist.broadcast(flat, src=src))


def broadcast_state(state, src: int = 0) -> None:
    """Make every replica's ``TrainState`` rank ``src``'s: the parameters
    of G, D and G-EMA, both Adams' states, the w-average, ``pl_mean`` and
    ``ada_p``, the generator's state and the counters. Run once after the state is made
    or restored, so that every replica starts identical."""
    if world_size() == 1:
        return
    from ganlab_tpu_torch.train.state import state_tensors

    named = state_tensors(state)
    gen = named.pop("generator")            # a copy: written back below
    counters = named.pop("counters")
    named = {k: v for k, v in named.items() if isinstance(v, torch.Tensor)}
    with torch.no_grad():
        broadcast_([*named.values(), gen, counters], src=src)
    state.generator.set_state(gen)
    state.step, state.shown_imgs, state.opt_step0 = \
        (int(v) for v in counters.tolist())


def barrier() -> None:
    """Wait for every replica (nothing with one)."""
    if world_size() > 1:
        dist.barrier()
