"""Serving mesh over a world of ranks (the reference's
src/repro/launch/mesh.py, serving subset), and how ranks start.

The reference is single-controller: one process sees every device and
``jax.make_mesh`` lays them out. The port is SPMD: one process per rank,
joined by ``torch.distributed``. A ``ServingMesh`` is one rank's view of
the 2-D ("data", "model") layout of W = D x M ranks: the sizes D and M,
this rank's coordinates (d, m) with rank = d * M + m, its device, and one
process group per axis ("model": the ranks with the same d; "data": the
ranks with the same m; both: the whole world). A rank's position in its
"model" group is m, so an all-gather over "model" concatenates the head
groups in the reference's head-major order.

Backend and device, chosen from the facts: a rank on the card takes
``cuda:(local_rank % device_count)``; NCCL when every rank of the host
has a card of its own, gloo when ranks share a card (two ranks on one
H100) or run on the CPU. Every collective has the timeout given to
``init_process_group``.

Starting ranks: ``init_from_env`` reads torchrun's environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` /
``MASTER_PORT``); ``spawn_ranks`` starts W ranks with
``torch.multiprocessing`` and a ``file://`` store in a temporary directory
(no TCP port to race for), and raises if a rank fails or outlives its
timeout.

With ``model`` <= 1 on a world of W > 1 ranks the mesh is the 1-D
("data",) mesh: a ``ServingMesh`` of shape (W, 1) whose ``axis_names`` are
("data",), as the reference reports them. Every rank holds the whole
replicated cache and encodes its rows of each flush
(``models/vit.py::encode_tokens``, under ``sharding.DATA_RULES``).

Not ported yet (ROADMAP.md A14, LM half): ``make_production_mesh`` (TPU
pods) and ``make_host_mesh``.
"""

from __future__ import annotations

import datetime
import os
import tempfile
import time
from dataclasses import dataclass, field

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

__all__ = ["ServingMesh", "make_serving_mesh", "choose_backend",
           "rank_device", "init_rank", "init_from_env",
           "spawn_ranks", "DEFAULT_TIMEOUT_S"]

# the timeout of every collective (init_process_group) and of spawn_ranks
DEFAULT_TIMEOUT_S = 300.0


@dataclass
class ServingMesh:
    """One rank's view of the (data, model) serving mesh."""

    data: int                  # D: ranks along "data"
    model: int                 # M: ranks along "model"
    d: int                     # this rank's coordinate along "data"
    m: int                     # ... and along "model"
    device: torch.device
    backend: str
    groups: dict = field(repr=False)   # axes tuple -> process group
    # the mesh's axes as the reference names them: ("data",) for the 1-D
    # data mesh (model = 1), else ("data", "model")
    axis_names: tuple = ("data", "model")

    @property
    def shape(self) -> dict[str, int]:
        sizes = {"data": self.data, "model": self.model}
        return {ax: sizes[ax] for ax in self.axis_names}

    @property
    def world(self) -> int:
        return self.data * self.model

    def coord(self, axis: str) -> int:
        return {"data": self.d, "model": self.m}[axis]

    def group(self, axes):
        """The process group of one mesh axis or of a tuple of them."""
        key = (axes,) if isinstance(axes, str) else tuple(axes)
        if set(key) == {"data", "model"}:
            key = ("data", "model")
        return self.groups[key]


def choose_backend(device_type: str, local_world: int) -> tuple[str, str]:
    """(backend, why): NCCL when each of the host's ``local_world`` ranks
    has a card of its own; gloo when ranks share a card or run on the
    CPU."""
    if device_type == "cpu":
        return "gloo", "ranks on the CPU"
    n = torch.cuda.device_count()
    if local_world <= n:
        return "nccl", f"{local_world} ranks on {n} cards, one card each"
    return "gloo", (f"{local_world} ranks share {n} card(s): NCCL refuses "
                    f"two ranks on one device")


def rank_device(device=None) -> torch.device:
    """This rank's device: ``cuda:(LOCAL_RANK % device_count)`` for the card
    (the default; raises without one), or the CPU when asked."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return dev
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def init_rank(rank: int, world: int, init_method: str, device=None,
              local_world: int | None = None,
              timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the process group as ``rank`` of ``world`` with the backend the
    facts call for; returns this rank's device. ``LOCAL_RANK`` (default
    ``rank``) picks the card; ``local_world`` (default ``world``) is the
    number of ranks on this host. Rank 0 prints the backend it took. A
    rank on the CPU runs one intra-op thread."""
    os.environ.setdefault("LOCAL_RANK", str(rank))
    dev = rank_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    else:
        # ranks on the CPU share the host's cores: more than one intra-op
        # thread each oversubscribes them
        torch.set_num_threads(1)
    backend, why = choose_backend(dev.type, world if local_world is None
                                  else local_world)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    if rank == 0:
        print(f"[mesh] {world} ranks, backend {backend} ({why})", flush=True)
    return dev


def init_from_env(device=None, timeout_s: float = DEFAULT_TIMEOUT_S
                  ) -> torch.device | None:
    """Join the process group torchrun describes in the environment; None
    (and nothing joined) when ``WORLD_SIZE`` is unset or 1."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    return init_rank(int(os.environ["RANK"]), world, "env://", device,
                     int(os.environ.get("LOCAL_WORLD_SIZE", world)),
                     timeout_s)


def make_serving_mesh(model: int = 1, device=None) -> ServingMesh | None:
    """Serving mesh over every rank of the process group, or None without
    one (or with a world of 1 and ``model`` <= 1).

    ``model <= 1`` on W > 1 ranks: the 1-D ("data",) mesh of shape (W, 1):
    the encode batch data-parallelizes (distributed.sharding.DATA_RULES),
    params replicate, each rank encodes a slice of the micro-batch.

    ``model > 1``: the 2-D ("data", "model") mesh of shape (W // model,
    model): attention heads and the FFN hidden dim shard over "model"
    (distributed.sharding.MODEL_RULES), the batch over "data". Raises when
    the world cannot host the requested model axis (silent clamping would
    change which kernels run). Every rank must call this, in the same
    order: each builds every group of the mesh."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    if model > 1:
        if model > n:
            raise ValueError(f"model={model} shards need at least {model} "
                             f"devices, have {n}")
        if n % model != 0:
            raise ValueError(f"device count {n} is not divisible by "
                             f"model={model}")
        return _build_mesh(n // model, model, device)
    if n < 2:
        return None
    return _build_mesh(n, 1, device, axis_names=("data",))


def _build_mesh(n_data: int, n_model: int, device,
                axis_names: tuple = ("data", "model")) -> ServingMesh:
    rank = dist.get_rank()
    d, m = divmod(rank, n_model)
    groups = {}
    # every rank creates every group, in the same order
    for dd in range(n_data):
        g = dist.new_group([dd * n_model + mm for mm in range(n_model)])
        if dd == d:
            groups[("model",)] = g
    for mm in range(n_model):
        g = dist.new_group([dd * n_model + mm for dd in range(n_data)])
        if mm == m:
            groups[("data",)] = g
    groups[("data", "model")] = dist.group.WORLD
    return ServingMesh(n_data, n_model, d, m, rank_device(device),
                       dist.get_backend(), groups, axis_names)


def _rank_entry(rank: int, fn, world: int, store: str, device, timeout_s,
                args: tuple, out_dir: str) -> None:
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    init_rank(rank, world, f"file://{store}", device, world, timeout_s)
    try:
        result = fn(*args)
        torch.save(result, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def spawn_ranks(fn, world: int, *args, device=None,
                timeout_s: float = DEFAULT_TIMEOUT_S) -> list:
    """Run ``fn(*args)`` on ``world`` fresh ranks joined by a process group
    (``device``: the card, the default, or ``"cpu"``); returns each rank's
    result in rank order. ``fn`` must be importable by name (a module-level
    function) and its result picklable. Raises if a rank raises or dies,
    and ``TimeoutError`` (after killing every rank) if they have not all
    finished within ``timeout_s``."""
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, world, os.path.join(tmp, "store"),
                               device, timeout_s, args, tmp),
            nprocs=world, join=False, start_method="spawn")
        deadline = time.monotonic() + timeout_s
        try:
            while not ctx.join(timeout=0.5):
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{world} ranks did not finish "
                                       f"within {timeout_s:.0f}s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
                p.join(10)
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(world)]
