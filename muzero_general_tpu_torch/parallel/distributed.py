"""Multi-process scale-out on torch.distributed (port of
parallel/distributed.py).

The JAX package spans hosts with jax.distributed and one global mesh: XLA
inserts the collectives. The port follows PyTorch's idiom instead: one
process per device (a rank), with the collectives written out. The layout
is the JAX package's:

- **Training** is data-parallel over every rank: each rank feeds its own
  rows of the global batch (`process_local_batch`), and the gradients are
  summed over the dp group in one flattened all_reduce a step
  (trainer.Learner with a mesh). Weights are replicated on every rank.
- **Self-play** is per rank: each process runs its own SelfPlayDriver on its
  own device, feeding its own replay buffer. Games never cross ranks; only
  gradients do.
- **Counters** (played steps and games for the exact train:act ratio) are
  summed over the ranks with `global_sum`, so every rank runs the same
  number of train steps and they meet in each gradient all_reduce.

Backends are chosen explicitly, never by retrying after a failure:
"nccl" when each rank has its own card, "gloo" on the CPU or when ranks
share a card (NCCL refuses two ranks on one card), or the one the caller
names. gloo stages CUDA tensors through the host; the compute stays on the
card.

Entry: `MuZero(game, distributed={...})`, or `initialize_from_spec(True)`
for a launcher's environment. A two-process smoke of this wiring runs as
`python -m muzero_general_tpu_torch.parallel.dist_smoke`.
"""

import os
import pickle
import socket
from datetime import timedelta
from typing import Optional

import torch
import torch.distributed as dist

from muzero_general_tpu_torch.device import resolve_device

# The rank's device and the process group's backend, set by initialize().
_state = {"device": None, "backend": None}
# How long a rank waits for the others at the rendezvous and in a
# collective before it raises.
TIMEOUT = timedelta(minutes=10)
# Set to "True" where the launcher hosts the rendezvous store (torch's
# convention): then no rank hosts it.
AGENT_STORE = "TORCHELASTIC_USE_AGENT_STORE"


def _rank_device(device, local_device_ids, process_id) -> torch.device:
    """The rank's device: the CPU when `device` asks for it, else
    cuda:<local id> (local_device_ids holds this rank's one card; by
    default process_id modulo the cards on the host)."""
    if device is not None and torch.device(device).type == "cpu":
        return torch.device("cpu")
    if local_device_ids is not None:
        ids = list(local_device_ids)
        if len(ids) != 1:
            raise ValueError(f"one rank drives one device; local_device_ids={ids}")
        return resolve_device(torch.device("cuda", int(ids[0])))
    if device is not None:
        return resolve_device(device)
    resolve_device("cuda")
    return torch.device("cuda", process_id % torch.cuda.device_count())


def _shares_a_card(store, rank, world, device) -> bool:
    """Whether two ranks drive the same card: each rank writes its host
    name and card's UUID into the rendezvous store and reads the others'."""
    card = f"{socket.gethostname()}/{torch.cuda.get_device_properties(device).uuid}"
    store.set(f"muzero_card/{rank}", card)
    cards = [store.get(f"muzero_card/{r}").decode() for r in range(world)]
    return len(set(cards)) < world


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               local_device_ids=None, backend: Optional[str] = None,
               device=None) -> None:
    """Join the process group (idempotent): the counterpart of
    jax.distributed.initialize.

    coordinator_address "host:port" is rank 0's TCP rendezvous
    (tcp://host:port; the ranks meet in a TCPStore there), num_processes
    the world size and process_id this rank. Where the launcher hosts that
    store itself (TORCHELASTIC_USE_AGENT_STORE=True, as torchrun and
    `launch` set it), rank 0 connects to it as the others do. The rank's
    device is the CPU when `device` is "cpu", else its card (see
    _rank_device). `backend` None picks "gloo" for the CPU or ranks sharing
    a card and "nccl" otherwise; a named backend is used as it is.
    """
    if dist.is_initialized():
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("initialize needs coordinator_address, num_processes and process_id "
                         "(or pass distributed=True with a launcher's environment)")
    host, port = coordinator_address.rsplit(":", 1)
    rank, world = int(process_id), int(num_processes)
    rank_device = _rank_device(device, local_device_ids, rank)
    hosted = os.environ.get(AGENT_STORE) == "True"
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0 and not hosted,
                          timeout=TIMEOUT)
    if backend is None:
        backend = ("gloo" if rank_device.type == "cpu"
                   or _shares_a_card(store, rank, world, rank_device) else "nccl")
    if rank_device.type == "cuda":
        torch.cuda.set_device(rank_device)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=TIMEOUT)
    _state.update(device=rank_device, backend=backend)


def initialize_from_spec(spec, device=None) -> None:
    """`spec` is True (the launcher's environment, as env:// reads it:
    MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK and, if set, LOCAL_RANK) or
    a dict of initialize()'s arguments. `device` is the caller's device
    argument ("cpu" runs the rank on the CPU)."""
    if spec is True:
        env = os.environ
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK") if k not in env]
        if missing:
            raise ValueError(f"distributed=True reads a launcher's environment; {missing} unset")
        local = env.get("LOCAL_RANK")
        initialize(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}", int(env["WORLD_SIZE"]),
                   int(env["RANK"]), [int(local)] if local is not None else None,
                   device=device)
    elif isinstance(spec, dict):
        initialize(**{"device": device, **spec})
    else:
        raise ValueError(f"distributed spec must be True or a dict, got {spec!r}")


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def device() -> Optional[torch.device]:
    """This rank's device (None before initialize)."""
    return _state["device"]


def comm_device() -> torch.device:
    """Where host-side values (counters, objects) meet in a collective: the
    CPU for gloo, the rank's card for nccl."""
    if _state["backend"] == "nccl":
        return _state["device"]
    return torch.device("cpu")


def process_local_batch(batch: dict, mesh, batch_axis: int = 0) -> dict:
    """This rank's rows of a global dp-sharded batch, on its device: the
    counterpart of make_array_from_process_local_data.

    Every rank passes its own [B_local, ...] arrays (batch_axis 1: the
    fused-train [M, B_local, ...] stacks); together they are the global
    batch of B_local * dp rows, in rank order, that the mesh's sharded step
    trains on. With one rank per device the rank's shard is its local data,
    so nothing crosses ranks here.
    """
    if batch_axis not in (0, 1):
        raise ValueError(f"batch_axis must be 0 or 1, got {batch_axis}")
    target = device() or mesh.device
    return {k: torch.as_tensor(v).to(target) for k, v in batch.items()}


def host_store():
    """A rendezvous store hosted by this process on a free local port, for
    ranks that it starts with AGENT_STORE set: the port is the one the
    store bound, so no other process can take it first. Keep the store
    alive until the ranks have ended. Returns (store, "127.0.0.1:port")."""
    store = dist.TCPStore("127.0.0.1", 0, is_master=True, wait_for_workers=False,
                          timeout=TIMEOUT)
    return store, f"127.0.0.1:{store.port}"


def _launched(rank, fn, args, devices, address, backend, out_dir):
    os.environ[AGENT_STORE] = "True"
    if devices[rank] == "cpu":
        # Ranks on the CPU share its cores.
        torch.set_num_threads(max(1, torch.get_num_threads() // len(devices)))
    initialize(address, len(devices), rank, backend=backend, device=devices[rank])
    result = fn(*args)
    with open(os.path.join(out_dir, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)
    dist.destroy_process_group()


def launch(fn, devices, *args, backend: Optional[str] = None) -> list:
    """Run fn(*args) in one new process per entry of `devices`, as ranks of
    one process group on this host (torch.multiprocessing, start method
    spawn: CUDA may already be initialized here). Rank r runs on
    devices[r]; the ranks meet at a rendezvous store hosted here
    (host_store). `fn` must be a
    module-level function. Returns each rank's result, in rank order. If a
    rank fails, the others are stopped and its error is raised here."""
    import tempfile

    import torch.multiprocessing as mp

    devices = [str(torch.device(d)) for d in devices]
    store, address = host_store()
    with tempfile.TemporaryDirectory() as out_dir:
        mp.spawn(_launched, nprocs=len(devices), join=True,
                 args=(fn, args, devices, address, backend, out_dir))
        results = []
        for rank in range(len(devices)):
            with open(os.path.join(out_dir, f"{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def broadcast_object(obj, src: int = 0):
    """Rank `src`'s picklable `obj` on every rank."""
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=comm_device())
    return box[0]


def scatter_objects(objs, src: int = 0):
    """Rank r's entry of rank `src`'s list `objs` (one per rank; the other
    ranks pass None)."""
    box = [None]
    dist.scatter_object_list(box, objs if dist.get_rank() == src else None, src=src)
    return box[0]


def gather_objects(obj, dst: int = 0):
    """Every rank's `obj`, in rank order, on rank `dst` (None elsewhere)."""
    out = [None] * dist.get_world_size() if dist.get_rank() == dst else None
    dist.gather_object(obj, out, dst=dst)
    return out


def global_sum(value) -> float:
    """Sum a rank's scalar over all ranks, in float64 (played-steps
    counters for the exact ratio; the reference keeps these in
    SharedStorage, shared_storage.py:24-43)."""
    if process_count() == 1:
        return float(value)
    total = torch.tensor([float(value)], dtype=torch.float64, device=comm_device())
    dist.all_reduce(total)
    return float(total.item())
