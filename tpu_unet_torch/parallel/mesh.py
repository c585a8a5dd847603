"""Process groups, the device mesh, the rank launcher and data placement
(counterpart of ``tpu_unet/parallel/mesh.py``).

The JAX package runs one program over a ``('data', 'space'[, 'model'])``
device mesh and lets GSPMD place the batch and insert the collectives. The
port runs the PyTorch way: one process per device (a rank), joined by a
``torch.distributed`` process group, NCCL for ``cuda`` and gloo for ``cpu``,
chosen from the device type and never swapped in silently. A run over W
ranks computes what the JAX package computes on a W-device mesh: data rank d
holds the d-th contiguous block of each global batch (:func:`shard_batch`,
``data/loader.py``), space rank s the s-th block of its rows
(``parallel/spatial.py``), BatchNorm takes the global batch's statistics
(``models/blocks.py``), the losses divide by global denominators
(``losses/reduction.py``) and the steps average the gradients over the
batch group (``train/steps.py``).

- :func:`make_mesh`: the ``'data'`` :class:`DeviceMesh` over the ranks of
  the process group, or with ``n_space > 1`` or ``n_model > 1`` the 3-axis
  ``('data', 'space', 'model')`` mesh, ranks in JAX's ``reshape(n_data,
  n_space, n_model)`` order: rank = (d * n_space + s) * n_model + m. None
  for one process without a group (the plain path).
- :func:`data_rank`, :func:`data_size`, :func:`space_rank`,
  :func:`space_size`, :func:`model_rank`, :func:`model_size`: this rank's
  coordinates on the mesh :func:`make_mesh` built last (a size is 1 where
  the axis is absent). Everything that splits or gathers a batch keys on
  the data coordinate, so every (space, model) rank of data index d holds
  the same images.
- :func:`group_of`: the batch group (the data x space ranks of one model
  index), over which BatchNorm, the losses' denominators, the confusion
  matrices and the gradient mean reduce; :func:`space_group` the ranks that
  split one image's rows.
- :func:`maybe_initialize`: joins a group launched by hand
  (``--coordinator_address``/``--num_processes``/``--process_id``) or by
  torchrun or SLURM (``--multihost``).
- :func:`launch`: ``--n_devices N`` (times ``--n_space S`` times
  ``--n_model K``) runs a function on N S K local ranks
  (``torch.multiprocessing``, start method ``spawn``, a free port on
  127.0.0.1), one per GPU, and returns rank 0's result.
"""

from __future__ import annotations

import datetime
import os
import pickle
import socket
import tempfile
from typing import Any, Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
SPACE_AXIS = "space"
MODEL_AXIS = "model"

_ENV_TORCHRUN = ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
_ENV_SLURM = ("SLURM_PROCID", "SLURM_NTASKS")
# Collectives of a group that waits for a slow rank (a checkpoint written
# by rank 0, a first CUDA build) must not time out before the work ends.
_TIMEOUT = datetime.timedelta(minutes=30)


def backend_for(device_type: str) -> str:
    """The process-group backend of a device type: NCCL for ``cuda``, gloo
    for ``cpu``."""
    return "nccl" if device_type == "cuda" else "gloo"


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_main_process() -> bool:
    """Rank 0, or a process outside any group: the one that prints and writes."""
    return rank() == 0


# The mesh make_mesh built last: its 'space' and 'model' widths and sub-groups.
_MESH = {"n_space": 1, "n_model": 1, "data": None, "space": None, "model": None,
         "batch": None}


def model_size() -> int:
    """Ranks per tensor-parallel group (1 without tensor parallelism)."""
    return _MESH["n_model"]


def model_rank() -> int:
    """This rank's index on the 'model' axis."""
    return rank() % model_size()


def space_size() -> int:
    """Ranks that split one image's rows (1 without the 'space' axis)."""
    return _MESH["n_space"]


def space_rank() -> int:
    """This rank's index on the 'space' axis: the block of rows it holds."""
    return rank() // model_size() % space_size()


def data_size() -> int:
    """Ranks on the 'data' axis: the number of distinct batch blocks."""
    return world_size() // (space_size() * model_size())


def data_rank() -> int:
    """This rank's index on the 'data' axis: the block of each batch it holds."""
    return rank() // (space_size() * model_size())


def data_coords(mesh) -> Tuple[int, int]:
    """``(data ranks, this rank's data index)`` of ``mesh`` itself, (1, 0)
    for None: a loader's ``process_count``/``process_index`` that does not
    depend on which mesh was made last."""
    if mesh is None:
        return 1, 0
    return mesh.size(0), mesh.get_local_rank(DATA_AXIS)


def data_group():
    """The 'data' sub-group of a 3-axis mesh; None (the default group)
    otherwise."""
    return _MESH["data"]


def space_group():
    """The 'space' sub-group of a mesh with a 'space' axis; None otherwise."""
    return _MESH["space"]


def model_group():
    """The 'model' sub-group of a tensor-parallel mesh; None otherwise."""
    return _MESH["model"]


def barrier() -> None:
    """Wait for every rank of the group (no-op without one)."""
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()


def visible_devices(device_type: str = "cuda") -> List[torch.device]:
    """The devices a local launch can give its ranks: every visible GPU for
    ``cuda``; for ``cpu`` one device, which any number of ranks share."""
    if device_type == "cuda":
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(n_data: Optional[int] = None, n_space: int = 1, n_model: int = 1,
              devices: Optional[Sequence] = None, device_type: Optional[str] = None):
    """The mesh of this run.

    ``devices`` defaults to one per rank of the process group, or to this
    process's visible devices without a group. Raises ValueError where the
    JAX package's ``make_mesh`` does: a size below 1, more devices than
    exist, a defaulted data axis that comes out below 1. Returns a
    :class:`~torch.distributed.device_mesh.DeviceMesh` with the one dim
    ``'data'`` over the group's ranks, or for ``n_space`` > 1 or ``n_model``
    > 1 the dims ``('data', 'space', 'model')`` of shape ``(n_data, n_space,
    n_model)`` (their product must be the world size); None for one process
    without a group. ``device_type`` (the ranks' tensors) defaults to
    ``cuda`` under NCCL and ``cpu`` under gloo; ranks sharing a GPU over
    gloo pass ``cuda``. The mesh's widths and sub-groups become
    :func:`space_size`, :func:`model_size`, :func:`data_group`,
    :func:`space_group`, :func:`model_group` and, through :func:`group_of`,
    the batch group.
    """
    if n_space < 1 or n_model < 1 or (n_data is not None and n_data < 1):
        raise ValueError(
            f"mesh axis sizes must be >= 1 (got data={n_data}, space={n_space}, "
            f"model={n_model})")
    if devices is None:
        if dist.is_initialized():
            devices = list(range(dist.get_world_size()))
        else:
            devices = visible_devices("cuda" if torch.cuda.is_available() else "cpu")
    if n_data is None:
        n_data = len(devices) // (n_space * n_model)
        if n_data < 1:
            raise ValueError(
                f"mesh needs at least {n_space * n_model} devices for "
                f"space={n_space} x model={n_model}, have {len(devices)}")
    need = n_data * n_space * n_model
    if need > len(devices):
        raise ValueError(f"mesh {n_data}x{n_space}x{n_model} needs {need} devices, "
                         f"have {len(devices)}")
    _MESH.update(n_space=1, n_model=1, data=None, space=None, model=None, batch=None)
    if not dist.is_initialized():
        if need > 1:
            raise ValueError(f"a {n_data}x{n_space}x{n_model} (data x space x model) mesh "
                             f"needs a process group: run under launch() or torchrun")
        return None
    if need != dist.get_world_size():
        raise ValueError(f"n_data={n_data} x n_space={n_space} x n_model={n_model} but the "
                         f"process group has {dist.get_world_size()} ranks")
    from torch.distributed.device_mesh import init_device_mesh
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if n_space == 1 and n_model == 1:
        return init_device_mesh(device_type, (n_data,), mesh_dim_names=(DATA_AXIS,))
    mesh = init_device_mesh(device_type, (n_data, n_space, n_model),
                            mesh_dim_names=(DATA_AXIS, SPACE_AXIS, MODEL_AXIS))
    batch = None
    if n_space > 1:
        # One batch group per model index m: the data x space ranks, in (d, s)
        # order, so a rank's index in it is d * n_space + s.
        grid = np.arange(need).reshape(n_data * n_space, n_model)
        batch, _ = dist.new_subgroups_by_enumeration([grid[:, m].tolist()
                                                      for m in range(n_model)])
    _MESH.update(n_space=n_space, n_model=n_model, data=mesh.get_group(DATA_AXIS),
                 space=mesh.get_group(SPACE_AXIS) if n_space > 1 else None,
                 model=mesh.get_group(MODEL_AXIS) if n_model > 1 else None, batch=batch)
    return mesh


def group_of(mesh):
    """The mesh's batch group, over which the steps average the gradients,
    BatchNorm takes its statistics, the losses their denominators and the
    confusion matrices their sums: the 'data' group of a mesh without a
    'space' axis (None for no mesh, and for a 1-wide 'data' axis: the plain
    path), and with one the data x space ranks of this rank's model index."""
    if mesh is None:
        return None
    names = mesh.mesh_dim_names or ()
    if SPACE_AXIS in names and mesh[SPACE_AXIS].size() > 1:
        return _MESH["batch"]
    if MODEL_AXIS in names and mesh[DATA_AXIS].size() == 1:
        return None
    return mesh.get_group(DATA_AXIS)


# ---------------------------------------------------------------------------
# Joining and launching process groups
# ---------------------------------------------------------------------------

def maybe_initialize(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     auto: bool = False, device_type: str = "cuda") -> bool:
    """Join a process group launched outside this process; returns whether
    one was joined.

    ``auto`` (the CLIs' ``--multihost``) reads the launcher's environment:
    torchrun's ``RANK``/``WORLD_SIZE``/``MASTER_ADDR``/``MASTER_PORT``, or
    SLURM's ``SLURM_PROCID``/``SLURM_NTASKS`` with ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the counterpart of TPU-pod autodetection); it raises
    when neither is there. Explicit values join ``tcp://<coordinator>`` as
    ``process_id`` of ``num_processes``. A half-specified manual launch
    raises, as in the JAX package. The group's backend follows
    ``device_type``; on ``cuda`` each process takes the GPU of its local rank
    (``LOCAL_RANK`` or ``SLURM_LOCALID``, else the rank modulo the GPUs).
    """
    if dist.is_initialized():
        return True
    if auto and num_processes is None:
        env = os.environ
        if all(k in env for k in _ENV_TORCHRUN):
            rank_, world = int(env["RANK"]), int(env["WORLD_SIZE"])
        elif all(k in env for k in _ENV_SLURM) and "MASTER_ADDR" in env:
            rank_, world = int(env["SLURM_PROCID"]), int(env["SLURM_NTASKS"])
        else:
            raise ValueError("--multihost: no torchrun (RANK, WORLD_SIZE, MASTER_ADDR, "
                             "MASTER_PORT) or SLURM (SLURM_PROCID, SLURM_NTASKS, "
                             "MASTER_ADDR) environment found; launch with torchrun "
                             "or srun, or pass --coordinator_address/--num_processes/"
                             "--process_id")
        address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
        local = env.get("LOCAL_RANK", env.get("SLURM_LOCALID"))
    elif num_processes is not None and num_processes > 1:
        if coordinator_address is None or process_id is None:
            raise ValueError("--num_processes > 1 needs --coordinator_address and "
                             "--process_id")
        address, world, rank_ = coordinator_address, num_processes, process_id
        local = os.environ.get("LOCAL_RANK")
    elif coordinator_address is not None or process_id is not None:
        raise ValueError(
            "--coordinator_address/--process_id require --num_processes > 1 "
            f"(got num_processes={num_processes}); pass --num_processes, or use "
            "--multihost for torchrun/SLURM autodetection")
    else:
        return False
    if device_type == "cuda":
        n_gpus = torch.cuda.device_count()
        if n_gpus == 0:
            raise RuntimeError("a cuda process group needs a GPU; pass --device cpu")
        torch.cuda.set_device(int(local) if local is not None else rank_ % n_gpus)
    dist.init_process_group(backend_for(device_type), init_method=f"tcp://{address}",
                            world_size=world, rank=rank_, timeout=_TIMEOUT)
    return True


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def local_rank_devices(n_devices: Optional[int], device_type: str,
                       n_model: int = 1, n_space: int = 1) -> List[torch.device]:
    """The devices of a local launch of ``n_devices`` data ranks times
    ``n_space`` space ranks times ``n_model`` model ranks: one GPU each on
    ``cuda`` (None: as many data ranks as the visible GPUs hold; more ranks
    than GPUs raises, as :func:`make_mesh` does), the CPU for every rank on
    ``cpu`` (None: 1 data rank)."""
    if n_devices is not None and n_devices < 1:
        raise ValueError(f"--n_devices must be >= 1, got {n_devices}")
    if n_model < 1:
        raise ValueError(f"--n_model must be >= 1, got {n_model}")
    if n_space < 1:
        raise ValueError(f"--n_space must be >= 1, got {n_space}")
    per = n_space * n_model
    if device_type != "cuda":
        return [torch.device("cpu")] * ((n_devices or 1) * per)
    gpus = visible_devices("cuda")
    n = (len(gpus) // per if n_devices is None else n_devices) * per
    if n > len(gpus) or n < per:
        space = f" x --n_space {n_space}" if n_space > 1 else ""
        raise ValueError(f"--n_devices {n_devices}{space} x --n_model {n_model} needs "
                         f"{max(n, per)} GPUs, have {len(gpus)}")
    return gpus[:n]


def _rank_main(index: int, fn: Callable, args: tuple, devices: List[str], backend: str,
               port: int, threads: int, result_path: str,
               timeout: datetime.timedelta = _TIMEOUT) -> None:
    device = torch.device(devices[index])
    torch.set_num_threads(threads)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            world_size=len(devices), rank=index, timeout=timeout)
    try:
        result = fn(*args)
        if index == 0:
            with open(result_path, "wb") as f:
                pickle.dump(result, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def launch(fn: Callable, args: tuple = (), n_devices: Optional[int] = None,
           device_type: str = "cuda", devices: Optional[Sequence] = None,
           backend: Optional[str] = None, n_model: int = 1, n_space: int = 1,
           timeout: Optional[float] = None) -> Any:
    """``fn(*args)`` on every rank of a run over ``n_devices`` data ranks
    times ``n_space`` space ranks times ``n_model`` model ranks; returns
    this process's result (rank 0's, for a local launch).

    - Inside a process group (a rank, torchrun after :func:`maybe_initialize`):
      calls ``fn`` here.
    - Else, with more than one device (``devices``, or
      :func:`local_rank_devices` of ``n_devices``): spawns one rank per device
      (start method ``spawn``; ``fn`` and ``args`` are pickled), each in a
      group on a free port of 127.0.0.1 with its device current, and returns
      rank 0's result after every rank has ended. CPU ranks share this
      process's torch threads.
    - Else calls ``fn`` here without a group.

    ``backend`` defaults to :func:`backend_for` the devices' type; ranks that
    share one GPU need ``backend='gloo'`` (NCCL refuses them). ``timeout``
    (seconds; 30 minutes by default) bounds each collective's wait in the
    spawned ranks: a rank that makes one collective fewer than the others
    then fails the launch instead of hanging it.
    """
    if dist.is_initialized():
        return fn(*args)
    if devices is None:
        devices = local_rank_devices(n_devices, device_type, n_model, n_space)
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) == 1:
        return fn(*args)
    kind = torch.device(devices[0]).type
    backend = backend or backend_for(kind)
    threads = max(1, torch.get_num_threads() // len(devices)) if kind == "cpu" else \
        torch.get_num_threads()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "rank0.pkl")
        torch.multiprocessing.start_processes(
            _rank_main, args=(fn, args, devices, backend, _free_port(), threads, path,
                              _TIMEOUT if timeout is None
                              else datetime.timedelta(seconds=timeout)),
            nprocs=len(devices), join=True, start_method="spawn")
        with open(path, "rb") as f:
            return pickle.load(f)  # written by rank 0 of this launch


# ---------------------------------------------------------------------------
# Data placement
# ---------------------------------------------------------------------------

def batch_rows(n: int, grad_accum: int = 1, world: Optional[int] = None,
               index: Optional[int] = None) -> np.ndarray:
    """The global rows of a batch of ``n`` that data rank ``index`` of
    ``world`` (default: :func:`data_rank` of :func:`data_size`) holds, in
    its order: the contiguous block ``[r n/W, (r+1) n/W)``, or
    under ``grad_accum`` G its block of each microbatch in turn (the JAX
    step's microbatch i is the global rows ``[i n/G, (i+1) n/G)``), so that
    chunking the rank's rows in G gives its part of each microbatch."""
    world = data_size() if world is None else world
    index = data_rank() if index is None else index
    if n % (world * grad_accum):
        raise ValueError(f"global batch {n} is not divisible by {world} ranks x "
                         f"grad_accum {grad_accum}")
    m = n // (world * grad_accum)
    return np.concatenate([np.arange(i * n // grad_accum + index * m,
                                     i * n // grad_accum + (index + 1) * m)
                           for i in range(grad_accum)])


def shard_batch(batch, grad_accum: int = 1, world: Optional[int] = None,
                index: Optional[int] = None):
    """This rank's rows (:func:`batch_rows`) of a global batch: a dict or
    list of arrays, tensors or lists (strings), each batch-leading, or one
    of them. The whole batch without a group."""
    if isinstance(batch, dict):
        return {k: shard_batch(v, grad_accum, world, index) for k, v in batch.items()}
    if isinstance(batch, tuple):
        return tuple(shard_batch(v, grad_accum, world, index) for v in batch)
    rows = batch_rows(len(batch), grad_accum, world, index)
    if isinstance(batch, torch.Tensor):
        return batch[torch.as_tensor(rows, device=batch.device)]
    if isinstance(batch, np.ndarray):
        return batch[rows]
    return [batch[int(i)] for i in rows]


def broadcast_tensors(tree, group=None):
    """Every tensor of a nested dict/list/tuple overwritten, in place, by
    rank 0's (e.g. int8 qparams, whose calibration on CUDA can differ from
    process to process by an ulp); returns ``tree``."""
    if world_size() == 1:
        return tree
    if isinstance(tree, dict):
        for v in tree.values():
            broadcast_tensors(v, group)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            broadcast_tensors(v, group)
    elif isinstance(tree, torch.Tensor):
        with torch.no_grad():
            buf = tree.data.contiguous()
            dist.broadcast(buf, src=0, group=group)
            if buf.data_ptr() != tree.data.data_ptr():
                tree.data.copy_(buf)
    return tree


def replicate(module: torch.nn.Module, group=None) -> torch.nn.Module:
    """Broadcast ``module``'s parameters and buffers from rank 0, in place,
    so every rank starts from the same state."""
    broadcast_tensors(list(module.parameters()) + list(module.buffers()), group)
    return module


def synced_timestamp(fmt: str = "%Y%m%d_%H%M%S") -> str:
    """Rank 0's formatted local time, the same string on every rank (the
    experiment directory's name)."""
    ts = [datetime.datetime.now().strftime(fmt)]
    if world_size() > 1:
        dist.broadcast_object_list(ts, src=0)
    return ts[0]


def _under_torchrun() -> bool:
    return all(k in os.environ for k in _ENV_TORCHRUN)


def cli_world(args, device_type: str) -> int:
    """A CLI's world size: it joins a group launched outside the process
    (the multi-host flags, or torchrun's environment, which needs no flag)
    and returns its size, which ``--n_devices`` times ``--n_space`` times
    ``--n_model`` must match if given; else the ranks :func:`launch` will
    spawn for ``--n_devices``, ``--n_space`` and ``--n_model``."""
    n_model = getattr(args, "n_model", 1)
    n_space = getattr(args, "n_space", 1)
    per = n_model * n_space
    joined = maybe_initialize(getattr(args, "coordinator_address", None),
                              getattr(args, "num_processes", None),
                              getattr(args, "process_id", None),
                              auto=getattr(args, "multihost", False) or _under_torchrun(),
                              device_type=device_type)
    if joined:
        world = dist.get_world_size()
        if world % per or args.n_devices not in (None, world // per):
            space = f" x --n_space {n_space}" if n_space > 1 else ""
            raise ValueError(f"--n_devices {args.n_devices}{space} x --n_model {n_model} but "
                             f"the launched group has {world} ranks")
        return world
    return len(local_rank_devices(args.n_devices, device_type, n_model, n_space))


def check_batch(batch_size: int, world: int, grad_accum: int = 1) -> None:
    """SystemExit unless the global ``--batch_size`` splits over the ranks
    (and each rank's share over ``--grad_accum`` microbatches)."""
    if grad_accum < 1 or batch_size % (world * grad_accum):
        raise SystemExit(f"--batch_size {batch_size} must be a positive multiple of "
                         f"{world} ranks x --grad_accum {grad_accum}")
