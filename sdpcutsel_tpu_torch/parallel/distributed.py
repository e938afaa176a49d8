"""Multi-process bring-up and host coordination over ``torch.distributed``
(port of ``sdpcutsel_tpu/parallel/distributed.py``).

Every process is one rank and holds one device.  ``initialize`` joins the
process group; ``parallel/mesh.make_mesh`` then lays the ranks out as
('data', 'cand'), data-major (rank = d * cand + c), and gives each 'cand'
group its own process group: the per-round gather of every shard's local
top-k (``sharding.gather_cand``) is the only collective of a round, and
none crosses 'data'.  ``put_global`` gives each rank its slice of a host
value that every rank holds; ``fetch_tree`` brings every 'data' shard back
to every rank as numpy (the reference's tiled ``process_allgather``).

Backend, chosen by rule and never by catching an error:
  * ``nccl`` when the ranks run on CUDA and each rank has a card of its own
    (the ranks on a host, ``LOCAL_WORLD_SIZE``, are no more than its cards);
  * ``gloo`` on the CPU, and when ranks share a card (NCCL refuses two ranks
    on one device).
The gloo route copies a CUDA tensor to the host before each collective and
back after it (``all_gather_cat``): gloo moves bytes between hosts, so this
is its own route for device tensors, not a fallback.  NCCL gathers only
card tensors, so its route moves a host tensor (the fetched solve counts)
to the rank's card and back.

``spawn`` starts the ranks of one process group as subprocesses on this
host (a file store in a temporary directory), each with a time limit:

    python3 -m sdpcutsel_tpu_torch.run_multihost --cpu --data 2 --cand 2 \\
        --coordinator file:///tmp/store --num-processes 4 --process-id 0 ...

or, on several cards, ``torchrun --nproc-per-node 4 -m
sdpcutsel_tpu_torch.run_multihost --data 2 --cand 2`` (the arguments come
from torchrun's variables).
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_device: Optional[torch.device] = None       # this process's device, set by initialize


def _init_method(address: str) -> str:
    if address.startswith(("tcp://", "file://")):
        return address
    if "://" in address:
        raise ValueError(f"coordinator must be tcp://host:port or file://path, got {address!r}")
    return f"tcp://{address}"


def choose_backend(device: torch.device, local_ranks: int) -> str:
    """nccl when every rank of this host has a card of its own, else gloo."""
    if device.type == "cuda" and local_ranks <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def local_layout(rank: int) -> tuple:
    """(this rank's index on its host, the ranks on its host) from
    ``LOCAL_RANK`` (default: the rank) and ``LOCAL_WORLD_SIZE`` (default 1:
    a rank launched by hand is alone on its host; ``torchrun`` and
    ``spawn`` set both)."""
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", 1)))


def initialize(coordinator_address: Optional[str] = None, num_processes: Optional[int] = None,
               process_id: Optional[int] = None, backend: Optional[str] = None,
               device=None) -> torch.device:
    """Join the process group (a second call does nothing) and return this
    rank's device.

    Arguments not given come from torch's variables, as ``torchrun`` sets
    them: ``MASTER_ADDR``/``MASTER_PORT`` (the coordinator), ``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK`` and ``LOCAL_WORLD_SIZE``
    (``local_layout``).  The coordinator is ``tcp://host:port``, ``host:port`` or
    ``file://path``.  ``device``: "cpu" for the CPU, else the card
    ``cuda:{LOCAL_RANK % device_count}``.  ``backend`` overrides
    ``choose_backend``."""
    global _device
    if dist.is_initialized():
        return _device
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env:
            raise ValueError("no coordinator: pass coordinator_address or set MASTER_ADDR")
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    world = int(env["WORLD_SIZE"]) if num_processes is None else num_processes
    rank = int(env["RANK"]) if process_id is None else process_id
    local_rank, local_ranks = local_layout(rank)
    if device is not None and torch.device(device).type == "cpu":
        dev = torch.device("cpu")
    elif not torch.cuda.is_available():
        raise RuntimeError("no CUDA device visible to torch: pass device='cpu' for the CPU")
    else:
        dev = torch.device("cuda", local_rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    backend = backend or choose_backend(dev, local_ranks)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs the ranks on CUDA")
    dist.init_process_group(backend, init_method=_init_method(coordinator_address),
                            world_size=world, rank=rank,
                            **({"device_id": dev} if backend == "nccl" else {}))
    _device = dev
    return dev


def rank_device(cpu: bool):
    """``initialize``'s device for a rank of a command line's ``--cpu``:
    "cpu", with one torch thread, as the CPU ranks share the host; else
    None, the card."""
    if cpu:
        torch.set_num_threads(1)
        return "cpu"
    return None


def device() -> torch.device:
    """This rank's device (``initialize`` must have run)."""
    if _device is None:
        raise RuntimeError("call parallel.distributed.initialize first")
    return _device


def sync(tag: str = "sync") -> None:
    """Barrier across all ranks (``tag`` names it in a hung run's stack)."""
    if dist.get_backend() == "nccl":
        dist.barrier(device_ids=[device().index])
    else:
        dist.barrier()


def all_gather_cat(t: torch.Tensor, group=None, dim: int = 0) -> torch.Tensor:
    """Every rank's ``t`` (one shape on all ranks of ``group``), concatenated
    along ``dim`` in rank order, on ``t``'s device.  gloo gathers on the
    host, nccl on the rank's card (a host tensor goes there and back)."""
    size = dist.get_world_size(group)
    where = "cpu" if dist.get_backend(group) == "gloo" else device()
    src = t.to(where).contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim).to(t.device)


def _axis_index(mesh, axis: Optional[str]) -> tuple:
    """(this rank's index along ``axis``, the axis' size); (0, 1) for None."""
    if axis is None:
        return 0, 1
    if axis == "data":
        return mesh.data_index, mesh.data
    if axis == "cand":
        return mesh.cand_index, mesh.cand
    raise ValueError(f"axis must be 'data', 'cand' or None, got {axis!r}")


def put_global(arr, mesh, axis: Optional[str], device=None) -> torch.Tensor:
    """This rank's slice of ``arr`` (a host value every rank holds: numpy or
    a tensor) along its first dimension, split over the mesh axis ``axis``
    ('data', 'cand', or None for the whole value), on ``device`` (default:
    the mesh's device; on a one-process mesh, where every slice is local,
    the card).  The first dimension must split evenly."""
    t = arr.detach().cpu() if isinstance(arr, torch.Tensor) else torch.as_tensor(np.asarray(arr))
    dev = device or mesh.device or "cuda"
    if not mesh.distributed:
        return t.to(dev)
    i, parts = _axis_index(mesh, axis)
    if t.shape[0] % parts:
        raise ValueError(f"{t.shape[0]} rows do not split over {parts} '{axis}' shards")
    return t.chunk(parts, 0)[i].contiguous().to(dev)


def _map(fn, tree):
    """``fn`` on every tensor or array leaf of nested dataclasses, dicts,
    lists and tuples; a ``torch.Generator`` leaf becomes None."""
    if isinstance(tree, (torch.Tensor, np.ndarray)):
        return fn(tree)
    if tree is None or isinstance(tree, torch.Generator):
        return None
    if dataclasses.is_dataclass(tree):
        return type(tree)(**{f.name: _map(fn, getattr(tree, f.name))
                             for f in dataclasses.fields(tree)})
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    raise TypeError(f"no array in a leaf of type {type(tree).__name__}")


def put_global_tree(tree, mesh, axis: Optional[str], device=None):
    """``put_global`` over every leaf of ``tree`` (one axis for all)."""
    return _map(lambda a: put_global(a, mesh, axis, device), tree)


def fetch_tree(tree, mesh, axis: int = 0):
    """Every 'data' shard of every leaf, concatenated along dimension
    ``axis`` in 'data' order, as numpy on every rank: on a distributed mesh
    one all_gather over all ranks a leaf, keeping the first rank of each
    'cand' group (its replicas hold the same values); on a one-process mesh
    the leaves are local and only converted.  A generator leaf comes back as
    None."""
    if not mesh.distributed:
        return _map(lambda a: np.asarray(torch.as_tensor(a).detach().cpu()), tree)
    keep = range(0, dist.get_world_size(), mesh.cand)

    def fetch(a):
        t = torch.as_tensor(a).detach()
        whole = all_gather_cat(t.unsqueeze(0))
        return torch.cat([whole[r] for r in keep], axis).cpu().numpy()

    return _map(fetch, tree)


def spawn(argv: list, ranks: int, timeout: float, env: Optional[dict] = None) -> list:
    """Run ``python3 argv...`` as the ranks 0..ranks-1 of one process group
    (each gets ``--coordinator file://... --num-processes ranks
    --process-id r``, and ``LOCAL_RANK`` r and ``LOCAL_WORLD_SIZE`` ranks,
    as they share this host) from the repository's root, and wait up to
    ``timeout`` seconds for all of them.  Returns every rank's output
    (stdout and stderr together).  Raises RuntimeError, after killing every
    rank still running, if one fails or the time runs out.  The ranks share
    this host, so gloo talks over the loopback interface unless
    ``GLOO_SOCKET_IFNAME`` says otherwise."""
    env = {"GLOO_SOCKET_IFNAME": "lo", **(os.environ if env is None else env)}
    with tempfile.TemporaryDirectory(prefix="sdpcutsel_ranks_") as tmp:
        procs, logs = [], []
        try:
            for r in range(ranks):
                log = open(os.path.join(tmp, f"rank{r}.log"), "w+")
                logs.append(log)
                procs.append(subprocess.Popen(
                    [sys.executable, *argv, "--coordinator", f"file://{tmp}/store",
                     "--num-processes", str(ranks), "--process-id", str(r)],
                    cwd=REPO, env={**env, "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(ranks)},
                    stdout=log, stderr=subprocess.STDOUT, text=True))
            deadline = time.monotonic() + timeout
            while any(p.poll() is None for p in procs) and time.monotonic() < deadline:
                if any(p.poll() not in (None, 0) for p in procs):
                    break               # a rank failed: the others may wait on it forever
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
            outs = []
            for log in logs:
                log.seek(0)
                outs.append(log.read())
                log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        raise RuntimeError(
            f"ranks {bad} of {ranks} failed or ran past {timeout} s ({' '.join(argv[:2])}):\n"
            + "\n".join(f"--- rank {r} (exit {procs[r].returncode}) ---\n{outs[r][-3000:]}"
                        for r in bad))
    return outs
