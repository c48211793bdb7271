"""Start `world` rank processes and run one function of the port in each.

    result = run(fn, world, "gloo", "cpu", store_dir, args=(...))

Each rank is a process started by `torch.multiprocessing.start_processes`
with the `spawn` method (so no rank inherits its parent's modules, JAX
among them), joins a process group through a `FileStore` in `store_dir`
(no TCP port to collide with another run) with the given backend, and
calls `fn(rank, world, device, *args)`, where `device` is the rank's own:
the given one, except that NCCL puts rank r on cuda:r. The backend, the
device and the store's directory have no defaults: a caller that forgets
the device does not land on the CPU. A CUDA rank takes its share of the
host's cores for its CPU work, a CPU rank one thread (the tests run
several files side by side): torch's threads, and the BLAS and OpenMP
pools that numpy and the native AMG start at import (`THREAD_ENV`, set for
the ranks as they start), which otherwise take every core in every rank
and, spinning against each other, made the AMG refresh's host part of
four ranks 200x slower. `fn` must be a module-level function (spawn
pickles it by name) and return something picklable (numpy arrays, not
CUDA tensors). `run` returns rank 0's result, passed back through a file
in `store_dir`; a rank that raises makes `run` stop every rank and raise
with that rank's traceback, and so do ranks that outlast `TIMEOUT_S`. The
backend rule is dist.check_backend's: NCCL with more ranks than CUDA
devices raises here, before any process starts.

The JAX package's counterpart is one process driving `ndev` devices
(__graft_entry__.py); here a rank is a process, as an MPI rank is in the
reference.
"""

from __future__ import annotations

import os
import pickle
import time
import uuid

import torch
import torch.distributed as tdist
import torch.multiprocessing as mp

from .dist import check_backend

# seconds the ranks of one run may take before they are killed
TIMEOUT_S = 1800.0
# the thread-pool sizes a rank's BLAS and OpenMP runtimes read at import
THREAD_ENV = ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS")


def rank_device(backend: str, device, rank: int) -> torch.device:
    """The rank's device: cuda:rank under NCCL; else the given device,
    "cuda" meaning cuda:0 (every gloo rank on the one card)."""
    dev = torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def rank_threads(dev: torch.device, world: int) -> int:
    """A rank's CPU threads: the host's cores shared out among CUDA
    ranks; one for a CPU rank."""
    if dev.type == "cuda":
        return max(1, (os.cpu_count() or 1) // world)
    return 1


def _rank_main(rank, fn, world, backend, device, store, result, args):
    dev = rank_device(backend, device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    torch.set_num_threads(rank_threads(dev, world))
    tdist.init_process_group(backend, store=tdist.FileStore(store, world),
                             rank=rank, world_size=world)
    out = fn(rank, world, dev, *args)
    if rank == 0:
        with open(result, "wb") as f:
            pickle.dump(out, f)
    tdist.destroy_process_group()


def run(fn, world: int, backend: str, device, store_dir, args=()):
    """Run fn(rank, world, device, *args) on `world` spawned ranks; return
    rank 0's result."""
    check_backend(backend, world, device)
    os.makedirs(store_dir, exist_ok=True)
    tag = uuid.uuid4().hex
    store = os.path.join(store_dir, f"filestore_{tag}")
    result = os.path.join(store_dir, f"result_{tag}.pkl")
    threads = str(rank_threads(rank_device(backend, device, 0), world))
    saved = {k: os.environ.get(k) for k in THREAD_ENV}
    try:
        # the spawned ranks start with this environment
        os.environ.update(dict.fromkeys(THREAD_ENV, threads))
        try:
            ranks = mp.start_processes(
                _rank_main, args=(fn, world, backend, str(device), store,
                                  result, tuple(args)),
                nprocs=world, join=False, start_method="spawn")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        deadline = time.monotonic() + TIMEOUT_S
        # join returns as each rank ends; it raises (and stops the others)
        # when one fails
        while not ranks.join(max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                for p in ranks.processes:
                    p.kill()
                    p.join()
                raise TimeoutError(f"the ranks took longer than {TIMEOUT_S} "
                                   "s")
        with open(result, "rb") as f:
            return pickle.load(f)
    finally:
        for path in (store, result):
            if os.path.exists(path):
                os.remove(path)
