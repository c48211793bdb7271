"""Start `world` rank processes and run one function of the port in each.

    result = run(fn, world, "gloo", "cpu", store_dir, args=(...))

Each rank is a process started by `torch.multiprocessing.start_processes`
with the `spawn` method (so no rank inherits its parent's modules, JAX
among them), joins a process group through a `FileStore` in `store_dir`
(no TCP port to collide with another run) with the given backend, and
calls `fn(rank, world, device, *args)`, where `device` is the rank's own:
the given one, except that NCCL puts rank r on cuda:r. The backend, the
device and the store's directory have no defaults: a caller that forgets
the device does not land on the CPU.

A CUDA rank is bound to CPUs of its own, as `mpiexec` binds its ranks:
`plan_binding` shares the parent's affinity mask out among the ranks,
each rank inside its card's NUMA node where that node's CPUs go round,
else an even split of the mask (also where the topology cannot be read:
`card_topology`). The rank binds every thread it has before it touches
the card and sizes torch's threads to its CPUs. The BLAS and OpenMP pools
that numpy and the native AMG size at import, before the rank runs any
code of its own, are sized for all ranks alike by the environment they
start with (`THREAD_ENV`: the smallest rank's CPU count), which otherwise
gives every rank every core and, spinning against each other, made the
AMG refresh's host part of four ranks 200x slower. It writes its CPUs and
its card's node once to standard error. Under NCCL the communicator is
made in `init_process_group` (`device_id`) and warmed by one collective,
so that no exchange of the solve pays for it, and NCCL's flight recorder
is off unless the environment sizes it (`FLIGHT_RECORDER_ENV`). A CPU
rank is not bound and takes one thread (the tests run several files side
by side).

`fn` must be a module-level function (spawn pickles it by name) and return
something picklable (numpy arrays, not CUDA tensors). `run` returns rank
0's result, passed back through a file in `store_dir`; a rank that raises
makes `run` stop every rank and raise with that rank's traceback, and so
do ranks that outlast `TIMEOUT_S`. The backend rule is
dist.check_backend's: NCCL with more ranks than CUDA devices raises here,
before any process starts.

The JAX package's counterpart is one process driving `ndev` devices
(__graft_entry__.py); here a rank is a process, as an MPI rank is in the
reference.
"""

from __future__ import annotations

import os
import pickle
import sys
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
# the size of NCCL's flight recorder, under its two names: a ring of the
# last collectives, each with its Python stack, kept to diagnose a hang
FLIGHT_RECORDER_ENV = ("TORCH_FR_BUFFER_SIZE", "TORCH_NCCL_TRACE_BUFFER_SIZE")


def rank_device(backend: str, device, rank: int) -> torch.device:
    """The rank's device: cuda:rank under NCCL; else the given device,
    "cuda" meaning cuda:0 (every gloo rank on the one card)."""
    dev = torch.device(device)
    if backend == "nccl":
        return torch.device("cuda", rank)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", 0)
    return dev


def cpu_list(text: str) -> list[int]:
    """The CPUs of a kernel CPU list such as "0-15,32-47"."""
    out = []
    for part in text.strip().split(","):
        if part:
            lo, _, hi = part.partition("-")
            out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def card_topology(index: int, sysfs: str = "/sys") -> tuple:
    """(NUMA node, local CPUs) of CUDA device `index` from its PCI device
    in sysfs; None for what cannot be read."""
    try:
        p = torch.cuda.get_device_properties(index)
        bdf = (f"{p.pci_domain_id:04x}:{p.pci_bus_id:02x}:"
               f"{p.pci_device_id:02x}.0")
    except (AttributeError, AssertionError, RuntimeError):
        return None, None
    dev = os.path.join(sysfs, "bus", "pci", "devices", bdf)
    node = cpus = None
    try:
        with open(os.path.join(dev, "numa_node")) as f:
            node = int(f.read())
        node = node if node >= 0 else None
    except (OSError, ValueError):
        pass
    try:
        with open(os.path.join(dev, "local_cpulist")) as f:
            cpus = cpu_list(f.read())
    except (OSError, ValueError):
        if node is not None:
            try:
                with open(os.path.join(sysfs, "devices", "system", "node",
                                       f"node{node}", "cpulist")) as f:
                    cpus = cpu_list(f.read())
            except (OSError, ValueError):
                pass
    return node, cpus or None


def _even(cpus: list, k: int) -> list:
    """cpus split into k runs of consecutive entries, sizes within one;
    with fewer CPUs than k, CPU r % len(cpus) each."""
    if len(cpus) < k:
        return [[cpus[r % len(cpus)]] for r in range(k)]
    q, rem = divmod(len(cpus), k)
    out, at = [], 0
    for r in range(k):
        n = q + (r < rem)
        out.append(cpus[at:at + n])
        at += n
    return out


def plan_binding(allowed, cards: list) -> list[list[int]]:
    """Each rank's CPUs. allowed: the CPUs the parent may run on; cards:
    the CPUs local to each rank's card, None where unreadable. The ranks
    on one card's node share its allowed CPUs evenly, provided the nodes'
    CPUs are disjoint and every such rank gets one; otherwise, or where a
    card's CPUs cannot be read, the ranks share all the allowed CPUs
    evenly. The sets are disjoint unless there are fewer CPUs than
    ranks."""
    allowed = sorted(set(allowed))
    if cards and all(c is not None for c in cards):
        groups = {}
        for r, c in enumerate(cards):
            local = frozenset(c).intersection(allowed)
            groups.setdefault(local, []).append(r)
        nodes = list(groups)
        disjoint = all(not (a & b) for i, a in enumerate(nodes)
                       for b in nodes[i + 1:])
        if disjoint and all(len(g) >= len(rs) for g, rs in groups.items()):
            out = [None] * len(cards)
            for g, rs in groups.items():
                for r, part in zip(rs, _even(sorted(g), len(rs))):
                    out[r] = part
            return out
    return _even(allowed, len(cards))


def bind_rank(cpus) -> int:
    """Bind every thread of this process to `cpus` (threads started later
    inherit the main thread's binding) and size torch's threads to their
    count, which it returns. The pools of THREAD_ENV have read their size
    at import: `run` sets it for the ranks as they start."""
    for tid in os.listdir("/proc/self/task"):
        try:
            os.sched_setaffinity(int(tid), cpus)
        except (OSError, ValueError):
            pass                # a thread that has ended meanwhile
    n = len(cpus)
    torch.set_num_threads(n)
    return n


def _cpu_ranges(cpus) -> str:
    out, run = [], []
    for c in sorted(cpus):
        if run and c != run[-1] + 1:
            out.append(run)
            run = []
        run.append(c)
    if run:
        out.append(run)
    return ",".join(f"{r[0]}-{r[-1]}" if len(r) > 1 else f"{r[0]}"
                    for r in out)


def _rank_main(rank, fn, world, backend, device, store, result, args,
               plan):
    dev = rank_device(backend, device, rank)
    if plan is None:
        torch.set_num_threads(1)
    else:
        cpus = plan[rank]
        bind_rank(cpus)
        node, _ = card_topology(dev.index)
        print(f"rank {rank} of {world} on {dev}: NUMA node {node}, "
              f"{len(cpus)} CPUs {_cpu_ranges(cpus)}", file=sys.stderr,
              flush=True)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    kw = {"device_id": dev} if backend == "nccl" else {}
    if backend == "nccl" and not any(k in os.environ
                                     for k in FLIGHT_RECORDER_ENV):
        # off unless asked for: it costs the host ~27 us a collective (80
        # against 53 us an all_to_all, one H100), and a solve makes ~2,500
        os.environ.update(dict.fromkeys(FLIGHT_RECORDER_ENV, "0"))
    tdist.init_process_group(backend, store=tdist.FileStore(store, world),
                             rank=rank, world_size=world, **kw)
    if backend == "nccl":
        tdist.all_reduce(torch.zeros(1, device=dev))
        torch.cuda.synchronize(dev)
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
    plan = None
    if rank_device(backend, device, 0).type == "cuda":
        plan = plan_binding(os.sched_getaffinity(0), [
            card_topology(rank_device(backend, device, r).index)[1]
            for r in range(world)])
    threads = str(min(len(c) for c in plan) if plan else 1)
    saved = {k: os.environ.get(k) for k in THREAD_ENV}
    try:
        # the spawned ranks start with this environment
        os.environ.update(dict.fromkeys(THREAD_ENV, threads))
        try:
            ranks = mp.start_processes(
                _rank_main, args=(fn, world, backend, str(device), store,
                                  result, tuple(args), plan),
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
