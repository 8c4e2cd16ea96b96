"""Process-group init, global meshes, batch-row plumbing and a local
launcher.

Counterpart of ``bert_tpu/parallel/multihost.py``. bert_tpu forms its
process group with ``jax.distributed``; here it is
``torch.distributed.init_process_group``, one process per rank. Every rank
runs the same program on the same inputs and gets the whole result, as
every process of a bert_tpu multi-host run does: a batch is cut into
per-rank rows over the ``data`` axis and the results are all-gathered.

The process-group backend follows from the topology and is logged: NCCL
when every rank of a host has a card of its own, gloo when ranks share one
(NCCL refuses two ranks on one card) or compute on the CPU.
:func:`spawn_ranks` runs a function on local ranks (tests, the card
check); ``torchrun --nproc-per-node N`` launches the entry points.
"""

from __future__ import annotations

import logging
import os
import queue
import socket
import time
import traceback
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist

from .collectives import all_gather_dim
from .mesh import DATA_AXIS, axis_group, local_rows, rank_device

_logger = logging.getLogger(__name__)

# Environment knobs (all optional — arguments win over env, env wins over
# torchrun's MASTER_ADDR / MASTER_PORT / RANK / WORLD_SIZE):
ENV_COORD = "BERT_TPU_COORDINATOR"  # "host:port" of process 0
ENV_NPROC = "BERT_TPU_NUM_PROCESSES"
ENV_PID = "BERT_TPU_PROCESS_ID"


def local_rank_and_size():
    """(rank on this host, ranks on this host): torchrun's (and
    :func:`spawn_ranks`'s) LOCAL_RANK / LOCAL_WORLD_SIZE, else this
    process's global rank and the world size (one host)."""
    rank = dist.get_rank() if dist.is_initialized() else 0
    world = dist.get_world_size() if dist.is_initialized() else 1
    return (int(os.environ.get("LOCAL_RANK", rank)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))


def pick_backend(device_type: str, local_ranks: int) -> str:
    """NCCL when each of a host's ``local_ranks`` ranks has a card of its
    own; gloo when they share one, and on the CPU."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if local_ranks <= torch.cuda.device_count() else "gloo"


def init_distributed(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    device_type: str = "cuda",
) -> None:
    """Join (or form) the torch.distributed process group.

    Under torchrun, call with no arguments: its environment supplies the
    coordinator, count and id. Otherwise pass the three values or set
    BERT_TPU_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID. On ``"cuda"``
    each rank takes ``cuda:{local_rank % device_count}`` and raises when
    there is no card. Call once per process, before any collective.
    """
    coordinator = coordinator or os.environ.get(ENV_COORD)
    if num_processes is None and os.environ.get(ENV_NPROC):
        num_processes = int(os.environ[ENV_NPROC])
    if process_id is None and os.environ.get(ENV_PID):
        process_id = int(os.environ[ENV_PID])
    if coordinator is None:
        missing = [k for k in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                               "WORLD_SIZE") if k not in os.environ]
        if missing:
            raise RuntimeError(
                f"no process group to join: launch under torchrun "
                f"(--nproc-per-node N) or set {ENV_COORD}, {ENV_NPROC} and "
                f"{ENV_PID} (missing {', '.join(missing)})")
        init_method = "env://"
        num_processes = int(os.environ["WORLD_SIZE"])
        process_id = int(os.environ["RANK"])
    else:
        if num_processes is None or process_id is None:
            raise ValueError(
                f"explicit coordinator {coordinator!r} needs num_processes "
                f"and process_id too (got {num_processes}/{process_id}) — "
                f"set {ENV_NPROC} and {ENV_PID} alongside {ENV_COORD}")
        init_method = f"tcp://{coordinator}"
    local_rank = int(os.environ.get("LOCAL_RANK", process_id))
    local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    if device_type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a rank on 'cuda' found no CUDA device; pass "
                               "device_type='cpu' to run on the CPU")
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
        torch.cuda.init()
    backend = pick_backend(device_type, local_ranks)
    _logger.info("rank %d of %d: %s backend (%d local ranks, %s)",
                 process_id, num_processes, backend, local_ranks,
                 device_type if device_type == "cpu" else
                 f"{torch.cuda.device_count()} cards")
    dist.init_process_group(backend, init_method=init_method,
                            world_size=num_processes, rank=process_id)


def global_mesh(tp: int = 1, device_type: Optional[str] = None):
    """(data, model) mesh over every rank of the process group.

    Ranks are laid out host-major, so a model group of ``tp`` adjacent
    ranks stays inside one host as long as ``tp`` divides the ranks per
    host: the two all-reduces a layer then never cross the network, only
    data-axis traffic does. Validated here rather than silently spanning
    hosts with them."""
    from .mesh import make_mesh

    device_type = device_type or "cuda"
    if not dist.is_initialized():
        init_distributed(device_type=device_type)
    n_local = local_rank_and_size()[1]
    if tp > 1 and n_local % tp:
        raise ValueError(
            f"tp={tp} must divide local device count {n_local} so TP "
            "collectives stay inside one host (never the network)")
    world = dist.get_world_size()
    if world % tp:
        raise ValueError(f"tp={tp} must divide global device count {world}")
    return make_mesh(world, tp=tp, device_type=device_type)


def global_to_host_local(mesh, array):
    """This rank's rows of a whole batch (its leading axis cut into
    ``data``-axis shards, in rank order)."""
    return array[local_rows(mesh, array.shape[0])]


def host_local_batch_to_global(mesh, *arrays):
    """Each rank contributes its rows; returns the whole batch, the rows of
    the ``data`` axis concatenated in rank order, on every rank (numpy in,
    numpy out; tensors stay tensors)."""
    group = axis_group(mesh, DATA_AXIS)
    out = []
    for a in arrays:
        if isinstance(a, torch.Tensor):
            out.append(all_gather_dim(a, 0, group))
        else:
            t = torch.from_numpy(np.ascontiguousarray(a)).to(
                rank_device(mesh))
            out.append(all_gather_dim(t, 0, group).cpu().numpy())
    return tuple(out) if len(out) > 1 else out[0]


def allgather(mesh, x, tiled: bool = True) -> np.ndarray:
    """Every ``data``-axis rank's ``x`` on every rank as numpy:
    concatenated along axis 0 (``tiled=True``) or stacked on a new leading
    axis."""
    if not tiled:
        x = np.asarray(x)[None] if not isinstance(x, torch.Tensor) \
            else x[None]
    out = host_local_batch_to_global(mesh, x)
    return out.cpu().numpy() if isinstance(out, torch.Tensor) else out


# --- local launcher -----------------------------------------------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank, world, port, fn, args, results) -> None:
    """A spawned rank: torchrun's environment, then ``fn(*args)``; its
    value (or traceback) goes back on ``results``."""
    os.environ.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        out = (rank, True, fn(*args))
    except BaseException:  # reported to the parent, which raises
        out = (rank, False, traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    results.put(out)


def spawn_ranks(world: int, fn, *args, timeout: float = 600.0) -> List:
    """Run ``fn(*args)`` on ``world`` local processes (the ``spawn`` start
    method) with torchrun's environment and a free port, and return each
    rank's value in rank order. ``fn`` is a module-level function (spawn
    imports it by name); it forms the process group itself, typically
    through :func:`~bert_tpu_torch.parallel.mesh.make_mesh`. Raises with
    every failed rank's traceback; stops every process it started."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, port, fn, args, results),
                         daemon=True) for r in range(world)]
    for p in procs:
        p.start()
    got, deadline = {}, time.monotonic() + timeout
    try:
        # drain the queue before joining: a rank blocks in put() on a big
        # value until it is read
        while len(got) < world:
            try:
                rank, ok, value = results.get(timeout=1.0)
                got[rank] = (ok, value)
                continue
            except queue.Empty:
                pass
            dead = [r for r, p in enumerate(procs)
                    if r not in got and p.exitcode is not None]
            if dead:
                time.sleep(1.0)  # a value still on its way in the pipe
                while not results.empty():
                    rank, ok, value = results.get()
                    got[rank] = (ok, value)
                for r in dead:
                    got.setdefault(r, (False, f"rank {r} exited with code "
                                          f"{procs[r].exitcode}"))
            if time.monotonic() > deadline:
                raise TimeoutError(f"spawn_ranks: {world - len(got)} of "
                                   f"{world} ranks still running after "
                                   f"{timeout} s")
            if any(not ok for ok, _ in got.values()):
                break
    finally:
        for p in procs:
            p.join(timeout=10 if len(got) == world else 0)
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
    failed = {r: v for r, (ok, v) in sorted(got.items()) if not ok}
    if failed:
        raise RuntimeError("spawn_ranks: " + "\n".join(
            f"rank {r} failed:\n{v}" for r, v in failed.items()))
    return [got[r][1] for r in range(world)]
