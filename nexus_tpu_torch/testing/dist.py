"""A local spawner of ``torch.distributed`` ranks, for the tests and for
``chip_smoke.py``: each rank is a process started with the ``spawn``
method, joined into one group through a ``FileStore`` under a temporary
directory (no fixed port: several test processes may spawn at once).

``fn`` and its arguments are pickled into every rank, ``fn`` by its import
path: it lives in a module that imports neither JAX nor the JAX package, as
the ranks import that module. A rank that raises fails the whole call; the
others are ended. The call's error names every rank that raised, in rank
order, so the rank at fault is named even when another rank, whose
collective it left, ends first.
"""

from __future__ import annotations

import datetime
import os
import tempfile
from typing import Any, Callable, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from nexus_tpu_torch.parallel.comm import check_backend


def _rank_main(rank: int, fn: Callable, world: int, backend: str, workdir: str,
               args: Sequence[Any], threads: int, timeout_s: float) -> None:
    os.environ["LOCAL_RANK"] = str(rank)
    torch.set_num_threads(threads)
    store = dist.FileStore(os.path.join(workdir, "store"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        result = fn(*args)
        torch.save(result, os.path.join(workdir, f"result-{rank}.pt"))
    except BaseException as e:
        # written before the group goes down, so before any peer can fail
        # in a collective this rank left
        with open(os.path.join(workdir, f"error-{rank}.txt"), "w") as f:
            f.write(f"{type(e).__name__}: {e}")
        raise
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Sequence[Any] = (), backend: str = "gloo",
          tmpdir: Optional[str] = None, threads: int = 1,
          timeout_s: float = 600.0) -> List[Any]:
    """Run ``fn(*args)`` on ``world`` ranks; returns each rank's result, in
    rank order. ``LOCAL_RANK`` is set in each rank; ``timeout_s`` bounds
    every collective."""
    if backend == "nccl":
        check_backend(backend, world, torch.cuda.device_count())
    with tempfile.TemporaryDirectory(dir=tmpdir, prefix="nexus-dist-") as workdir:
        try:
            mp.spawn(_rank_main, args=(fn, world, backend, workdir, tuple(args), threads,
                                       timeout_s),
                     nprocs=world, join=True, start_method="spawn")
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as e:
            errors = [f"rank {r}: {open(path).read()}" for r in range(world)
                      if os.path.exists(path := os.path.join(workdir, f"error-{r}.txt"))]
            raise RuntimeError("ranks failed:\n" + "\n".join(errors or [str(e)])) from e
        return [torch.load(os.path.join(workdir, f"result-{r}.pt"), weights_only=False)
                for r in range(world)]
