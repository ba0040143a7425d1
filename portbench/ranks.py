"""One process a card: the launcher of a loop kind that sets ``PER_CARD``.

Rank 0 is the process ``run.py`` (or ``calibrate.py``) started.  It starts
ranks 1 to n - 1 as ``python3 -m portbench.ranks <spec>``, all of them join
one group through the port's ``init_distributed`` at a free local port
(NCCL on the cards, each rank on card ``rank``; gloo on the CPU), and every
rank runs the cell's loop and check (``run.one``).  Each rank checks the
outputs it kept and sends its numbers to rank 0 over a pipe; rank 0 takes
the worst of each number over the ranks, the sum of the failed frames and
the fullest card's peak memory.  Only rank 0 traces, and only it prints.

A rank that exits before it has sent its numbers, or a run that has not
ended by its deadline (``SETUP_S`` to reach the window, then the window and
``MARGIN_S``), ends the run: rank 0 kills every rank, waits for each, and
exits 1 without a result.  A rank whose rank 0 is gone exits too.
"""
from __future__ import annotations

import json
import math
import os
import socket
import struct
import subprocess
import sys
import threading
import time

SETUP_S = 1100.0  # to reach the window: the first run in a checkout builds the kernels
MARGIN_S = 90.0   # past the window's deadline: its last steps, the check, the hand-over
LAG = 16          # steps a rank's host may run ahead of what its card has finished
POLL_S = 0.2
STEP = struct.Struct("<q")


class Peers:
    """This process's side of a per-card run: on rank 0 the pipes to the
    other ranks and the watchdog, on another rank the pipe from rank 0;
    neither when the process runs alone."""

    def __init__(self, writers=(), reader: int | None = None, watchdog=None):
        self.writers, self.reader, self.watchdog = list(writers), reader, watchdog


_peers = Peers()  # set by ``launch`` and ``child`` for as long as they run


class WindowEnd:
    """The last step of a per-card window, the same on every rank.

    Rank 0 names it once its clock has passed ``deadline``: its own count
    of steps plus ``LAG`` + 1.  No rank has passed that count yet, because
    a rank enqueues step i only once its card has finished step i - LAG,
    and no card finishes a step's exchange before rank 0 has enqueued that
    step.  The other ranks read the step from rank 0's pipe."""

    def __init__(self, deadline: float):
        import torch.distributed as dist

        self.deadline, self.last = deadline, None
        alone = _peers.reader is None and not _peers.writers
        if alone and dist.is_initialized() and dist.get_world_size() > 1:
            raise RuntimeError("a per-card loop on several ranks outside ranks.launch")
        if _peers.watchdog is not None:
            _peers.watchdog.deadline = time.monotonic() + deadline - time.perf_counter() + MARGIN_S

    def done(self, steps: int) -> bool:
        """Whether the window ends after ``steps`` steps."""
        if self.last is None:
            if _peers.reader is not None:
                try:
                    data = os.read(_peers.reader, STEP.size)
                except BlockingIOError:
                    data = b""
                if len(data) == STEP.size:
                    self.last = STEP.unpack(data)[0]
            elif time.perf_counter() >= self.deadline:
                self.last = steps + LAG + 1 if _peers.writers else steps
                for fd in _peers.writers:
                    os.write(fd, STEP.pack(self.last))
        return self.last is not None and steps >= self.last


def stop(procs) -> None:
    """Kill each process still running, and wait for every one."""
    for p in procs:
        if p.poll() is None:
            p.kill()
    for p in procs:
        p.wait()


class Watchdog:
    """Rank 0's watch over the other ranks: it ends the process, with exit
    code 1 and no result, when a rank exits with an error or the run passes
    ``deadline`` (``time.monotonic``), after killing every rank."""

    def __init__(self, procs):
        self.procs = procs
        self.deadline = time.monotonic() + SETUP_S
        self._lock = threading.Lock()
        self._finished = False
        threading.Thread(target=self._watch, daemon=True).start()

    def _fault(self) -> str | None:
        for rank, p in enumerate(self.procs, 1):
            rc = p.poll()
            if rc not in (None, 0):
                return f"rank {rank} exited with {rc}"
        if time.monotonic() > self.deadline:
            return "a rank did not finish in time"
        return None

    def _watch(self) -> None:
        while True:
            time.sleep(POLL_S)
            with self._lock:
                if self._finished:
                    return
                why = self._fault()
                if why is not None:
                    print(f"portbench: {why}; no result", file=sys.stderr, flush=True)
                    stop(self.procs)
                    os._exit(1)

    def finish(self) -> None:
        """The run ended in time: the watch stops (and a fault it is
        handling now ends the process first)."""
        with self._lock:
            self._finished = True


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def join(world: int, rank: int, port: int, device) -> None:
    """Join the run's group through the port's ``init_distributed``."""
    import torch
    from vacv_tpu_torch import config
    from vacv_tpu_torch.parallel import init_distributed

    with config.device(torch.device(device).type):
        init_distributed(f"localhost:{port}", world, rank)


def leave(device) -> None:
    """Wait for every rank, then leave the group: all ranks destroy it
    together."""
    import torch
    import torch.distributed as dist

    if torch.device(device).type == "cuda":
        dist.barrier(device_ids=[torch.cuda.current_device()])
    else:
        dist.barrier()
    dist.destroy_process_group()


def _read_all(fd: int) -> bytes:
    chunks = []
    while chunk := os.read(fd, 1 << 16):
        chunks.append(chunk)
    return b"".join(chunks)


def _worst(values) -> float:
    """The largest value; one that is not a number counts as infinite."""
    return max(v if v == v else math.inf for v in values)


def launch(world: int, cfg: dict, traffic: dict, seed: int, seconds: float, trace: bool,
           device="cuda", system: str = "program", child=None):
    """(rank 0's Run, the numbers worst over the ranks) of a per-card run on
    ``world`` ranks.  ``child`` is the command that starts a rank, before
    its spec (by default ``python3 -m portbench.ranks``)."""
    global _peers
    from . import run as runner

    port = free_port()
    command = list(child or [sys.executable, "-m", "portbench.ranks"])
    procs, results, writers = [], [], []
    try:
        for rank in range(1, world):
            res_r, res_w = os.pipe()
            stop_r, stop_w = os.pipe()
            spec = {"cfg": cfg, "traffic": traffic, "seed": seed, "seconds": seconds,
                    "device": str(device), "system": system, "world": world, "rank": rank,
                    "port": port, "result_fd": res_w, "stop_fd": stop_r, "parent": os.getpid()}
            try:
                procs.append(subprocess.Popen(command + [json.dumps(spec)], stdout=sys.stderr,
                                              pass_fds=(res_w, stop_r)))
            finally:
                os.close(res_w)
                os.close(stop_r)
            results.append(res_r)
            writers.append(stop_w)
        watchdog = Watchdog(procs)
        _peers = Peers(writers=writers, watchdog=watchdog)
        join(world, 0, port, device)
        run, numbers = runner.one(cfg, traffic, seed, seconds, trace, device, system)
        leave(device)
        theirs = [_read_all(fd) for fd in results]
        for p in procs:
            p.wait()
        watchdog.finish()
    except BaseException:
        stop(procs)
        raise
    finally:
        _peers = Peers()
        for fd in results + writers:
            os.close(fd)
    for rank, (p, text) in enumerate(zip(procs, theirs), 1):
        if p.returncode != 0 or not text:
            raise RuntimeError(f"rank {rank} exited with {p.returncode} and sent no numbers")
    others = [json.loads(text) for text in theirs]
    names = set(numbers).union(*(o["numbers"] for o in others))
    numbers = {k: _worst([numbers.get(k, math.inf)] + [o["numbers"].get(k, math.inf)
                                                      for o in others]) for k in names}
    run.failed += sum(o["failed"] for o in others)
    run.peak_bytes = max([run.peak_bytes] + [o["peak_bytes"] for o in others])
    run.extra["ranks"] = [{"steps": run.steps, "outputs": len(run.samples)}] + \
        [{"steps": o["steps"], "outputs": o["outputs"]} for o in others]
    return run, numbers


def _watch_parent(parent: int) -> None:
    while os.getppid() == parent:
        time.sleep(POLL_S)
    os._exit(1)


def child(spec: dict) -> int:
    """Rank ``spec["rank"]``: join, run the loop and the check untraced,
    send the numbers to rank 0 and leave."""
    global _peers
    from . import run as runner

    threading.Thread(target=_watch_parent, args=(spec["parent"],), daemon=True).start()
    os.set_blocking(spec["stop_fd"], False)
    _peers = Peers(reader=spec["stop_fd"])
    device = spec["device"]
    join(spec["world"], spec["rank"], spec["port"], device)
    run, numbers = runner.one(spec["cfg"], spec["traffic"], spec["seed"], spec["seconds"],
                              False, device, spec["system"])
    leave(device)
    with os.fdopen(spec["result_fd"], "w") as f:
        json.dump({"numbers": numbers, "failed": run.failed, "peak_bytes": int(run.peak_bytes),
                   "steps": run.steps, "outputs": len(run.samples)}, f)
    return 0


if __name__ == "__main__":
    # The package's module, not this ``__main__`` copy: the loop reads its
    # ``_peers`` there.
    from portbench import ranks

    sys.exit(ranks.child(json.loads(sys.argv[1])))
