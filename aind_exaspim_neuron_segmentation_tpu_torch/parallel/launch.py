"""Local multi-rank jobs: one process per rank on this host.

:func:`spawn` starts ``world`` processes of one command, each with the
job in its environment under torchrun's contract (``MASTER_ADDR`` /
``MASTER_PORT`` / ``WORLD_SIZE`` / ``RANK``), which
:func:`.mesh.initialize_distributed` reads; :func:`join` waits for all
of them under one deadline. A rank that fails or outlives the deadline
takes the others down (a crashed rank leaves its peers blocked in a
collective) and :func:`join` raises with every rank's log tail.

The ranks use gloo: several ranks that share one card must, since NCCL
refuses two ranks on one device.
"""

import os
import socket
import subprocess
import sys
import time

# the directory that holds the package, so ``python -m`` finds it from
# any working directory
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_JOB_NAMES = ("JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
              "JAX_NUM_PROCESSES", "JAX_PROCESS_ID", "LOCAL_RANK")


def free_port():
    """A free localhost TCP port."""
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def rank_env(rank, world, port):
    """The environment of rank ``rank`` of a local job of ``world``
    ranks: this process's, without another job's names, plus the job's;
    the ranks share the host's CPUs (``OMP_NUM_THREADS``)."""
    env = {k: v for k, v in os.environ.items() if k not in _JOB_NAMES}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
               WORLD_SIZE=str(world), RANK=str(rank),
               EXA_DIST_HOST="127.0.0.1", EXA_DIST_BACKEND="gloo")
    env["OMP_NUM_THREADS"] = str(max(1, (os.cpu_count() or 1) // world))
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (ROOT, env.get("PYTHONPATH")) if p)
    return env


def spawn(argv, world, log_dir, name):
    """Start ``world`` processes of ``argv``, stdout and stderr of rank r
    to ``log_dir/<name>.r<r>.log``; returns them."""
    port = free_port()
    procs = []
    for rank in range(world):
        with open(log_path(log_dir, name, rank), "w") as log:
            procs.append(subprocess.Popen(
                argv, cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
                env=rank_env(rank, world, port)))
    return procs


def log_path(log_dir, name, rank):
    """Where :func:`spawn` sends rank ``rank``'s output."""
    return os.path.join(log_dir, f"{name}.r{rank}.log")


def join(procs, log_dir, name, timeout):
    """Wait for every process of ``procs`` until ``timeout`` seconds have
    passed; on the first failure, or at the deadline, kill the rest.
    Raises unless every rank exited 0; returns the ranks' logs."""
    deadline = time.monotonic() + timeout
    try:
        while True:
            codes = [p.poll() for p in procs]
            if (all(c is not None for c in codes)
                    or any(c not in (None, 0) for c in codes)
                    or time.monotonic() > deadline):
                break
            time.sleep(0.2)
    finally:
        late = time.monotonic() > deadline
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    status = [c if c is not None else ("timeout" if late else "killed")
              for c in codes]
    logs = []
    for rank in range(len(procs)):
        with open(log_path(log_dir, name, rank)) as f:
            logs.append(f.read())
    if any(s != 0 for s in status):
        raise RuntimeError(
            f"{name}: ranks exited {status} (timeout {timeout} s)\n"
            + "\n".join(f"--- rank {r}:\n{log[-4000:]}"
                        for r, log in enumerate(logs)))
    return logs


def run(argv, world, log_dir, name, timeout):
    """:func:`spawn` then :func:`join`: the logs of a job that succeeded."""
    return join(spawn(argv, world, log_dir, name), log_dir, name, timeout)


def module_argv(module, *args):
    """``python -m module args...`` with this interpreter."""
    return [sys.executable, "-m", module, *map(str, args)]
