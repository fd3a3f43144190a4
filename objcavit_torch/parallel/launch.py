"""Start N processes of one command, joined into one process group.

    python -m objcavit_torch.parallel.launch -n 2 -- python -m objcavit_torch.cli -c cfg.yaml

The port's copy of ``scripts/launch_multiprocess.py``: each child gets the
``OBJCAVIT_COORDINATOR`` (``127.0.0.1`` and a free port, or ``--port``),
``OBJCAVIT_NUM_PROCESSES`` and ``OBJCAVIT_PROCESS_ID`` env that
``parallel/distributed.py::initialize_distributed`` reads; ``cli.main``
then joins the group, NCCL on the card (rank p on card p % count) or gloo
on the CPU. ``--cpu`` sets ``OBJCAVIT_DEVICE=cpu``, which ``cli.main``
takes as its device, so the children train on the CPU over gloo (testing
without cards). Each child's output lines are prefixed with its rank. The
exit status is the first non-zero child status; the other children are
then terminated (a dead rank wedges the others' collectives).
"""

from __future__ import annotations

import argparse
import os
import signal
import socket
import subprocess
import sys
import threading
import time

from objcavit_torch.parallel.distributed import (
    ENV_COORDINATOR,
    ENV_DEVICE,
    ENV_NUM_PROCESSES,
    ENV_PROCESS_ID,
)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _pump(rank: int, stream, out) -> None:
    for line in iter(stream.readline, ""):
        out.write(f"[rank {rank}] {line}")
        out.flush()


def launch(cmd: list[str], num_processes: int, port: int | None = None, cpu: bool = False,
           out=None, timeout: float | None = None) -> int:
    """Run ``num_processes`` copies of ``cmd`` with the env above, their
    lines to ``out`` (stdout); -> the first non-zero exit status, else 0.
    Past ``timeout`` seconds every child is killed and the status is 124."""
    out = sys.stdout if out is None else out
    port = port or free_port()
    procs: list[subprocess.Popen] = []
    pumps = []
    for rank in range(num_processes):
        env = dict(os.environ)
        env[ENV_COORDINATOR] = f"127.0.0.1:{port}"
        env[ENV_NUM_PROCESSES] = str(num_processes)
        env[ENV_PROCESS_ID] = str(rank)
        if cpu:
            env[ENV_DEVICE] = "cpu"
        p = subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                             text=True, bufsize=1)
        procs.append(p)
        t = threading.Thread(target=_pump, args=(rank, p.stdout, out), daemon=True)
        t.start()
        pumps.append(t)

    rc = 0
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            try:
                code = p.wait(None if deadline is None else max(deadline - time.monotonic(), 0))
            except subprocess.TimeoutExpired:
                rc = 124
                break
            if code != 0 and rc == 0:
                rc = code
                for q in procs:
                    if q.poll() is None:
                        q.terminate()
    except KeyboardInterrupt:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGINT)
        rc = 130
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for t in pumps:
        t.join(timeout=5)
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(usage="%(prog)s [-n N] [--port P] [--cpu] -- command ...")
    ap.add_argument("-n", "--num-processes", type=int, default=2)
    ap.add_argument("--port", type=int, default=None)
    ap.add_argument("--cpu", action="store_true",
                    help=f"the children train on the CPU over gloo ({ENV_DEVICE}=cpu)")
    ap.add_argument("command", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    cmd = args.command
    if cmd and cmd[0] == "--":
        cmd = cmd[1:]
    if not cmd:
        ap.error("no command given (put it after --)")
    return launch(cmd, args.num_processes, args.port, args.cpu)


if __name__ == "__main__":
    raise SystemExit(main())
