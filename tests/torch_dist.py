"""Helpers of the port's distributed tests: a gloo world of one in this
process, and gloo worlds of several processes on localhost.

Spawned ranks are fresh interpreters that import only svo_tpu_torch (and
numpy); each has a timeout of its own, and a rank that fails or hangs fails
the test with its stderr.
"""

from __future__ import annotations

import contextlib
import os
import socket
import subprocess
import sys
import tempfile

import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def world_of_one():
    """A gloo process group holding this process alone (its rendezvous a
    file, so no port is taken), torn down after."""
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", init_method=f"file://{tmp}/store", world_size=1, rank=0)
        try:
            yield dist.group.WORLD
        finally:
            dist.destroy_process_group()


def run_ranks(argv_of_rank, n: int, timeout: float = 240.0) -> list[str]:
    """Start n processes, argv_of_rank(rank, port) each, and wait for all of
    them; returns their stdouts. Every rank must exit 0 within `timeout`."""
    port = free_port()
    procs = [
        subprocess.Popen([sys.executable] + argv_of_rank(r, port), cwd=REPO,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(n)
    ]
    outs = []
    try:
        for r, p in enumerate(procs):
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank {r} exited {p.returncode}\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_code(code: str, n: int, timeout: float = 240.0, **subs) -> list[str]:
    """run_ranks with `python3 -c code`, where the code finds RANK, WORLD and
    PORT (and any **subs, by name) as globals."""
    def argv(rank, port):
        head = f"RANK, WORLD, PORT = {rank}, {n}, {port}\n"
        head += "".join(f"{k} = {v!r}\n" for k, v in subs.items())
        return ["-c", head + code]

    return run_ranks(argv, n, timeout)
