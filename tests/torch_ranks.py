"""Start N processes as the ranks of one torch.distributed job on this host
(the environment torchrun gives each), for the port's multi-process tests.
Imports nothing but the standard library."""

from __future__ import annotations

import os
import socket
import subprocess
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv_of_rank, world: int, logs_dir: Path, wall: float) -> list[str]:
    """Run ``argv_of_rank(rank)`` for every rank with torchrun's variables
    set (one CPU thread each) and return each rank's output. When a rank
    fails the others are stopped at once; past ``wall`` seconds all are.
    Raises AssertionError naming the first rank that did not exit 0."""
    env = {k: v for k, v in os.environ.items() if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env.update(
        OMP_NUM_THREADS="1", PYTHONPATH=str(REPO), MASTER_ADDR="localhost",
        MASTER_PORT=str(free_port()), WORLD_SIZE=str(world),
    )
    logs = [logs_dir / f"rank{r}.log" for r in range(world)]
    procs = []
    for r in range(world):
        with open(logs[r], "w") as out:
            procs.append(subprocess.Popen(
                argv_of_rank(r), cwd=REPO, stdout=out, stderr=subprocess.STDOUT,
                env=dict(env, RANK=str(r), LOCAL_RANK=str(r)),
            ))
    deadline = time.monotonic() + wall
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.2)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    texts = [log.read_text() for log in logs]
    for r, (p, text) in enumerate(zip(procs, texts)):
        assert p.returncode == 0, f"rank {r} exited {p.returncode}:\n{text[-4000:]}"
    return texts
