"""The launcher of a cell on N > 1 chips: N ranks of benchmark/run.py, one a
card, in torchrun's environment (the address of a free port on
localhost, the world size, the rank, LOCAL_RANK the card), each told the
launcher's start time so that setup_s counts from it. Rank 0's standard
output ends with its result; every rank's standard error is this
process's. A rank that fails, or a run past the deadline, ends every
rank; the launcher waits for each to end.
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

DEADLINE_S = 345  # a run exits within 360 s


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def torchrun_env(world: int, rank: int, port: int) -> dict:
    return dict(WORLD_SIZE=str(world), RANK=str(rank), LOCAL_RANK=str(rank),
                MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))


def launch(args, world: int, t0_wall: float, script: Path) -> dict | None:
    """Run the ranks to their end: rank 0's result, or None if a rank
    failed or the deadline passed."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="bench-ranks-") as tmp:
        outs = [open(Path(tmp) / f"rank{r}.out", "w") for r in range(world)]
        cmd = [sys.executable, str(script), "--workload", args.workload, "--seed", str(args.seed),
               "--seconds", str(args.seconds), "--trace", str(args.trace), "--t0", repr(t0_wall)]
        if args.fault:
            cmd += ["--fault", args.fault]
        procs = [subprocess.Popen(cmd + ["--rank", str(r)], stdout=outs[r],
                                  env={**os.environ, **torchrun_env(world, r, port)})
                 for r in range(world)]
        failed = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs) if p.poll() not in (None, 0)]
                if bad:
                    failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}"
                    break
                if time.time() - t0_wall > DEADLINE_S:
                    failed = "the ranks passed the deadline"
                    break
                time.sleep(0.2)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
            for p in procs:
                p.wait()
            for f in outs:
                f.close()
        if failed is None:
            bad = [r for r, p in enumerate(procs) if p.returncode != 0]
            failed = f"rank {bad[0]} exited {procs[bad[0]].returncode}" if bad else None
        if failed:
            print(f"bench: {failed}", file=sys.stderr)
            return None
        lines = (Path(tmp) / "rank0.out").read_text().strip().splitlines()
    if not lines:
        print("bench: rank 0 printed no result", file=sys.stderr)
        return None
    return json.loads(lines[-1])
