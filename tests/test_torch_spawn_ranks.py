"""The port's one spawner of rank processes (``parallel/mesh.py``:
``spawn_ranks`` / ``wait_ranks``), which the data-parallel tools, the
elastic supervisor and the test workers all start their worlds through."""

import sys
import tempfile
import time

from deeplearning4j_tpu_torch.parallel.mesh import spawn_ranks, wait_ranks

PRINT_WORLD = ("import os; print(os.environ['RANK'], os.environ['WORLD_SIZE'], "
               "os.environ['MASTER_ADDR'], os.environ['MASTER_PORT'])")


def _read(log) -> str:
    log.seek(0)
    return log.read()


def test_each_rank_sees_its_place_in_one_world():
    logs = [tempfile.TemporaryFile(mode="w+") for _ in range(3)]
    procs = spawn_ranks([sys.executable, "-c", PRINT_WORLD], 3, stdout=logs)
    assert wait_ranks(procs, timeout=60) == 0
    seen = [_read(log).split() for log in logs]
    assert [s[0] for s in seen] == ["0", "1", "2"]
    assert {s[1] for s in seen} == {"3"}
    assert {s[2] for s in seen} == {"127.0.0.1"}
    assert len({s[3] for s in seen}) == 1  # one rendezvous port


def test_a_failed_rank_ends_the_world_after_the_grace():
    # rank 0 fails at once; rank 1 would block (as in a collective) for a minute
    code = "import os, sys, time; sys.exit(3) if os.environ['RANK'] == '0' else time.sleep(60)"
    t0 = time.monotonic()
    procs = spawn_ranks([sys.executable, "-c", code], 2)
    assert wait_ranks(procs, grace=0.5) == 3
    assert time.monotonic() - t0 < 30
    assert all(p.poll() is not None for p in procs)
    assert procs[1].returncode != 0  # killed, not finished


def test_the_timeout_kills_every_rank():
    procs = spawn_ranks([sys.executable, "-c", "import time; time.sleep(60)"], 2)
    t0 = time.monotonic()
    assert wait_ranks(procs, timeout=1.0) != 0
    assert time.monotonic() - t0 < 30
    assert all(p.returncode is not None and p.returncode != 0 for p in procs)
