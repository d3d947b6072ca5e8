"""The port's CPU vector math in a fresh process, and the mesh update
test's inputs across processes.

PyTorch's CPU build sends ``sqrt``, ``exp``, ``log`` and ``tanh`` to MKL's
vector math (VML) split over its threads, at least 2048 elements a thread,
and when several threads make a process's first VML call at once, one
thread's part can come back at 12 to 15 correct bits. ``ttamm_torch.device`` makes that first call
on one thread when the port is imported. Each case below starts a few
processes that import ``ttamm_torch``, set 64 torch threads and make the
function's first call, as the port calls it, on 65,536 float32 values
(``scripts/torch_vml_first_call.py --child --port``), held to float64 numpy
at 1e-6 relative. The script counts hundreds of processes; these few keep
the repair in place.

``tests/test_torch_port_parallel_mesh.py`` draws its update inputs from a
seed of the case's name: the same bytes under two ``PYTHONHASHSEED``s.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
SCRIPT = REPO / "scripts" / "torch_vml_first_call.py"
OPS = ("torch.sqrt", "torch._foreach_sqrt", "torch.exp", "torch.log", "torch.log1p",
       "torch.tanh")
PROCESSES = 3


def _run_together(commands, envs=None):
    """Start every command at once and return their standard outputs; each
    must exit 0 within 240 s. No process outlives the call."""
    procs = [subprocess.Popen(cmd, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=None if envs is None else envs[i])
             for i, cmd in enumerate(commands)]
    try:
        outs = []
        for p in procs:
            stdout, stderr = p.communicate(timeout=240)
            assert p.returncode == 0, stderr[-4000:]
            outs.append(stdout)
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


@pytest.fixture(scope="module")
def first_calls():
    """Every op's processes, started together: op -> their JSON lines."""
    runs = [(op, [sys.executable, str(SCRIPT), "--child", "--port", "--op", op, "--threads",
                  "64", "--n", "65536"]) for op in OPS for _ in range(PROCESSES)]
    outs = _run_together([cmd for _, cmd in runs])
    out = {op: [] for op in OPS}
    for (op, _), stdout in zip(runs, outs):
        out[op].append(json.loads(stdout.strip().splitlines()[-1]))
    return out


@pytest.mark.parametrize("op", OPS)
def test_first_cpu_math_call_after_import_is_within_1e6(first_calls, op):
    for r in first_calls[op]:
        assert not r["bad"], (
            f"{op}: {r['elements']} of 65,536 values more than 1e-6 relative off float64, "
            f"max {r['max_rel']:.3e}, in 2048-element chunks {r['chunks']}")
        assert r["max_rel"] <= 1e-6


_DRAW = """
import sys
sys.path[:0] = [{tests!r}, {repo!r}]
import test_torch_port_parallel_mesh as tm
for name, spec in sorted(tm.UPDATES.items()):
    x = tm._update_inputs(name, *spec[3:])
    for key in sorted(x):
        sys.stdout.write(name + " " + key + " " + x[key].tobytes().hex() + "\\n")
"""


def test_mesh_update_inputs_are_the_same_in_every_process():
    code = _DRAW.format(tests=str(REPO / "tests"), repo=str(REPO))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONHASHSEED"}
    env.update(JAX_PLATFORMS="cpu")
    seeds = ("1", "2")
    outs = [out.splitlines() for out in _run_together(
        [[sys.executable, "-c", code]] * len(seeds),
        [dict(env, PYTHONHASHSEED=seed) for seed in seeds])]
    assert len(outs[0]) == 5 * 6
    for a, b in zip(*outs):
        name, key = a.split()[:2]
        assert a == b, f"{name} {key} differs between the two processes"
    # and a draw is not all zeros or repeated across the cases
    tables = [np.frombuffer(bytes.fromhex(line.split()[2]), np.float32)
              for line in outs[0] if line.split()[1] == "table"]
    assert len({t.tobytes() for t in tables}) == 6 and all(np.abs(t).max() > 0 for t in tables)
