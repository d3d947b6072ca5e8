"""Record which CPU vector-math calls of the port the tests reach, on how
many threads and on how many elements.

PyTorch's CPU build sends the functions in ``VML`` (its
``ATen/cpu/vml.h``) to MKL's vector math split over its threads, at least
2048 elements a thread; a call on more than 2048 elements and more than one
thread is one that MKL's first-call race could reach (``scripts/torch_vml_first_call.py``).
``OTHER`` are the port's other transcendental calls, which PyTorch computes
with its own vector code.

The script runs pytest with a ``sitecustomize`` that wraps each of these
functions (``torch.<f>``, ``Tensor.<f>``, ``torch._foreach_<f>`` and their
in-place forms) in every process the tests start: the pytest workers, the
CLIs and the gloo ranks. A wrapped call on a CPU float tensor records the
test (``PYTEST_CURRENT_TEST``), the innermost ``ttamm_torch`` line that made
it, the thread count and the largest tensor. Prints one JSON object: for
each function and port line, whether it is VML, the calls, the largest
tensor on one thread and on more, and the tests that passed it more than
2048 elements on more than one thread.

    python scripts/torch_cpu_math_audit.py                    # tests/test_torch_port_*.py
    python scripts/torch_cpu_math_audit.py tests/test_torch_port_train_step.py -n 0
"""

from __future__ import annotations

import glob
import json
import os
import subprocess
import sys
import tempfile
from collections import defaultdict

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VML = ("sqrt", "exp", "log", "tanh", "erf", "erfc", "erfinv", "sin", "cos", "tan", "acos",
       "asin", "atan", "log2", "log10", "trunc")
OTHER = ("log1p", "sigmoid", "expm1", "rsqrt")
GRAIN = 2048
_ENV = "TTAMM_CPU_MATH_AUDIT"
_SITE = """import os, sys
if os.environ.get({env!r}):
    sys.path.insert(0, {scripts!r})
    import torch_cpu_math_audit
    torch_cpu_math_audit.install(os.environ[{env!r}], os.path.dirname(__file__))
"""


def install(out_dir: str, site_dir: str) -> None:
    """Wrap the functions in this process; hand ``site_dir`` on to the
    children (the tests' launchers set their own ``PYTHONPATH``)."""
    import atexit
    import traceback

    import torch

    records: dict = {}

    def port_line() -> str:
        for frame in reversed(traceback.extract_stack(limit=30)[:-2]):
            if "/ttamm_torch/" in frame.filename:
                return f"ttamm_torch/{frame.filename.split('/ttamm_torch/')[-1]}:{frame.lineno}"
        return ""

    def wrap(owner, attr: str, name: str) -> None:
        fn = getattr(owner, attr, None)
        if fn is None:
            return

        def wrapped(*args, **kwargs):
            first = args[0] if args else None
            items = first if isinstance(first, (list, tuple)) else [first]
            sizes = [t.numel() for t in items if isinstance(t, torch.Tensor)
                     and t.device.type == "cpu" and t.is_floating_point()]
            line = port_line() if sizes else ""
            if line:
                test = os.environ.get("PYTEST_CURRENT_TEST", "").rsplit(" (", 1)[0]
                key = (name, line, test, torch.get_num_threads())
                largest, calls = records.get(key, (0, 0))
                records[key] = (max(largest, max(sizes)), calls + 1)
            return fn(*args, **kwargs)

        setattr(owner, attr, wrapped)

    for f in VML + OTHER:
        for suffix in ("", "_"):
            wrap(torch, f + suffix, f)
            wrap(torch.Tensor, f + suffix, f)
            wrap(torch, f"_foreach_{f}{suffix}", f"_foreach_{f}")

    popen_init = subprocess.Popen.__init__

    def popen(self, *args, **kwargs):
        env = kwargs.get("env")
        if env is not None and _ENV in env:
            kwargs["env"] = dict(env, PYTHONPATH=os.pathsep.join(
                [site_dir] + [p for p in [env.get("PYTHONPATH", "")] if p]))
        popen_init(self, *args, **kwargs)

    subprocess.Popen.__init__ = popen

    @atexit.register
    def dump() -> None:
        if records:
            with open(os.path.join(out_dir, f"{os.getpid()}.json"), "w") as f:
                json.dump([[*k, *v] for k, v in records.items()], f)


def summarize(out_dir: str) -> dict:
    rows = []
    for path in glob.glob(os.path.join(out_dir, "*.json")):
        with open(path) as f:
            rows += json.load(f)
    out: dict = defaultdict(lambda: {"calls": 0, "largest_one_thread": 0,
                                     "largest_threaded": 0, "tests_past_grain_threaded": set()})
    for name, line, test, threads, largest, calls in rows:
        e = out[f"{name} {line}"]
        e["vml"] = name.removeprefix("_foreach_") in VML
        e["calls"] += calls
        side = "largest_threaded" if threads > 1 else "largest_one_thread"
        e[side] = max(e[side], largest)
        if threads > 1 and largest > GRAIN:
            e["tests_past_grain_threaded"].add(test)
    return {k: dict(v, tests_past_grain_threaded=sorted(v["tests_past_grain_threaded"]))
            for k, v in sorted(out.items())}


def main(argv: list[str]) -> int:
    tests = argv or sorted(glob.glob(os.path.join(ROOT, "tests", "test_torch_port_*.py")))
    if not any(a.startswith("-n") for a in tests):
        tests += ["-p", "xdist", "-n", "6", "--dist", "loadfile"]
    with tempfile.TemporaryDirectory() as tmp:
        site, out = os.path.join(tmp, "site"), os.path.join(tmp, "out")
        os.makedirs(site)
        os.makedirs(out)
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(_SITE.format(env=_ENV, scripts=os.path.join(ROOT, "scripts")))
        path = os.pathsep.join([site] + [p for p in [os.environ.get("PYTHONPATH", "")] if p])
        env = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu", **{_ENV: out})
        rc = subprocess.run([sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
                             "-m", "not slow", *tests], cwd=ROOT, env=env).returncode
        print(json.dumps({"pytest_rc": rc, "calls": summarize(out)}))
    return rc


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
