"""The kernel build's lock (``ops/_build.py``): ranks that start cold
together build each library once. The compiler is a stub that records its
calls, so this runs without ``nvcc``."""

import json
import os
import stat
import subprocess
import sys

from ml_autofocusformermod_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

RANK = """
import json, sys
from pathlib import Path
from ml_autofocusformermod_torch.ops import _build
_build.BUILD_DIR = Path(sys.argv[1])
_build._nvcc = lambda: sys.argv[2]
info = _build.compile_all()
print(json.dumps({k: v["cached"] for k, v in info.items()}))
"""


def test_concurrent_cold_builds_compile_each_source_once(tmp_path):
    calls = tmp_path / "calls.txt"
    stub = tmp_path / "nvcc"
    # the stub writes the -o target after a pause, so the ranks overlap
    stub.write_text("#!/bin/sh\nwhile [ \"$1\" != -o ]; do shift; done\n"
                    f"sleep 0.5\necho \"$2\" >> {calls}\ntouch \"$2\"\n")
    stub.chmod(stub.stat().st_mode | stat.S_IXUSR)
    build = tmp_path / "build"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", RANK, str(build),
                               str(stub)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [json.loads(p.communicate(timeout=120)[0]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert len(calls.read_text().splitlines()) == len(_build.SOURCES)
    # one rank built everything; the others found it built
    fresh = [o for o in outs if not any(o.values())]
    cached = [o for o in outs if all(o.values())]
    assert len(fresh) == 1 and len(cached) == 2
    for name in _build.SOURCES:
        assert any(p.name.startswith(name + ".") and p.suffix == ".so"
                   for p in build.iterdir())
