"""Nothing the benchmark runs imports JAX or the JAX package: every
module imported by a file of portbench/ (its tests aside) has a
top-level name, compared whole, outside the forbidden ones
(`swraytracing_torch` begins with `swraytracing_tpu`'s letters)."""

import ast
import json
import subprocess
import sys

from conftest import ROOT

from portbench.core import FORBIDDEN


def imported_names(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_forbidden_imports_in_sources():
    files = [p for p in (ROOT / "portbench").rglob("*.py")
             if "tests" not in p.relative_to(ROOT).parts]
    assert files
    for p in files:
        for name in imported_names(p):
            assert name.split(".")[0] not in FORBIDDEN, (p, name)
    # the port's functions that trace.py spans, imported by name
    for p in (ROOT / "portbench" / "spans").glob("*.json"):
        name = json.loads(p.read_text())["module"]
        assert name.split(".")[0] not in FORBIDDEN, (p, name)


def test_harness_loads_no_forbidden_module():
    """Import everything the harness reaches in a fresh process."""
    code = ("import sys, importlib; sys.path.insert(0, %r)\n"
            "from portbench import core, trace, calibrate, compare, faults\n"
            "with trace.port_spans(): pass\n"
            "from portbench.modes import forward, ensemble, grad\n"
            "import portbench.run\n"
            "from portbench.core import forbidden_modules\n"
            "print(forbidden_modules())" % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]", out.stdout
