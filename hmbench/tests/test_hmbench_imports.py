"""Nothing that the benchmark loads imports JAX or the JAX package, compared
by whole top-level names (the port, hetmogp_tpu_torch, is not the JAX
package), and the reference imports nothing of the port.

The imports of every module that the entry, the generators, the readers and
the calibration reach inside the repository are parsed, following the
repository's own modules; and a process that loads them all is asked which
modules it holds."""

from __future__ import annotations

import ast
import subprocess
import sys

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "hetmogp_tpu"}
OWN = {"hmbench", "hetmogp_tpu_torch"}


def _file(module: str):
    base = ROOT.joinpath(*module.split("."))
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _imports(path):
    """(top-level names, repository modules) that the file imports."""
    tops, mods = set(), set()
    pkg = ".".join(path.relative_to(ROOT).with_suffix("").parts)
    if path.name == "__init__.py":
        pkg = pkg.rsplit(".", 1)[0] + ".__init__"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = pkg.split(".")[:-node.level]
                base = ".".join(parent + ([base] if base else []))
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for n in names:
            if n:
                tops.add(n.split(".")[0])
                if n.split(".")[0] in OWN and _file(n):
                    mods.add(n)
    return tops, mods


def _closure(start):
    seen, todo, tops = set(), list(start), {}
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        t, mods = _imports(path)
        tops[path] = t
        for m in mods:
            parts = m.split(".")
            for i in range(1, len(parts) + 1):  # each package on the way
                f = _file(".".join(parts[:i]))
                if f is not None and f not in seen:
                    todo.append(f)
    return tops


def test_nothing_the_benchmark_loads_imports_jax_or_the_jax_package():
    h = ROOT / "hmbench"
    start = [h / "run.py", h / "calibrate.py", *h.glob("kinds/*.py"),
             *h.glob("layer_metrics/*.py")]
    tops = _closure(start)
    assert any("hetmogp_tpu_torch" in str(p) for p in tops)  # the port is followed
    bad = {str(p): sorted(t & FORBIDDEN) for p, t in tops.items() if t & FORBIDDEN}
    assert not bad, bad


def test_the_reference_imports_nothing_of_the_program():
    tops = _closure(list((ROOT / "hmbench" / "reference").glob("*.py")))
    assert all(str(p).startswith(str(ROOT / "hmbench")) for p in tops)
    bad = {str(p): sorted(t & (FORBIDDEN | {"hetmogp_tpu_torch"}))
           for p, t in tops.items() if t & (FORBIDDEN | {"hetmogp_tpu_torch"})}
    assert not bad, bad


def test_a_process_that_loads_the_benchmark_holds_no_jax():
    code = (
        "import sys, runpy, glob\n"
        "import hmbench.run, hmbench.calibrate, hmbench.kinds.train, "
        "hmbench.kinds.serve_closed, hmbench.port\n"
        "for f in glob.glob('hmbench/layer_metrics/*.py'): runpy.run_path(f)\n"
        "print(sorted({m.split('.')[0] for m in sys.modules} & set("
        f"{sorted(FORBIDDEN)!r})))\n"
        "print('hetmogp_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]
