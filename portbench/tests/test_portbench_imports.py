"""Nothing the benchmark runs loads JAX or the JAX package, and the plain
reference loads nothing of the program.  Module names are compared by their
top-level part whole: the port's name begins with the JAX package's."""

import ast
import subprocess
import sys
from pathlib import Path

from portbench import harness

PB = Path(harness.__file__).resolve().parent
ROOT = PB.parent
PROGRAM = harness.PROGRAM


def _imports(path: Path):
    """(top-level names, portbench modules) a file imports."""
    tops, local = set(), set()
    pkg = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-1])
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            base = node.module or ""
            if node.level:
                parent = pkg.split(".")[: len(pkg.split(".")) - node.level + 1]
                base = ".".join(parent + ([base] if base else []))
            names = [base] + [f"{base}.{a.name}" for a in node.names]
        else:
            continue
        for n in names:
            tops.add(n.split(".", 1)[0])
            if n.startswith("portbench"):
                local.add(n)
    return tops, local


def _module_file(name: str):
    p = ROOT.joinpath(*name.split("."))
    for cand in (p.with_suffix(".py"), p / "__init__.py"):
        if cand.is_file():
            return cand
    return None


def _graph(starts):
    seen, tops, todo = set(), set(), list(starts)
    while todo:
        f = todo.pop()
        if f in seen:
            continue
        seen.add(f)
        t, local = _imports(f)
        tops |= t
        todo += [m for m in map(_module_file, local) if m is not None]
    return seen, tops


def test_nothing_the_benchmark_runs_imports_jax():
    starts = [PB / "run.py", PB / "control.py", *sorted((PB / "metrics").glob("*.py")),
              *sorted((PB / "reference").glob("*.py"))]
    files, tops = _graph(starts)
    assert PB / "harness.py" in files and PB / "judge.py" in files
    assert not tops & set(harness.FORBIDDEN), tops & set(harness.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    files, tops = _graph(sorted((PB / "reference").glob("*.py")))
    assert all(f.parent == PB / "reference" for f in files), files
    assert PROGRAM not in tops and not tops & set(harness.FORBIDDEN)
    assert tops <= {"__future__", "ast", "math", "typing", "numpy", "torch", "portbench"}, tops


def test_a_run_loads_no_jax(tmp_path):
    """A tiny cell run on the CPU, then the process's modules, as run.py checks them."""
    code = ("import sys; sys.path.insert(0, %r); from pathlib import Path; "
            "from portbench.tests import tiny; from portbench import harness; "
            "root = tiny.build(Path(%r)); tiny.run(root, 'tiny_bev_serve', seconds=0.5); "
            "print(harness.forbidden_modules(sys.modules))") % (str(ROOT), str(tmp_path))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_forbidden_names_compare_whole_top_level_names():
    assert harness.forbidden_modules([PROGRAM, f"{PROGRAM}.ops", "jaxtyping", "flaxx"]) == []
    assert harness.forbidden_modules(["jax.numpy", "faster_rcnn_pytorch_multimodal_tpu.ops",
                                      "optax"]) == ["faster_rcnn_pytorch_multimodal_tpu", "jax",
                                                    "optax"]
