"""Nothing that the benchmark runs loads JAX or the JAX package, and the
plain reference loads nothing of the port.  Module names are compared by
their top-level name (the part before the first dot), whole: the port's
name begins with the JAX package's."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "benchmark"
sys.path.insert(0, str(ROOT))

from benchmark.harness import cell  # noqa: E402

PORT = cell.PACKAGE
JAX_PACKAGE = PORT[:-len("_torch")]
FORBIDDEN = {"jax", "jaxlib", "flax", JAX_PACKAGE}

# a meta path finder that refuses the given top-level names, then the code
BLOCKED_RUN = """
import sys
names = set(sys.argv[1].split(","))
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in names:
            raise ImportError(f"blocked: {name}")
sys.meta_path.insert(0, Block())
sys.path[:0] = [sys.argv[2]]
exec(sys.argv[3])
"""


def _imports(path: Path):
    """The top-level names that a source file imports (relative imports
    stay inside the benchmark)."""
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module":
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield str(arg.value).split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        if "tests" in path.relative_to(BENCH_DIR).parts:
            continue
        assert not set(_imports(path)) & FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH_DIR / "reference").rglob("*.py"):
        names = set(_imports(path))
        assert not names & (FORBIDDEN | {PORT}), (path, names)
        assert names <= {"__future__", "math", "typing", "numpy", "torch"}, (path, names)
    code = ("import torch; from benchmark.reference import musica_plain as m; "
            "import json; f = json.load(open('benchmark/configs/cli-default.json'))['fields']; "
            "f['image_size'] = 64; "
            "x = (torch.arange(64 * 64).reshape(64, 64) * 7 % 60000).to(torch.int32); "
            "print(m.forward(x, m.PlainConfig(f))['out_u8'].shape); "
            f"assert not {{n.split('.')[0] for n in sys.modules}} & set({sorted(FORBIDDEN | {PORT})!r})")
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN, ",".join(FORBIDDEN | {PORT}),
                          str(ROOT), code], capture_output=True, text=True, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "torch.Size([44, 44])" in out.stdout


def test_a_run_loads_neither_jax_nor_the_jax_package():
    """A whole run on the CPU with JAX and the JAX package blocked; the
    run's own check finds none of them loaded."""
    code = ("import time, torch; from benchmark.harness import cell; "
            "r = cell.run('clahe-linear.resident', 7, 0.2, False, time.perf_counter(), "
            "devices=[torch.device('cpu')], size=96, log=lambda m: None); "
            "assert r['correct'], r; assert cell.forbidden_modules() == [], cell.forbidden_modules()")
    out = subprocess.run([sys.executable, "-c", BLOCKED_RUN, ",".join(FORBIDDEN), str(ROOT), code],
                         capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]


def test_forbidden_modules_compares_whole_top_level_names(monkeypatch):
    assert PORT in sys.modules or __import__(PORT)
    monkeypatch.delitem(sys.modules, JAX_PACKAGE, raising=False)
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    assert JAX_PACKAGE not in cell.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert cell.forbidden_modules() == ["jax"]


def test_run_py_exits_without_a_result_where_no_card_is():
    """On a machine without the cell's cards: exit 2, nothing on stdout."""
    out = subprocess.run([sys.executable, str(BENCH_DIR / "run.py"), "--workload",
                          "cli-default.resident", "--seed", str(2**31 + 3), "--seconds", "1",
                          "--trace", "0"], capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
                              "HOME": str(ROOT / "build")})
    if out.returncode == 0:  # a machine with a card: the run printed its result
        return
    assert out.returncode == 2 and out.stdout == "", out.stderr[-2000:]


def test_run_py_fails_without_the_program(tmp_path):
    """In a directory that holds only BENCHMARK.json and benchmark/, a run
    ends with an error and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "cli-default.resident",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], capture_output=True,
                         text=True, cwd=tmp_path, timeout=300)
    assert out.returncode != 0 and out.stdout == ""
