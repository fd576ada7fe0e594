"""Nothing the benchmark runs loads JAX or the JAX package, and the
reference loads nothing of the port.  Module names are compared by their
whole top-level name: the port's own name begins with the JAX package's."""

import ast
import subprocess
import sys

from portbench.tests.conftest import BENCH, REPO

JAX = {"jax", "jaxlib", "flax", "msgwam_tpu"}
PORT = "msgwam_tpu_torch"


def imported(path) -> set:
    """Top-level names of the modules a source file imports."""
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            tops.add(node.module.split(".")[0])
    return tops


def loaded_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\n"
         "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True)
    return set(out.stdout.split())


def test_no_source_of_the_benchmark_imports_jax():
    for path in BENCH.rglob("*.py"):
        if "tests" in path.relative_to(BENCH).parts:
            continue
        assert not imported(path) & JAX, path


def test_the_reference_imports_nothing_of_the_port():
    for path in (BENCH / "reference").rglob("*.py"):
        assert PORT not in imported(path), path
    tops = loaded_after("import portbench.reference.model")
    assert PORT not in tops and not tops & JAX


def test_a_run_loads_no_jax():
    """Every module the harness and the metric readers import, with the
    port, as a run on the card does; the names compared whole."""
    code = ("import portbench.run, portbench.calibrate\n"
            "from portbench import manifest\n"
            "import json\n"
            "m = json.load(open('BENCHMARK.json'))\n"
            "[manifest.reader(x['name']) for x in m['end_to_end'] + m['per_layer']]\n"
            "import msgwam_tpu_torch\n"
            "from portbench.run import forbidden_modules\n"
            "assert forbidden_modules() == [], forbidden_modules()\n")
    tops = loaded_after(code)
    assert PORT in tops
    assert not tops & JAX


def test_the_guard_names_what_it_finds(monkeypatch):
    from portbench import run

    monkeypatch.setitem(sys.modules, "msgwam_tpu", object())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert run.forbidden_modules() == ["jax", "msgwam_tpu"]
    monkeypatch.delitem(sys.modules, "msgwam_tpu")
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "msgwam_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
