"""The port's investigation tools under ``tools/``, on the CPU: the names
``tools/torch_cupti_windows.py`` takes from ``chip_smoke.py`` still exist
there, its ``--tally`` reads a whole run's log, and one world of
``tools/torch_gloo_exit_stress.py``'s ``mesh`` mode ends cleanly with the
port's teardown."""

import ast
import importlib.util
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tool(name: str):
    spec = importlib.util.spec_from_file_location(
        f"_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_cupti_windows_names_exist_in_chip_smoke():
    with open(os.path.join(REPO, "tools", "torch_cupti_windows.py")) as f:
        tree = ast.parse(f.read())
    used = {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)
            and isinstance(n.value, ast.Name) and n.value.id == "cs"}
    sys.path.insert(0, REPO)
    try:
        import chip_smoke
    finally:
        sys.path.remove(REPO)
    assert {"k1_call", "remeasure", "bench_setup"} <= used
    assert sorted(n for n in used if not hasattr(chip_smoke, n)) == []


def test_cupti_windows_tally_reads_a_whole_run(tmp_path):
    windows = [{"label": "[2] K1 random, n=100000", "launched": 1,
                "recorded": 1, "sleeps_lost": 0},
               {"label": "[15] Path A, 10 steps", "launched": 30,
                "recorded": 26, "sleeps_lost": 64, "remeasured": {}}]
    log = tmp_path / "run.log"
    log.write_text("[0] device\n[9] details " + json.dumps(
        {"profiler_windows": windows}) + '\n{"ok": true}\n')
    bare = tmp_path / "cut.log"
    bare.write_text("[0] device\n")
    got = _tool("torch_cupti_windows").tally([str(log), str(bare)])
    assert got[str(log)] == {"ok": True, "windows": [
        ["[2] K1 random, n=100000", 1, 1, 0, False],
        ["[15] Path A, 10 steps", 26, 30, 64, True]]}
    assert got[str(bare)] == {"details": None, "ok": False}


def test_gloo_exit_stress_one_mesh_world(capsys):
    assert _tool("torch_gloo_exit_stress").main(
        ["mesh", "--worlds", "1", "--load", "0"]) == 0
    assert "0 of 1 worlds failed" in capsys.readouterr().out
