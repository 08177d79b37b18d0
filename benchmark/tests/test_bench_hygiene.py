"""One run is one process: the end-of-run check catches what a run leaves
alive, nothing under benchmark/ starts a process, and nothing on the
run's path loads JAX or the JAX package."""

import ast
import os
import signal
import sys
import threading
from pathlib import Path

from benchmark import harness, hygiene
from benchmark.tests.conftest import tiny_cell

BENCH = Path(harness.BENCH)
ROOT = Path(harness.ROOT)
RUN_FILES = [p for p in BENCH.rglob("*.py") if "tests" not in p.parts]


def test_a_run_that_leaves_a_thread_is_caught():
    stop = threading.Event()

    def run():
        threading.Thread(target=stop.wait, name="left-behind").start()

    assert hygiene.end_of_run() == []
    run()
    try:
        assert hygiene.end_of_run() == ["thread left-behind"]
    finally:
        stop.set()
    for t in threading.enumerate():
        if t.name == "left-behind":
            t.join(timeout=10)
            assert not t.is_alive()
    assert hygiene.end_of_run() == []


def test_a_run_that_leaves_a_child_is_caught():
    pid = os.posix_spawn("/bin/sleep", ["sleep", "60"], dict(os.environ))
    try:
        left = hygiene.end_of_run()
        assert len(left) == 1 and left[0].startswith(f"child process {pid} ")
    finally:
        os.kill(pid, signal.SIGKILL)
        os.waitpid(pid, 0)
    assert hygiene.end_of_run() == []


def test_forbidden_names_compare_whole():
    mods = ["svt_av1_tpu_torch", "svt_av1_tpu_torch.ops.device", "jaxtyping",
            "jax.numpy", "svt_av1_tpu.ops", "flax", "numpy"]
    assert hygiene.forbidden_modules(mods) == ["flax", "jax.numpy",
                                               "svt_av1_tpu.ops"]


PROCESS_MODULES = {"subprocess", "multiprocessing", "pty"}
PROCESS_CALLS = {"fork", "forkpty", "system", "popen", "posix_spawn",
                 "posix_spawnp", "spawnv", "spawnve", "spawnl", "spawnle",
                 "spawnvp", "spawnlp", "execv", "execve", "execvp", "execl"}


def test_nothing_under_benchmark_starts_a_process():
    for path in RUN_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [
                    f"{node.module}.{a.name}" for a in node.names]
            else:
                names = []
            for n in names:
                assert n.split(".")[0] not in PROCESS_MODULES, (path, n)
                assert "ProcessPool" not in n, (path, n)
            if isinstance(node, ast.Attribute):
                assert node.attr not in PROCESS_CALLS \
                    and node.attr != "ProcessPoolExecutor", (path, node.attr)


def _module_file(name: str):
    base = ROOT.joinpath(*name.split("."))
    for p in (base.with_suffix(".py"), base / "__init__.py"):
        if p.exists():
            return p
    return None


def _closure(starts):
    """Top-level names of every module imported, at any depth, from the
    files ``starts`` through the modules of this repository."""
    seen, todo, tops = set(), list(starts), set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module] + [f"{node.module}.{a.name}"
                                         for a in node.names]
            else:
                continue
            for n in names:
                tops.add(n.split(".")[0])
                f = _module_file(n)
                if f is not None:
                    todo.append(f)
    return tops


def test_run_path_imports_no_jax():
    starts = [p for p in RUN_FILES if p.name != "control.py"]
    tops = _closure(starts)
    assert "svt_av1_tpu_torch" in tops and "torch" in tops
    assert not tops & set(hygiene.FORBIDDEN), tops & set(hygiene.FORBIDDEN)


def test_reference_imports_nothing_of_the_program():
    tops = _closure([BENCH / "reference.py"])
    assert "numpy" in tops and "benchmark" in tops
    assert not tops & {"svt_av1_tpu_torch", "torch", *hygiene.FORBIDDEN}, \
        tops


def test_a_run_loads_no_jax_and_leaves_nothing():
    before = set(hygiene.forbidden_modules())
    config, traffic = tiny_cell("ai480", "intra", 64, 64)
    run, checks, state = harness.run_cell(config, traffic, 5, 0.1,
                                          trace=True, device="cpu")
    assert harness.passes(checks)
    assert set(hygiene.forbidden_modules()) == before
    assert hygiene.survivors() == []
    assert "svt_av1_tpu_torch" in {m.split(".")[0] for m in sys.modules}
