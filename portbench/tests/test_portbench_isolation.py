"""What a run may load, and that it needs a card."""

import ast
import json
import os
import shutil
import subprocess
import sys

from portbench import registry, run

PORTBENCH = registry.HERE


def test_forbidden_names_are_compared_whole():
    mods = {"jax": 1, "jax.numpy": 1, "jaxlib.xla": 1, "flax.linen": 1,
            "botsort_tpu": 1, "botsort_tpu.ops.nms": 1,
            "botsort_tpu_torch": 1, "botsort_tpu_torch.ops.nms": 1,
            "jaxtyping": 1, "benchmarks": 1, "toolsx": 1, "numpy": 1}
    assert run.forbidden_modules(mods) == [
        "botsort_tpu", "botsort_tpu.ops.nms", "flax.linen", "jax",
        "jax.numpy", "jaxlib.xla"]


def test_the_port_alone_passes():
    assert run.forbidden_modules({"botsort_tpu_torch.pipeline.host": 1,
                                  "portbench.run": 1, "torch": 1}) == []


def imports_of(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_reference_imports_nothing_of_the_program_or_jax():
    ref = os.path.join(PORTBENCH, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            for mod in imports_of(os.path.join(ref, name)):
                top = mod.split(".")[0]
                assert top not in ("botsort_tpu_torch", "botsort_tpu",
                                   "jax", "jaxlib", "flax"), (name, mod)


def test_only_program_py_imports_the_port():
    """And faults.py, which breaks it for the checks of ``correct``."""
    for root, _, files in os.walk(PORTBENCH):
        for name in files:
            if not name.endswith(".py") or \
                    name in ("program.py", "faults.py") or "tests" in root:
                continue
            for mod in imports_of(os.path.join(root, name)):
                assert mod.split(".")[0] not in (
                    "botsort_tpu_torch", "botsort_tpu", "jax", "flax"), (
                    name, mod)


def test_reference_runs_with_the_program_and_jax_blocked():
    code = (
        "import sys\n"
        "for m in ('botsort_tpu_torch', 'botsort_tpu', 'jax', 'flax'):\n"
        "    sys.modules[m] = None\n"
        "from portbench.reference import pipeline, nets, tracker, ops\n"
        "from portbench import judge, counts, gen, trace, registry\n"
        "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def cli(cwd, *extra):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "mot17_256.loaded.1stream", "--seed", "2147483700", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_without_a_card_the_run_fails_and_prints_no_result():
    out = cli(registry.ROOT)
    assert out.returncode == 2, out.stderr
    assert out.stdout == ""
    assert "no CUDA device" in out.stderr


def test_a_checkout_of_the_benchmark_alone_fails(tmp_path):
    """Only BENCHMARK.json and the benchmark's folder: no program."""
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(PORTBENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = cli(tmp_path)
    assert out.returncode != 0
    assert out.stdout == ""


def test_a_module_loaded_after_the_window_is_caught(tmp_path, monkeypatch,
                                                    capsys):
    """A per-layer reader that imports ``jax`` (a stub here) runs after the
    judge; the run still exits with 4 and prints no result."""
    from portbench import trace
    from portbench.tests import minicell

    minicell.make(tmp_path, monkeypatch)
    stubs = tmp_path / "stubs" / "jax"
    stubs.mkdir(parents=True)
    (stubs / "__init__.py").write_text("STUB = True\n")
    monkeypatch.syspath_prepend(str(tmp_path / "stubs"))
    monkeypatch.delitem(sys.modules, "jax", raising=False)
    metrics = tmp_path / "checkout" / "portbench" / "metrics"
    (metrics / "late.jax.py").write_text(
        "def read(records):\n    import jax\n    return 1.0\n")
    bench = json.loads((tmp_path / "checkout" / "BENCHMARK.json").read_text())
    bench["per_layer"].append({
        "name": "late.jax", "unit": "1", "better": "lower",
        "source": "program_counter", "layer": "test", "moves": "setup_s",
        "workloads": ["mini.cell"]})
    (tmp_path / "checkout" / "BENCHMARK.json").write_text(json.dumps(bench))

    def profile(fn, updates):  # the CPU has no device trace
        for _ in range(updates + 1):
            fn()
        return [], (0.0, 1.0)
    monkeypatch.setattr(trace, "profile", profile)
    try:
        code = run.main(["--workload", "mini.cell", "--seed", "2147483900",
                         "--seconds", "1", "--trace", "1"], device_kind="cpu")
        assert "jax" in sys.modules
    finally:
        sys.modules.pop("jax", None)
    out = capsys.readouterr()
    assert code == 4, out.err[-2000:]
    assert out.out == ""
    assert "forbidden modules loaded: ['jax']" in out.err
