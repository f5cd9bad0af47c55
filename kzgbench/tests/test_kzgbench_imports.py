"""Nothing a run loads is JAX or the JAX package, compared by whole
top-level names (the port's name begins with the JAX package's), and the
reference imports nothing of the program, of JAX or of torch."""

import ast
import glob
import json
import os
import subprocess
import sys

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(BENCH)
FORBIDDEN = {"jax", "jaxlib", "flax", "kzg_rust_tpu"}

DRY_RUN = """
import json, sys, time
sys.path.insert(0, {repo!r})
from kzgbench import harness, run
if __name__ == "__main__":
    r = harness.run("min.verify", 3_000_000_004, 0.2, False, time.perf_counter(), device="cpu", root={root!r}, reference_workers=1)
    print(json.dumps({{"correct": r["correct"], "loaded": run.forbidden_modules(), "port": "kzg_rust_tpu_torch" in sys.modules}}))
"""


def test_a_run_loads_no_jax_and_not_the_jax_package(minimal_root, tmp_path):
    script = tmp_path / "dry.py"
    script.write_text(DRY_RUN.format(repo=REPO, root=minimal_root()))
    env = {k: v for k, v in os.environ.items() if not k.startswith(("JAX", "XLA"))}
    out = subprocess.run([sys.executable, str(script)], capture_output=True, text=True, timeout=600, env=env, cwd=str(tmp_path))
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got == {"correct": True, "loaded": [], "port": True}


def test_the_check_compares_whole_top_level_names(monkeypatch):
    from kzgbench import run

    monkeypatch.delitem(sys.modules, "kzg_rust_tpu", raising=False)
    monkeypatch.setitem(sys.modules, "kzg_rust_tpu_torch_probe", sys)
    assert "kzg_rust_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "kzg_rust_tpu.ops", sys)
    assert "kzg_rust_tpu" in run.forbidden_modules()


def imported_tops(path: str) -> set[str]:
    tree = ast.parse(open(path).read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def test_the_reference_imports_nothing_of_the_program():
    files = glob.glob(os.path.join(BENCH, "reference", "*.py"))
    assert len(files) >= 5
    for path in files:
        tops = imported_tops(path)
        assert not tops & (FORBIDDEN | {"kzg_rust_tpu_torch", "torch"}), (path, tops)


def test_no_harness_file_imports_jax_or_the_jax_package():
    for path in glob.glob(os.path.join(BENCH, "**", "*.py"), recursive=True):
        assert not imported_tops(path) & FORBIDDEN, path
