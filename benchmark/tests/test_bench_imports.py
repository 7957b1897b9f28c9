"""What a run may load: no JAX, no relative of it, not the JAX package the
port came from, each judged by its whole top-level name; and the reference
imports nothing of the program."""

import ast
import subprocess
import sys

import run
from harness.spec import HERE

ROOT = HERE.parent
PROGRAM = "self_attention_tacotron_torch"


def test_forbidden_names_compare_whole_top_level_names():
    loaded = ["jax.numpy", "jaxlib", "flax.linen", "optax", "orbax.checkpoint",
              "self_attention_tacotron_tpu.models",
              PROGRAM, f"{PROGRAM}.models", "jaxtyping", "flaxen", "torch"]
    assert run.forbidden_modules(loaded) == [
        "flax", "jax", "jaxlib", "optax", "orbax",
        "self_attention_tacotron_tpu"]
    assert run.forbidden_modules([PROGRAM, "numpy", "torch"]) == []


def _imports(path):
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (HERE / "reference").glob("*.py"):
        assert _imports(path) <= {"__future__", "typing", "torch"}, path
    code = ("import sys; sys.path.insert(0, %r); "
            "from harness.spec import load_module; from pathlib import Path; "
            "load_module(Path(%r), 'r'); "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "(%r, 'jax', 'flax')))") % (str(HERE), str(
                HERE / "reference" / "tacotron_codes.py"), PROGRAM)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = ("import sys, torch; sys.path[:0] = [%r, %r, %r]; "
            "torch.set_num_threads(1); "
            "from tiny import tiny_cell; import run; "
            "r = run.execute(tiny_cell('codes'), 3, 0.2, False, "
            "torch.device('cpu'), log=lambda *a, **k: None); "
            "assert r['correct'], r; "
            "print(run.forbidden_modules(), %r in sys.modules)") % (
                str(HERE / "tests"), str(HERE), str(ROOT), PROGRAM)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT)
    assert out.stdout.strip().splitlines()[-1] == "[] True"


def test_the_harness_imports_no_jax():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not _imports(path) & {"jax", "jaxlib", "flax", "optax",
                                     "orbax", "self_attention_tacotron_tpu"}
