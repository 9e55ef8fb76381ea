"""Nothing the benchmark runs on the card imports JAX or the JAX package:
top-level module names compared whole, so ``repro_torch`` passes and
``repro`` fails."""
import ast
import subprocess
import sys
from pathlib import Path

from servebench import run

HERE = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def imported_tops(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def test_no_source_of_the_benchmark_imports_jax_or_the_jax_package():
    files = [p for p in HERE.rglob("*.py") if "tests" not in p.parts]
    assert len(files) > 10
    bad = {str(p): sorted(set(imported_tops(p)) & FORBIDDEN) for p in files}
    assert not any(bad.values()), bad


def test_names_are_compared_whole():
    assert run.FORBIDDEN == FORBIDDEN
    assert run.forbidden_modules(["repro_torch", "repro_torch.models.api",
                                  "jaxtyping", "flaxen", "reprox"]) == []
    assert run.forbidden_modules(["repro.core.policy", "jax.numpy", "jax",
                                  "flax", "jaxlib.xla_client"]) == [
        "flax", "jax", "jaxlib", "repro"]


def test_a_run_s_modules_load_no_jax():
    code = ("import sys; sys.path[:0] = ['src', '.'];"
            "import servebench.harness, servebench.control, "
            "servebench.knee, servebench.run;"
            "from servebench.catalog import load_metric, load_reference;"
            "[load_metric(p.stem) for p in "
            "__import__('pathlib').Path('servebench/metrics').glob('*.py')];"
            "[load_reference(n) for n in ('dense', 'mamba2')];"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            f"set({sorted(FORBIDDEN)!r})))")
    res = subprocess.run([sys.executable, "-c", code], cwd=HERE.parent,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == "[]"
