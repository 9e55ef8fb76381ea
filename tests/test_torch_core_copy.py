"""The port's copies of the framework-free modules are the reference: each
equals the JAX package's source with the import prefix ``repro.`` turned
into ``repro_torch.``. ``core/kernel_id.py`` may differ only in
``_aval_fp``, which also names torch dtypes."""
import ast
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parent.parent / "src"

VERBATIM = [
    "core/task.py", "core/interference.py", "core/profiler.py",
    "core/queues.py", "core/fikit.py", "core/policy.py",
    "core/placement.py", "core/online.py", "core/executor.py",
    "core/client.py", "config.py", "configs/qwen3_4b.py",
    "configs/stablelm_1_6b.py", "configs/recurrentgemma_9b.py",
    "configs/mamba2_2_7b.py", "configs/granite_20b.py",
]


def _sources(rel):
    ref = (SRC / "repro" / rel).read_text()
    port = (SRC / "repro_torch" / rel).read_text()
    return ref.replace("repro.", "repro_torch."), port


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_is_verbatim(rel):
    want, port = _sources(rel)
    assert port == want


def _without(source, fn_name):
    """Module source with the top-level function ``fn_name`` cut out."""
    tree = ast.parse(source)
    lines = source.splitlines(keepends=True)
    (node,) = [n for n in tree.body
               if isinstance(n, ast.FunctionDef) and n.name == fn_name]
    return "".join(lines[:node.lineno - 1] + lines[node.end_lineno:])


def test_kernel_id_differs_only_in_aval_fp():
    want, port = _sources("core/kernel_id.py")
    assert port != want
    assert _without(port, "_aval_fp") == _without(want, "_aval_fp")


def test_aval_fp_names_torch_dtypes_as_numpy_does():
    torch = pytest.importorskip("torch")
    from repro_torch.core.kernel_id import _aval_fp, kernel_id_for
    for td, nd in ((torch.float32, np.float32), (torch.int32, np.int32),
                   (torch.bfloat16, None)):
        t = torch.zeros((2, 3), dtype=td)
        name = str(td).split(".")[1]
        assert _aval_fp(t) == (2, 3, name)
        if nd is not None:
            assert _aval_fp(np.zeros((2, 3), nd)) == (2, 3, name)
    kid = kernel_id_for("svc/layer", inputs=[torch.zeros(1, 4,
                                                         dtype=torch.int32)])
    assert kid.encode() == "svc/layer|()|(1, 4, 'int32')"
