"""Nothing of the benchmark imports JAX or the JAX package, and nothing
of the reference imports the port: by the top-level module name, the
part before the first dot, compared whole (``genpc_tpu_torch`` begins
with ``genpc_tpu``)."""

import ast
import subprocess
import sys

import pytest

from portbench_tiny import ROOT

BANNED = {"jax", "jaxlib", "flax", "genpc_tpu"}
SOURCES = sorted((ROOT / "portbench").rglob("*.py"))
REFERENCE = ROOT / "portbench" / "reference"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES,
                         ids=lambda p: p.relative_to(ROOT).as_posix())
def test_source_imports(path):
    found = _top_level_imports(path)
    assert not found & BANNED
    if REFERENCE in path.parents:
        assert "genpc_tpu_torch" not in found


def test_loaded_modules():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.harness, portbench.roofline\n"
            "import portbench.reference.judge\n"
            "import portbench.reference.plain.parallel.batched_runner\n"
            "import portbench.traffic.objects\n"
            "from portbench import harness\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout
    loaded = set(eval(out.strip().splitlines()[-1]))
    assert not loaded & (BANNED | {"genpc_tpu_torch"})


def test_harness_names_what_is_loaded(monkeypatch):
    from portbench import harness
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    assert harness.banned_modules() == ["jax"]
    monkeypatch.delitem(sys.modules, "jax.numpy")
    monkeypatch.setitem(sys.modules, "genpc_tpu_torch_extra", object())
    assert "genpc_tpu" not in harness.banned_modules()
