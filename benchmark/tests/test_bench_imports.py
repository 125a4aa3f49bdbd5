"""What a run may load: no module whose top-level name is jax, jaxlib,
flax or the JAX package (madrigal_tpu), compared whole, so the port
(madrigal_tpu_torch) passes; and the reference imports nothing of the
port, the JAX package or JAX."""
import ast
import subprocess
import sys
from pathlib import Path

import harness

BENCH = Path(__file__).resolve().parents[1]


def test_forbidden_by_whole_top_level_name():
    loaded = ["madrigal_tpu_torch", "madrigal_tpu_torch.ops.bilinear",
              "jaxtyping", "flaxen", "torch", "reference.models"]
    assert harness.forbidden_modules(loaded) == []
    for bad in ("jax", "jax.numpy", "jaxlib.xla_client", "flax.linen",
                "madrigal_tpu", "madrigal_tpu.ops.segment"):
        assert harness.forbidden_modules(loaded + [bad]) == [bad]


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_reference_imports_nothing_of_the_port():
    files = sorted((BENCH / "reference").rglob("*.py"))
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("madrigal_tpu_torch", "madrigal_tpu", "jax",
                               "jaxlib", "flax"), (path, name)


def test_benchmark_imports_no_jax():
    for path in sorted(BENCH.rglob("*.py")):
        if "tests" in path.parts:
            continue
        for name in _imports(path):
            assert name.split(".")[0] not in harness.FORBIDDEN_MODULES, (
                path, name)


def test_a_run_loads_no_jax():
    """A tiny CPU run of each cell in a fresh process leaves no JAX,
    flax or JAX-package module in sys.modules."""
    code = (
        "import sys, tempfile\n"
        "from pathlib import Path\n"
        f"sys.path[:0] = [{str(BENCH / 'tests')!r}, {str(BENCH)!r}, "
        f"{str(BENCH.parent)!r}]\n"
        "import torch\n"
        "torch.set_num_threads(1)\n"
        "import tiny, harness\n"
        "root = tiny.write_root(Path(tempfile.mkdtemp()))\n"
        "for w in ('twosides-rank-device', 'twosides-cl-pretrain'):\n"
        "    tiny.run_cell(root, w)\n"
        "print(harness.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
