"""No module of the benchmark imports JAX or the JAX package, by the whole
top-level name, and the reference imports nothing of the port."""

import ast
import subprocess
import sys

import pytest

from benchmark.lib import cells, harness

FORBIDDEN = {"jax", "jaxlib", "flax", "snappy_tpu"}
SOURCES = sorted(p for p in cells.HERE.rglob("*.py") if "__pycache__" not in p.parts)


def top_level_imports(path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(cells.HERE)))
def test_no_jax_by_whole_top_level_name(path):
    assert not set(top_level_imports(path)) & FORBIDDEN


def test_the_names_are_compared_whole():
    assert harness.FORBIDDEN == ("jax", "jaxlib", "flax", "snappy_tpu")
    assert "snappy_tpu_torch".split(".")[0] not in FORBIDDEN


@pytest.mark.parametrize("path", sorted((cells.HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert not {"snappy_tpu_torch", "snappy_tpu"} & set(top_level_imports(path))


def test_a_run_loads_no_jax():
    """The harness with the port and the reference, as a run imports them."""
    code = ("import sys; sys.path.insert(0, '.');"
            "from benchmark.lib import harness, steps; import snappy_tpu_torch.entry;"
            "import snappy_tpu_torch.ops.host_codec; print(','.join(harness.forbidden_modules()))")
    out = subprocess.run([sys.executable, "-c", code], cwd=cells.ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == ""
