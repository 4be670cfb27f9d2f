"""Nothing under portbench/ imports JAX, flax, the JAX package or the
JAX benchmarks, compared by whole top-level module name (the port's name
begins with the JAX package's); the reference imports nothing of the
port."""

import ast
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "multimodal_idbn_tpu", "benchmarks"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


SOURCES = sorted(HERE.rglob("*.py"))


@pytest.mark.parametrize("path", SOURCES,
                         ids=[str(p.relative_to(HERE)) for p in SOURCES])
def test_no_jax_by_whole_name(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    assert "multimodal_idbn_tpu_torch" not in top_level_imports(path)


def test_whole_name_check_tells_the_port_from_the_jax_package(tmp_path):
    f = tmp_path / "m.py"
    f.write_text("import multimodal_idbn_tpu_torch.ops\n"
                 "from multimodal_idbn_tpu_torch import models\n")
    assert not top_level_imports(f) & FORBIDDEN
    f.write_text("from multimodal_idbn_tpu import models\n")
    assert top_level_imports(f) & FORBIDDEN
