"""The import rule, by the syntax tree of every file of the benchmark: no
module imports JAX or the JAX package (top-level names compared whole: the
port's ``c_lwe_snarks_tpu_torch`` begins with the JAX package's name), and
the reference imports nothing of the port and nothing of the benchmark
outside ``reference/``."""

import ast

import pytest

from conftest import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "c_lwe_snarks_tpu"}
FILES = sorted((ROOT / "portbench").rglob("*.py"))


def imported(path) -> set:
    """Top-level names of the absolute imports of a file; relative ones as ".x"."""
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            out.add("." if node.level else node.module.split(".")[0])
            if not node.level and node.module.split(".")[0] == "portbench":
                out.add(node.module)
    return out


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_anywhere(path):
    assert not imported(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((ROOT / "portbench" / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_port(path):
    names = imported(path)
    assert "c_lwe_snarks_tpu_torch" not in names
    assert not {n for n in names if n.startswith("portbench") and n != "portbench.reference"
                and not n.startswith("portbench.reference.")}


def test_the_rule_compares_whole_names(tmp_path):
    f = tmp_path / "x.py"
    f.write_text("import c_lwe_snarks_tpu_torch.ops\nfrom c_lwe_snarks_tpu.models import snark\n")
    names = imported(f)
    assert "c_lwe_snarks_tpu_torch" in names and names & FORBIDDEN == {"c_lwe_snarks_tpu"}
