"""The lint gate over the port: ``tools/minilint.py``'s own checks, run
on every file of ``glomargridding_tpu_torch/``, on ``chip_smoke.py`` and
on the examples' twins (``examples/torch_*.py``), which the gate's
``ROOTS`` leave out, with no finding allowed; and the gate itself, as CI
runs it (``python tools/minilint.py``), exiting 0.
"""

import ast
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO / "tools"))

import minilint  # noqa: E402

PORT_FILES = sorted(
    [*(REPO / "glomargridding_tpu_torch").rglob("*.py"),
     REPO / "chip_smoke.py", *(REPO / "examples").glob("torch_*.py")])


def findings(path):
    """minilint's findings for one file, as its ``main`` collects them."""
    text = path.read_text()
    found = []
    minilint.check_lines(path, text, found)
    try:
        tree = ast.parse(text, filename=str(path))
    except SyntaxError as e:
        found.append((path, e.lineno or 0, f"E999 {e.msg}"))
    else:
        minilint.check_ast(path, tree, found)
        minilint.check_spelling(path, text, found)
    return minilint._drop_noqa(path, text, found)


@pytest.mark.parametrize(
    "path", PORT_FILES, ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_port_file_is_lint_clean(path):
    assert findings(path) == []


def test_the_port_is_covered():
    names = {str(p.relative_to(REPO)) for p in PORT_FILES}
    assert "chip_smoke.py" in names
    assert "glomargridding_tpu_torch/ops/eigsh.py" in names
    assert "examples/torch_nonstationary_tenth_degree.py" in names


def test_minilint_gate_exits_zero():
    run = subprocess.run([sys.executable, "tools/minilint.py"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stdout + run.stderr
