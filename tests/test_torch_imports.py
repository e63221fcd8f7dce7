"""The port stands alone: nothing in ``src/repro_torch``, ``chip_smoke.py`` or
``tools/`` imports ``jax`` or the reference package ``repro`` (not even its numpy-only
modules: ``repro.core`` pulls in JAX on import)."""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"] + sorted((ROOT / "tools").glob("*.py"))


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and not node.level:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_port_imports_no_jax_or_reference(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_port_import_leaves_jax_unloaded():
    import subprocess
    import sys
    code = ("import sys, repro_torch.serve, repro_torch.launch.serve, "
            "repro_torch.convert, repro_torch.kernels.build, "
            "repro_torch.launch.train, repro_torch.launch.compile, "
            "repro_torch.train.checkpoint, repro_torch.train.fault, "
            "repro_torch.models.cnn, repro_torch.optim, repro_torch.data, "
            "repro_torch.parallel, repro_torch.parallel.policy, "
            "repro_torch.parallel.compress, "
            "repro_torch.launch.mesh; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'repro')]; print(bad); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"),
                               "PATH": "/usr/bin:/bin"})
    assert proc.returncode == 0, proc.stdout + proc.stderr
