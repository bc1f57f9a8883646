"""The port stands alone: no JAX, no ``ml_dtypes``, nothing of ``repro``.

Every module of ``repro_torch`` is imported in a fresh interpreter, which
must then hold none of those in ``sys.modules``; a scan of the sources finds
no such import anywhere, lazy ones included, in the package or in
``chip_smoke.py``.  Entry points default to ``cuda`` and raise without a
card unless ``device="cpu"`` is passed.
"""

import ast
import json
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"
FORBIDDEN = ("jax", "jaxlib", "ml_dtypes", "repro")


def _modules():
    for f in sorted(PKG.rglob("*.py")):
        rel = f.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def _run(code: str) -> subprocess.CompletedProcess:
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
           "JAX_PLATFORMS": "cpu"}
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=ROOT)


def test_importing_every_module_loads_no_jax_or_repro():
    mods = list(_modules())
    assert "repro_torch.kernels.int8_conv.kernel" in mods
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", sorted(str(p.relative_to(ROOT)) for p in
                                        [*PKG.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_sources_import_nothing_forbidden(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        for n in names:
            assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_cuda_is_the_default_and_raises_without_a_card():
    code = (
        "import inspect, torch\n"
        "torch.cuda.is_available = lambda: False\n"
        "from repro_torch.core import graph, pipeline\n"
        "from repro_torch.core.executor import BareMetalExecutor, resolve_device\n"
        "from repro_torch.runtime import Session, create_executor\n"
        "for f in (Session, Session.from_bundle, BareMetalExecutor.__init__,\n"
        "          resolve_device):\n"
        "    assert inspect.signature(f).parameters['device'].default == 'cuda', f\n"
        "art = pipeline.CompilerPipeline(graph.lenet5()).run()\n"
        "for call in (lambda: Session(art), lambda: Session(art, device='cuda:0'),\n"
        "             lambda: create_executor('baremetal', art)):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'no CUDA device' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('ran without a card')\n"
        "ses = Session(art, device='cpu')\n"
        "print(ses.run(torch.zeros(784).numpy()).output_int8.shape)\n")
    r = _run(code)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == "(10,)"


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    """Here there is no card; and a directory holding only the script has no
    port to import.  Either way: non-zero exit and no result line."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    for cwd in (ROOT, tmp_path):
        r = subprocess.run([sys.executable, str(cwd / "chip_smoke.py")],
                           capture_output=True, text=True, timeout=300, cwd=cwd,
                           env={"PATH": "/usr/bin:/bin"})
        assert r.returncode != 0
        assert '"ok": true' not in r.stdout
