"""The port stands alone: no JAX and nothing of the reference package, and
no silent fall back to the CPU when the card is missing."""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py", ROOT / "ghost_ab.py", ROOT / "tree_ab.py",
    ROOT / "l2_ablate.py", ROOT / "examples" / "quickstart_torch.py"]


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_reference(path):
    for mod in imported_modules(path):
        top = mod.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro"), f"{path}: imports {mod}"


def test_port_runs_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "import numpy as np\n"
        "from repro_torch.nng import build_nng\n"
        "from repro_torch.core.brute import brute_force_graph\n"
        "from repro_torch.data import synthetic_pointset\n"
        "pts = synthetic_pointset(40, 3, seed=1)\n"
        "g = build_nng(pts, 1.5, device='cpu')\n"
        "assert g == brute_force_graph(pts, 1.5), g\n"
        "print('ok', g.num_edges)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.startswith("ok")


def test_analyzer_cli_runs_with_jax_blocked(tmp_path):
    """``python -m repro_torch.analysis --check --device cpu`` (without the
    audit, which ``tests/test_torch_analysis.py`` runs) with ``jax`` and
    ``repro`` unimportable: the analyzer is the port's own."""
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        "sys.argv = ['repro_torch.analysis', '--check', '--device', 'cpu',\n"
        f"            '--no-traffic', '--out', {str(tmp_path / 'r.json')!r}]\n"
        "runpy.run_module('repro_torch.analysis', run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "0 fresh" in r.stderr


def test_dryrun_cli_runs_with_jax_blocked(tmp_path):
    """``python -m repro_torch.launch.dryrun`` and the report with ``jax``
    and ``repro`` unimportable: six cells written, each OK with both
    engines, and the table's twelve rows; no tensor reaches a device."""
    out = tmp_path / "dryrun"
    code = (
        "import sys, runpy\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"sys.argv = ['dryrun', '--out', {str(out)!r}]\n"
        "try:\n"
        "    runpy.run_module('repro_torch.launch.dryrun', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        "import torch\n"
        "assert not torch.cuda.is_initialized()\n"
        f"sys.argv = ['report', '--out-dir', {str(out)!r}]\n"
        "runpy.run_module('repro_torch.roofline.report', "
        "run_name='__main__')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    cells = [json.loads(p.read_text()) for p in sorted(out.glob("*.json"))]
    assert len(cells) == 6
    assert all(c["status"] == "OK" and "systolic" in c and "landmark" in c
               for c in cells)
    table = r.stdout.split("## NNG workloads")[-1]
    assert table.count("| nng-") == 12, r.stdout


def test_default_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default runs on it")
    from repro_torch.core.distributed import make_nng_mesh
    from repro_torch.nng import build_nng
    pts = torch.randn(8, 3).numpy()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_nng(pts, 1.0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_nng_mesh(4)


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "alone"])
def test_chip_smoke_fails_without_the_card_or_the_repo(tmp_path, alone):
    """Without a CUDA device, or in a directory holding nothing of the repo
    but the script, chip_smoke.py exits non-zero and prints no result."""
    script = ROOT / "chip_smoke.py"
    if alone:
        script = Path(shutil.copy(script, tmp_path / "chip_smoke.py"))
    elif torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, str(script)], cwd=script.parent,
                       env=env, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout


def test_ghost_ab_fails_without_the_card(tmp_path):
    """Without a CUDA device the kernel A/B script exits non-zero before it
    builds or times anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    r = subprocess.run([sys.executable, str(ROOT / "ghost_ab.py"),
                        str(tmp_path)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_tree_ab_fails_without_the_card(tmp_path):
    """Without a CUDA device the tree-call A/B script exits non-zero before
    it starts a run."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    r = subprocess.run([sys.executable, str(ROOT / "tree_ab.py"),
                        str(tmp_path)], cwd=ROOT, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_l2_ablate_fails_without_the_card():
    """Without a CUDA device the L2 core's ablation script exits non-zero
    before it builds or times anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the script would run")
    r = subprocess.run([sys.executable, str(ROOT / "l2_ablate.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "no CUDA device" in r.stderr


def test_tree_ab_refuses_unknown_calls(tmp_path):
    """tree_ab.py names its calls; an unknown one is refused before any run
    (with a card or without)."""
    r = subprocess.run([sys.executable, str(ROOT / "tree_ab.py"),
                        str(tmp_path), "--calls", "point tiles,no such call"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 2
    assert "no such call" in r.stderr
