"""The port stands alone: no module of ``repro_torch`` and not
``chip_smoke.py`` imports JAX or anything of the JAX package, and the
entry points refuse to fall back to the CPU when no card is present."""

import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
PORT = SRC / "repro_torch"

_FORBIDDEN = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|repro)(\.|\s|,|$)",
                        re.M)


def _port_files():
    return sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def test_no_source_line_imports_jax_or_the_reference():
    offenders = [(str(p.relative_to(ROOT)), m.group(0).strip())
                 for p in _port_files()
                 for m in _FORBIDDEN.finditer(p.read_text())]
    assert offenders == []


def test_importing_every_module_loads_no_jax_or_reference():
    code = f"""
import importlib, pkgutil, sys
sys.path[:0] = [{str(SRC)!r}, {str(ROOT)!r}]
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                               "repro_torch.")]
for n in names:
    importlib.import_module(n)
import chip_smoke
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names))
print(bad)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    n, bad = res.stdout.strip().splitlines()[-2:]
    assert int(n) >= 20          # every module of the slice was imported
    assert bad == "[]"


def test_engine_without_device_raises_without_a_card(monkeypatch):
    from repro_torch.configs import get_config
    from repro_torch.serving import ServingEngine
    from repro_torch.serving.engine import resolve_device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ServingEngine(get_config("iterpro-100m").smoke())
    assert resolve_device("cpu") == torch.device("cpu")


def test_serve_cli_without_device_raises_without_a_card(monkeypatch):
    from repro_torch.launch import serve
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--smoke", "--requests", "1", "--gen", "1"])


def test_chip_smoke_fails_without_a_card(monkeypatch, capsys):
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert chip_smoke.main() != 0
    assert '"ok"' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, env=env,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


def test_mesh_modules_import_alone_without_jax():
    """The mesh layer (``distributed/*``, ``launch/mesh.py``,
    ``launch/specs.py``) imports neither JAX nor the reference and starts
    no process group at import."""
    code = f"""
import importlib, sys
sys.path[:0] = [{str(SRC)!r}]
names = ["repro_torch.distributed.context", "repro_torch.distributed.sharding",
         "repro_torch.distributed.collectives", "repro_torch.launch.mesh",
         "repro_torch.launch.specs"]
for n in names:
    importlib.import_module(n)
import torch.distributed as dist
print(dist.is_initialized())
print(sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "repro")))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert res.returncode == 0, res.stderr
    initialised, bad = res.stdout.strip().splitlines()[-2:]
    assert initialised == "False"
    assert bad == "[]"


def test_importing_the_dryrun_changes_no_environment():
    """The dry-run tooling sets no environment variable and touches no
    device at import (the reference's sets ``XLA_FLAGS``): each module
    executed anew leaves ``os.environ`` as it was."""
    import importlib
    names = ["repro_torch.launch.op_cost", "repro_torch.launch.accounting",
             "repro_torch.launch.specs", "repro_torch.launch.dryrun",
             "repro_torch.launch.profile_cell"]
    before = dict(os.environ)
    for n in names:
        importlib.reload(importlib.import_module(n))
    assert dict(os.environ) == before
    import torch.distributed as dist
    assert not dist.is_initialized()
