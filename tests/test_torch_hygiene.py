"""Package rules of the PyTorch port: it never imports JAX or the `repro`
package, and on CUDA tensors a kernel wrapper launches its kernel or
raises — no fallback to the plain version, no environment switch."""

import ast
import ctypes
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.kernels import build, ops, ref
from repro_torch.quant.quantize import QTensor

ROOT = pathlib.Path(__file__).resolve().parent.parent
PORT = ROOT / "src" / "repro_torch"
# the port, chip_smoke.py and the root timing scripts that import the port
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py", ROOT / "router_host_time.py",
                                      ROOT / "grouped_dequant_time.py",
                                      ROOT / "engine_step_time.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {mod}"


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    __import__(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print('ok', len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    assert res.stdout.startswith("ok")


@pytest.mark.parametrize("module", ["repro_torch.core.cache_guard",
                                    "repro_torch.data.pipeline"])
def test_copied_reference_modules_import_no_jax(module):
    """The port's copies of framework-free reference modules are under the
    import check above and load neither JAX nor the reference package."""
    assert PORT / (module.split(".", 1)[1].replace(".", "/") + ".py") in FILES
    code = (f"import sys, {module}\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]


def test_dispatch_has_no_fallback_or_env_switch():
    for name in ("ops.py", "ref.py"):
        tree = ast.parse((PORT / "kernels" / name).read_text())
        nodes = list(ast.walk(tree))
        assert not any(isinstance(n, ast.Try) for n in nodes), name
        attrs = {n.attr for n in nodes if isinstance(n, ast.Attribute)}
        names = {n.id for n in nodes if isinstance(n, ast.Name)}
        assert not ({"environ", "getenv"} & (attrs | names)), name


def _fail_if_called(*_a, **_k):
    raise AssertionError("the plain version ran on CUDA tensors")


def test_cuda_tensors_without_cuda_raise_instead_of_falling_back(monkeypatch):
    """CUDA tensors (fake ones: this machine has no card) route to the
    kernel; without nvcc/CUDA the wrapper raises and never runs the plain
    version or counts a launch."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; chip_smoke.py runs the kernels")
    for fn in ("gating_topk_ref", "stacked_gating_ref", "grouped_dequant_matmul_ref",
               "grouped_dequant_combine_ref", "paged_flash_decode_ref", "dequant_matmul_ref",
               "flash_decode_ref", "grouped_matmul_ref"):
        monkeypatch.setattr(ref, fn, _fail_if_called)
    ops.reset_dispatch_counts()
    with FakeTensorMode():
        dev = "cuda"
        x = torch.empty(2, 128, device=dev, dtype=torch.bfloat16)
        g = torch.empty(2, 128, 8, device=dev)
        data = torch.empty(3, 64, 32, device=dev, dtype=torch.int8)
        scale = torch.empty(3, 2, 32, device=dev)
        slot = torch.empty(2, device=dev, dtype=torch.int32)
        w = torch.empty(2, device=dev)
        calls = [
            lambda: ops.gating_topk(x, g[:1], top_k=2),
            lambda: ops.stacked_gating(x, g),
            lambda: ops.grouped_dequant_matmul(x, data, scale, slot, bits=4,
                                               group_size=64),
            lambda: ops.grouped_dequant_combine(x, data, scale, slot, slot, w, bits=4,
                                                group_size=64, num_rows=2),
            lambda: ops.paged_flash_decode(
                torch.empty(2, 8, 128, device=dev, dtype=torch.bfloat16),
                torch.empty(3, 64, 2, 128, device=dev, dtype=torch.bfloat16),
                torch.empty(3, 64, 2, 128, device=dev, dtype=torch.bfloat16),
                torch.empty(2, 2, device=dev, dtype=torch.int32), slot),
            lambda: ops.dequant_matmul(x, QTensor(data[0], scale[0], 4, 64, 128)),
            lambda: ops.flash_decode(
                torch.empty(2, 8, 128, device=dev, dtype=torch.bfloat16),
                torch.empty(2, 64, 2, 128, device=dev, dtype=torch.bfloat16),
                torch.empty(2, 64, 2, 128, device=dev, dtype=torch.bfloat16), slot),
            lambda: ops.grouped_matmul(x, torch.empty(3, 128, 64, device=dev,
                                                      dtype=torch.bfloat16), slot),
        ]
        for call in calls:
            with pytest.raises(RuntimeError):
                call()
    assert ops.dispatch_counts() == {}


def test_chip_smoke_fails_without_a_card_or_outside_the_repo(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    res = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(ROOT / "chip_smoke.py", alone)
    res = subprocess.run([sys.executable, str(alone)], capture_output=True, text=True,
                         timeout=300, cwd=tmp_path,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout


def _c_type(param: str):
    """The ctypes type an argument of a C entry point is bound as."""
    if re.match(r"(const\s+)?int\s*\*", param):
        return ctypes.POINTER(ctypes.c_int)
    if "*" in param:
        return ctypes.c_void_p
    return ctypes.c_float if param.startswith("float") else ctypes.c_int


@pytest.mark.parametrize("source", build.SOURCES)
def test_signatures_match_the_c_entry_points(source):
    """build.SIGNATURES binds every `extern "C"` entry of a kernel source,
    with its arguments' number and kinds (pointer, int, float, int*) as the
    source declares them: a stale binding would pass the wrong arguments
    on the card, where nothing checks them."""
    text = (build.CSRC / f"{source}.cu").read_text()
    declared = {}
    for m in re.finditer(r'extern "C" \w+ (\w+)\(([^)]*)\)', text):
        params = [p.strip() for p in m.group(2).split(",") if p.strip()]
        declared[m.group(1)] = [_c_type(p) for p in params]
    bound = build.SIGNATURES[source]
    assert sorted(declared) == sorted(bound)
    for fn, argtypes in bound.items():
        assert list(argtypes) == declared[fn], fn
