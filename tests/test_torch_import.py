"""The PyTorch port imports no jax and nothing of the JAX package: every
module imports, the CLI runs the protocol end to end on the CPU, and
chip_smoke imports, in a process where ``jax``, ``jaxlib`` and
``c_lwe_snarks_tpu`` cannot load."""

import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parent.parent

_BLOCK_JAX = ("import sys\nsys.modules['jax'] = None\nsys.modules['jaxlib'] = None\n"
              "sys.modules['c_lwe_snarks_tpu'] = None\n")
_NONE_LOADED = ("assert not [k for k, v in sys.modules.items() if v and "
                "k.split('.')[0] in ('jax', 'jaxlib', 'c_lwe_snarks_tpu')]\n")


def _run(code: str, timeout: int = 300) -> subprocess.CompletedProcess:
    return subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX + code], cwd=ROOT, capture_output=True,
        text=True, timeout=timeout)


def test_every_module_imports_without_jax():
    pkg = ROOT / "c_lwe_snarks_tpu_torch"
    mods = ["c_lwe_snarks_tpu_torch"] + sorted(
        ".".join(("c_lwe_snarks_tpu_torch",) + p.relative_to(pkg).with_suffix("").parts)
        for p in pkg.rglob("*.py"))
    code = "import importlib\n" + "".join(f"importlib.import_module({m!r})\n" for m in mods)
    code += _NONE_LOADED
    res = _run(code)
    assert res.returncode == 0, res.stderr
    assert len(mods) >= 20, mods


def test_cli_runs_without_jax():
    """python -m c_lwe_snarks_tpu_torch --d 16 --m 8 --device cpu."""
    res = _run(
        "import runpy, torch\n"
        "torch.set_num_threads(1)\n"
        "sys.argv = ['c_lwe_snarks_tpu_torch', '--d', '16', '--m', '8', '--device', 'cpu']\n"
        "try:\n"
        "    runpy.run_module('c_lwe_snarks_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert not e.code, e.code\n"
        + _NONE_LOADED)
    assert res.returncode == 0, res.stderr
    assert "verified: True" in res.stdout
    for stage in ("random_ssp", "setup", "prover", "verifier"):
        assert f"[timeit] {stage}:" in res.stderr


def test_chip_smoke_imports_without_jax():
    """Importing chip_smoke needs neither a GPU nor the JAX package, and its
    entry point refuses to run without a CUDA device."""
    res = _run(
        "import torch, chip_smoke\n"
        "assert len(chip_smoke.KERNELS) == 13, chip_smoke.KERNELS\n"
        "assert torch.cuda.is_available() or chip_smoke.main() != 0\n"
        + _NONE_LOADED)
    assert res.returncode == 0, res.stderr
