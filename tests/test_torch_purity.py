"""The port imports neither ``jax`` nor any ``zoo_tpu`` module (its own
name, ``zoo_tpu_torch``, shares the prefix and is allowed), and its
entry points refuse to run quietly on the CPU."""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "zoo_tpu_torch")


def _modules():
    out = []
    for dirpath, dirnames, filenames in os.walk(PKG):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fn in sorted(filenames):
            if fn.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, fn), ROOT)
                mod = rel[:-3].replace(os.sep, ".")
                out.append(mod[:-len(".__init__")]
                           if mod.endswith(".__init__") else mod)
    return sorted(out)


def _forbidden(name: str) -> bool:
    return name == "jax" or name.startswith("jax.") or \
        name == "zoo_tpu" or name.startswith("zoo_tpu.")


def test_importing_every_module_pulls_in_no_jax():
    mods = _modules()
    assert "zoo_tpu_torch.serving.llm.engine" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith('jax.') or m == 'zoo_tpu' or "
        "m.startswith('zoo_tpu.'))\n"
        "print(bad)\n"
        "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr


@pytest.mark.parametrize("path", [
    os.path.join(dp, f) for dp, _, fs in os.walk(PKG) for f in fs
    if f.endswith(".py")] + [os.path.join(ROOT, "chip_smoke.py")],
    ids=lambda p: os.path.relpath(p, ROOT))
def test_no_import_of_jax_or_zoo_tpu_in_source(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), path)
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
        elif isinstance(node, ast.Call) and getattr(
                node.func, "id", getattr(node.func, "attr", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            names.append(str(node.args[0].value))
    bad = [n for n in names if _forbidden(n)]
    assert not bad, f"{path} imports {bad}"


def test_entry_points_without_device_raise_without_a_card(monkeypatch):
    """No GPU and no ``device=``: every entry point raises instead of
    carrying on on the CPU."""
    from zoo_tpu_torch.common.device import resolve_device
    from zoo_tpu_torch.convert import params_from_jax
    from zoo_tpu_torch.models.llm.llama import Llama, tiny_llama_config
    from zoo_tpu_torch.serving.llm import PagedLlamaModel, build_llm_engine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tiny_llama_config()
    tree = {"embed": np.zeros((4, 2), np.float32)}
    for call in (lambda: resolve_device(),
                 lambda: resolve_device("cuda"),
                 lambda: Llama.build(cfg),
                 lambda: PagedLlamaModel(cfg),
                 lambda: build_llm_engine("llama:tiny"),
                 lambda: params_from_jax(tree)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert resolve_device("cpu") == torch.device("cpu")


def test_flash_paths_refuse_cpu_tensors():
    from zoo_tpu_torch.models.llm.llama import tiny_llama_config
    from zoo_tpu_torch.serving.llm import PagedLlamaModel
    for kw in ({"decode_impl": "flash"}, {"prefill_impl": "flash"},
               {"attention_impl": "flash"}):
        with pytest.raises(ValueError, match="CUDA"):
            PagedLlamaModel(tiny_llama_config(), device="cpu",
                            num_blocks=8, max_blocks_per_seq=4,
                            block_size=4, prefill_buckets=(8,), **kw)
