"""Nothing under portbench imports JAX or the JAX package, the reference
imports nothing of the program, the loaded-module check compares whole
top-level names, and a run with no card prints a structured failure and
no result."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import run
from portbench.lib import cells
from portbench.reference.model import param_spec

PORTBENCH = cells.ROOT / "portbench"


def _top_level_imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_no_module_imports_jax_or_the_jax_package():
    for path in PORTBENCH.rglob("*.py"):
        assert not _top_level_imports(path) & run.FORBIDDEN, path


def test_the_reference_imports_nothing_of_the_program():
    for path in (PORTBENCH / "reference").rglob("*.py"):
        assert not {n for n in _top_level_imports(path)
                    if n.startswith("shotvae")}, path


def test_loaded_modules_are_compared_by_whole_name(monkeypatch):
    fake = type(sys)("fake")
    for name in ("shotvae_tpu_tools", "jaxtyping", "jax_shim.x"):
        monkeypatch.setitem(sys.modules, name, fake)
    assert run.loaded_forbidden() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", fake)
    monkeypatch.setitem(sys.modules, "shotvae_tpu.models", fake)
    assert run.loaded_forbidden() == ["jax", "shotvae_tpu"]


@pytest.mark.parametrize("net", ["shot-wrn28-2-c10-4k.train",
                                 "shot-preact18-c100-4k.train"])
def test_reference_names_the_ports_tensors(net):
    from shotvae_torch.models.vae import VariationalAutoEncoder

    m = cells.find(net).config["model"]
    vae = VariationalAutoEncoder(m["net_name"], continuous_latent_dim=m["ldc"],
                                 disc_latent_dim=m["num_classes"],
                                 device="cpu")
    ours = {n: tuple(s) for n, s, _ in param_spec(m)}
    assert ours == {n: tuple(t.shape) for n, t in vae.state_dict().items()}


def test_run_without_a_card_fails_with_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "shot-wrn28-2-c10-4k.train", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cells.ROOT, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and out.stdout == ""
    assert json.loads(out.stderr.strip().splitlines()[-1])["error"] == \
        "no_card"
