"""Nothing under perfbench/ imports JAX or the JAX package, and nothing under
perfbench/reference/ imports the program; names are compared whole, by the
part before the first dot (fvta_memexqa_torch begins with fvta_memexqa_t...)."""

import ast
import sys
import types

from perfbench import harness

JAX = {"jax", "jaxlib", "flax", "optax", "fvta_memexqa_tpu"}


def _imports(path) -> set[str]:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_jax_anywhere():
    files = sorted(harness.BENCH.rglob("*.py"))
    assert len(files) > 20
    for f in files:
        assert not _imports(f) & JAX, f


def test_reference_imports_nothing_of_the_program():
    for f in sorted((harness.BENCH / "reference").rglob("*.py")):
        assert "fvta_memexqa_torch" not in _imports(f), f


def test_banned_by_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "fvta_memexqa_tpu_notes", types.ModuleType("x"))
    monkeypatch.setitem(sys.modules, "jaxtyping", types.ModuleType("x"))
    assert harness.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("jax.numpy"))
    assert harness.banned_modules() == ["jax"]


def test_a_run_that_loaded_jax_prints_nothing(monkeypatch, capsys):
    """The look comes last: a module of JAX loaded after the window, here while
    the reference checks the outputs, still withholds the result."""
    import torch

    from perfbench.tests.conftest import tiny

    sys.path.insert(0, str(harness.BENCH))
    import run

    cell = "memexqa-eval-b256"
    real = harness.run_cell

    def late_flax(name, seed, seconds, trace, device, **kw):
        result = real(name, seed, seconds, trace, "cpu", tiny(cell))
        sys.modules["flax"] = types.ModuleType("flax")
        return result

    monkeypatch.setattr(harness, "run_cell", late_flax)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(sys, "argv", ["run.py", "--workload", cell, "--seed", "1",
                                      "--seconds", "0.05", "--trace", "0"])
    monkeypatch.delitem(sys.modules, "flax", raising=False)
    try:
        code = run.main()
    finally:
        sys.modules.pop("flax", None)
    out = capsys.readouterr()
    assert code != 0 and out.out.strip() == ""
    assert "flax" in out.err
