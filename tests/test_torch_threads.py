"""The port's tests keep one rule for torch's CPU threads, in one place:
every ``tests/test_torch_*.py`` but ``test_torch_cuda.py`` takes the
fixture of ``tests/_torch_threads.py``, and no other file under ``tests/``
sets the thread count. ``test_torch_cuda.py`` runs on the card under
``--noconftest``, without JAX, and skips on the CPU."""

import ast
from pathlib import Path

from _torch_threads import worker_threads  # noqa: F401

TESTS = Path(__file__).resolve().parent
IMPORT = "from _torch_threads import worker_threads  # noqa: F401"
# ``set_num_threads`` is the rule's own call; ``one_torch_thread`` was its
# per-block copy, deleted.
NAMES = {"set_num_threads", "one_torch_thread"}


def _names(tree):
    """Every name the module defines, reads, imports or reaches by attribute
    (an import under another name still holds the original)."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Name):
            yield node.id
        elif isinstance(node, ast.Attribute):
            yield node.attr
        elif isinstance(node, ast.alias):
            yield node.name.rsplit(".", 1)[-1]
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield node.name


def test_the_thread_rule_lives_in_one_module():
    missing = [
        path.name for path in sorted(TESTS.glob("test_torch_*.py"))
        if path.name != "test_torch_cuda.py" and IMPORT not in path.read_text().splitlines()
    ]
    assert missing == []
    found = {
        path.relative_to(TESTS).as_posix(): sorted(NAMES & set(_names(ast.parse(path.read_text()))))
        for path in sorted(TESTS.rglob("*.py")) if path.name != "_torch_threads.py"
    }
    assert {name: hits for name, hits in found.items() if hits} == {}
