"""The layers under ``redux_tpu_torch.api`` import one way.

``api`` (the entry points and the call plan) builds on ``_pipeline`` (the
host's copies to and from a device) and ``_record`` (the record of a
call); neither of those names ``api`` or the kernels (``ops``), and the
pipeline takes its recorder as an object instead of importing
``_record``.  Importing either module would import the package, and so
``api``: the test reads their import statements instead.
"""

import ast
from pathlib import Path

import pytest

PACKAGE = Path(__file__).resolve().parent.parent / "redux_tpu_torch"


def _named(path: Path) -> set[str]:
    """The package's modules that the import statements of ``path`` (a
    module at the package's top) name, by their first component."""
    named = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            named |= {a.name.split(".")[1] for a in node.names
                      if a.name.startswith("redux_tpu_torch.")}
        elif isinstance(node, ast.ImportFrom):
            module = node.module or ""
            if node.level == 0 and module.split(".")[0] != "redux_tpu_torch":
                continue
            if node.level == 0:
                module = module.partition(".")[2]
            named |= {module.split(".")[0]} if module else {a.name for a in node.names}
    return named


@pytest.mark.parametrize("module, barred", [("_pipeline", {"api", "ops", "_record"}),
                                            ("_record", {"api", "ops"})])
def test_the_layers_import_one_way(module, barred):
    named = _named(PACKAGE / f"{module}.py")
    assert "_build" in named  # the reading sees the package's own imports
    assert not named & barred, named & barred
    assert {"_pipeline", "_record"} <= _named(PACKAGE / "api.py")
