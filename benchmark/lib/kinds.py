"""Find a step kind by the ``entry`` that a traffic mix names.

A kind is one of ``steps.KINDS``, or a file ``entries/<entry>.py`` under
the benchmark whose class ``Step`` has ``entry`` equal to the name: that
is how a cell brings a kind of its own, and with it its control
(``CONTROL``), without an edit to any file that is there.
"""

from __future__ import annotations

from pathlib import Path
from types import ModuleType

from benchmark.lib import cells, steps


def module(bench_dir: Path, entry: str) -> ModuleType:
    """The module ``<bench_dir>/entries/<entry>.py``; LookupError where
    there is no such file."""
    path = bench_dir / "entries" / f"{entry}.py"
    if not path.is_file():
        raise LookupError(f"no step kind {entry!r}: neither in steps.KINDS nor {path}")
    return cells.load_module(path, f"bench_entry_{entry}")


def step_class(bench_dir: Path, entry: str) -> type:
    """The class that stages ``entry``'s steps; LookupError where it names
    no kind, or a file whose ``Step`` is another kind's."""
    kind = steps.KINDS[entry] if entry in steps.KINDS else module(bench_dir, entry).Step
    if kind.entry != entry:
        raise LookupError(f"the step kind named {entry!r} is {kind.entry!r}")
    return kind
