#!/usr/bin/env python
"""Generate the API reference from docstrings (the Sphinx-autodoc
equivalent).

The reference ships a Sphinx autodoc pipeline (docs/conf.py + api.rst)
that renders module/class/function docstrings; Sphinx is not
installable in this image, so this tool walks ``safeopt_tpu`` with
``inspect`` and emits one markdown page per module into
``docs/api_generated/``, plus an index. The suite pins freshness
(tests/test_api_docs.py): editing a public docstring or signature
without regenerating fails CI, exactly like a docs build would.

Usage: ``python tools/gen_api_docs.py [outdir]``
"""

from __future__ import annotations

import importlib
import inspect
import os
import pkgutil
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEFAULT_OUT = os.path.join(REPO, "docs", "api_generated")


def _signature(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _doc(obj) -> str:
    doc = inspect.getdoc(obj)
    return doc if doc else "*(undocumented)*"


def _public_members(mod):
    """Module members to document: __all__ when declared, else public
    names defined in (not imported into) the module."""
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in sorted(vars(mod))
                 if not n.startswith("_")
                 and getattr(getattr(mod, n), "__module__", None)
                 == mod.__name__]
    return [(n, getattr(mod, n)) for n in names if hasattr(mod, n)]


def _document_class(name, cls, lines):
    lines.append(f"### class `{name}{_signature(cls)}`\n")
    lines.append(_doc(cls) + "\n")
    for mname in sorted(vars(cls)):
        if mname.startswith("_"):
            continue
        m = inspect.getattr_static(cls, mname)
        if isinstance(m, property):
            lines.append(f"- **`{mname}`** (property) — "
                         f"{_doc(m).splitlines()[0]}")
        elif isinstance(m, (staticmethod, classmethod)):
            fn = m.__func__
            lines.append(f"- **`{mname}{_signature(fn)}`** — "
                         f"{_doc(fn).splitlines()[0]}")
        elif callable(m):
            lines.append(f"- **`{mname}{_signature(m)}`** — "
                         f"{_doc(m).splitlines()[0]}")
    lines.append("")


def document_module(modname: str) -> str:
    """Render one module's public API as markdown."""
    mod = importlib.import_module(modname)
    lines = [f"# `{modname}`\n"]
    lines.append(_doc(mod) + "\n")
    for name, obj in _public_members(mod):
        if inspect.isclass(obj):
            _document_class(name, obj, lines)
        elif callable(obj):
            lines.append(f"### `{name}{_signature(obj)}`\n")
            lines.append(_doc(obj) + "\n")
        elif not inspect.ismodule(obj):
            lines.append(f"### `{name}`\n")
            lines.append(f"`{name} = {obj!r}`\n")
    return "\n".join(lines) + "\n"


def iter_modules():
    """Every importable module under safeopt_tpu, sorted."""
    import safeopt_tpu

    names = ["safeopt_tpu"]
    for m in pkgutil.walk_packages(safeopt_tpu.__path__,
                                   prefix="safeopt_tpu."):
        names.append(m.name)
    return sorted(names)


def generate(outdir: str) -> list:
    """Write one page per module + the index; return written paths."""
    os.makedirs(outdir, exist_ok=True)
    written = []
    index = ["# API reference (generated)\n",
             "Generated from docstrings by `tools/gen_api_docs.py`; "
             "regenerate after editing any public docstring or "
             "signature (the suite pins freshness).\n"]
    for modname in iter_modules():
        page = modname.replace(".", "_") + ".md"
        path = os.path.join(outdir, page)
        with open(path, "w") as fh:
            fh.write(document_module(modname))
        written.append(path)
        index.append(f"- [`{modname}`]({page})")
    idx_path = os.path.join(outdir, "index.md")
    with open(idx_path, "w") as fh:
        fh.write("\n".join(index) + "\n")
    written.append(idx_path)
    return written


if __name__ == "__main__":
    import jax

    # docs generation is pure introspection: never touch an accelerator
    jax.config.update("jax_platforms", "cpu")
    out = sys.argv[1] if len(sys.argv) > 1 else DEFAULT_OUT
    paths = generate(out)
    print(f"wrote {len(paths)} pages to {out}")
