"""Generate docs/API.md from the package's docstrings.

The reference generates Doxygen API docs from its public headers
(SURVEY.md L5); this is the analog for the Python-first surface: one
markdown page per subpackage listing every public module, class, and
function with its signature and docstring.

Run: python scripts/gen_api_docs.py   (writes docs/API.md)
CI runs it with --check to fail when the page is stale.
"""

import importlib
import inspect
import io
import os
import pkgutil
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

# Walking the package needs no accelerator: use the CPU backend.
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

PKG = "claragenomicsanalysis_tpu"
SKIP_MODULES = {f"{PKG}.io._native"}


def _first_para(doc: str) -> str:
    return inspect.cleandoc(doc).strip()


def _sig(obj) -> str:
    try:
        return str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"


def _public_members(mod):
    names = getattr(mod, "__all__", None)
    if names is None:
        names = [n for n in vars(mod) if not n.startswith("_")]
    out = []
    for n in names:
        obj = vars(mod).get(n)
        if obj is None or inspect.ismodule(obj):
            continue
        # only members defined in (or re-exported by) this package
        owner = getattr(obj, "__module__", "")
        if not (owner or "").startswith(PKG):
            continue
        out.append((n, obj))
    return out


def _emit_member(buf, name, obj, depth):
    h = "#" * depth
    if inspect.isclass(obj):
        buf.write(f"{h} class `{name}{_sig(obj)}`\n\n")
        if obj.__doc__:
            buf.write(_first_para(obj.__doc__) + "\n\n")
        for mn, m in sorted(vars(obj).items()):
            if mn.startswith("_"):
                continue
            # unwrap before the callable filter: classmethod objects are
            # not callable themselves on CPython 3.12
            fn = m.__func__ if isinstance(m, (staticmethod, classmethod)) else m
            if not callable(fn):
                continue
            buf.write(f"- **`{mn}{_sig(fn)}`**")
            if getattr(fn, "__doc__", None):
                first = _first_para(fn.__doc__).split("\n")[0]
                buf.write(f" — {first}")
            buf.write("\n")
        buf.write("\n")
    elif callable(obj):
        buf.write(f"{h} `{name}{_sig(obj)}`\n\n")
        if obj.__doc__:
            buf.write(_first_para(obj.__doc__) + "\n\n")


def generate() -> str:
    pkg = importlib.import_module(PKG)
    buf = io.StringIO()
    buf.write("# API reference\n\n")
    buf.write("> Generated by `scripts/gen_api_docs.py` — do not edit "
              "by hand.\n\n")
    buf.write(_first_para(pkg.__doc__) + "\n\n")

    for sub in sorted(p.name for p in pkgutil.iter_modules(pkg.__path__)):
        subname = f"{PKG}.{sub}"
        if subname in SKIP_MODULES:
            continue
        submod = importlib.import_module(subname)
        buf.write(f"\n---\n\n# `{subname}`\n\n")
        if submod.__doc__:
            buf.write(_first_para(submod.__doc__) + "\n\n")
        if hasattr(submod, "__path__"):          # subpackage: walk modules
            for m in sorted(p.name for p in
                            pkgutil.iter_modules(submod.__path__)):
                mname = f"{subname}.{m}"
                if mname in SKIP_MODULES or m.startswith("_"):
                    continue
                mod = importlib.import_module(mname)
                buf.write(f"## `{mname}`\n\n")
                if mod.__doc__:
                    buf.write(_first_para(mod.__doc__) + "\n\n")
                for n, obj in _public_members(mod):
                    if getattr(obj, "__module__", "") != mname:
                        continue
                    _emit_member(buf, n, obj, 3)
        else:
            for n, obj in _public_members(submod):
                _emit_member(buf, n, obj, 2)
    return buf.getvalue()


def main():
    out = os.path.join(os.path.dirname(__file__), "..", "docs", "API.md")
    text = generate()
    if "--check" in sys.argv:
        with open(out) as f:
            if f.read() != text:
                print("docs/API.md is stale — run scripts/gen_api_docs.py",
                      file=sys.stderr)
                return 1
        print("docs/API.md is current")
        return 0
    with open(out, "w") as f:
        f.write(text)
    print(f"wrote {out} ({len(text.splitlines())} lines)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
