"""List the port's ``pf`` module API, in ``tools/dump_api.py``'s format.

Port of ``tools/dump_api.py`` (the reference's doc-drift check, ref:
scripts/dump_api.py, docs/python_api.txt): every public function with its
signature and first doc line, every class with its methods and
properties, every constant. It writes to the path the caller names, which
may not be the JAX package's listing, ``docs/python_api.txt``.

Run: ``python -m permafrost_engine_tpu_torch.tools.dump_api out.txt``
"""

from __future__ import annotations

import argparse
import inspect
import os

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
JAX_LISTING = os.path.join(ROOT, "docs", "python_api.txt")


def listing() -> tuple[list[str], list[str], list[str]]:
    """(functions, classes, constants) entries of the port's ``pf``."""
    from permafrost_engine_tpu_torch.script import pf

    funcs, classes, consts = [], [], []
    for name in sorted(dir(pf)):
        if name.startswith("_"):
            continue
        obj = getattr(pf, name)
        if inspect.isfunction(obj):
            try:
                sig = str(inspect.signature(obj))
            except (TypeError, ValueError):
                sig = "(...)"
            doc = (inspect.getdoc(obj) or "").split("\n")[0]
            funcs.append(f"pf.{name}{sig}\n    {doc}".rstrip())
        elif inspect.isclass(obj):
            doc = (inspect.getdoc(obj) or "").split("\n")[0]
            methods = [
                m for m in sorted(dir(obj))
                if not m.startswith("_")
                and callable(getattr(obj, m, None))
            ]
            props = [m for m in sorted(dir(obj))
                     if isinstance(getattr(type(obj), m, None) or
                                   getattr(obj, m, None), property)]
            classes.append(
                f"pf.{name}: {doc}\n    methods: {', '.join(methods) or '-'}"
                + (f"\n    properties: {', '.join(props)}" if props else ""))
        elif isinstance(obj, (int, float, str)) and name.isupper():
            consts.append(f"pf.{name} = {obj!r}")
    return funcs, classes, consts


def main(argv=None) -> str:
    ap = argparse.ArgumentParser()
    ap.add_argument("out", help="where to write the listing")
    args = ap.parse_args(argv)
    if os.path.abspath(args.out) == JAX_LISTING:
        raise SystemExit(f"{args.out} is the JAX package's listing")

    funcs, classes, consts = listing()
    lines = ["permafrost_engine_tpu_torch `pf` module API",
             "(generated by permafrost_engine_tpu_torch/tools/dump_api.py "
             "— do not edit)", ""]
    lines.append(f"=== FUNCTIONS ({len(funcs)}) ===\n")
    lines.extend(funcs)
    lines.append(f"\n=== CLASSES ({len(classes)}) ===\n")
    lines.extend(classes)
    lines.append(f"\n=== CONSTANTS ({len(consts)}) ===\n")
    lines.extend(consts)
    with open(args.out, "w") as f:
        f.write("\n".join(lines) + "\n")
    print(f"wrote {args.out}: {len(funcs)} functions, {len(classes)} classes, "
          f"{len(consts)} constants")
    return args.out


if __name__ == "__main__":
    main()
