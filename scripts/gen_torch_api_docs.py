"""Regenerate the PyTorch port's API reference (docs/torch_api.md +
docs/torch_api/*.md) from its docstrings.

    python scripts/gen_torch_api_docs.py [--out DIR]

The counterpart of ``scripts/gen_api_docs.py``, which documents the JAX
package in docs/api.md and docs/api/: the same groups, signatures,
docstrings and method tables, for ``torchdr_tpu_torch``, whose only import
this is. docs/torch_api.md is the index: one summary table per group, each
symbol linking into its full entry. docs/torch_api/<group>.md carries the
full reference: signature, complete docstring, and, for classes, the
public method table. Every public name of the package's nine subpackages
(the top level, ``ops``, ``utils``, ``parallel``, ``eval``, ``affinity``,
``models``, ``models.neighbor``, ``models.spectral``) has an entry: a name
the top level exports under its own name, any other as
``<subpackage>.<name>``. The output is the same on every run: object
addresses are dropped from the defaults. ``--out`` writes under another
directory than docs/.
"""

import argparse
import importlib
import inspect
import os
import re
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torchdr_tpu_torch as tdt  # noqa: E402

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "docs")

SUBPACKAGES = ["ops", "utils", "parallel", "eval", "affinity", "models",
               "models.neighbor", "models.spectral"]

GROUP_BLURBS = {
    "models": "Estimators: neighbor-embedding and spectral families.",
    "affinity": "Affinity matrices over input data (dense, kNN-sparse, "
                "entropic, doubly-stochastic).",
    "ops": "Numeric core: distances, kNN tiers (exact / IVF / streaming), "
           "reductions, root search, k-means, PQ.",
    "parallel": "Multi-device layer: a mesh of torch devices driven by one "
                "process, sharded kNN and symmetrization.",
    "eval": "Embedding quality metrics (silhouette, kNN accuracy, "
            "neighborhood preservation, k-means ARI).",
    "utils": "Wrappers, validation, manifolds, optimizers, checkpointing, "
             "profiling, visualization.",
    "affinity_matcher": "The generic affinity-matching optimizer every "
                        "estimator runs.",
    "base": "Estimator base class (sklearn-style params, dedup, generator).",
    "cli": "Command-line interface.",
}
ORDER = ["models", "affinity", "ops", "parallel", "eval", "utils",
         "affinity_matcher", "base", "cli"]


def anchor(name: str) -> str:
    """The heading's anchor as GitHub makes it."""
    return re.sub(r"[^a-z0-9_-]", "", name.lower())


def sig_of(obj) -> str:
    try:
        sig = str(inspect.signature(obj))
    except (ValueError, TypeError):
        return "(...)"
    return re.sub(r" at 0x[0-9a-fA-F]+", "", sig)


def method_rows(cls) -> list[tuple[str, str]]:
    rows = []
    for mname, m in sorted(vars(cls).items()):
        if mname.startswith("_") or not callable(m):
            continue
        doc = (inspect.getdoc(m) or "").split("\n")[0]
        rows.append((mname, doc))
    return rows


def full_entry(name: str, obj) -> list[str]:
    short = name.rsplit(".", 1)[-1]
    lines = [f"### {name}", ""]
    if inspect.isclass(obj):
        lines.append(f"```python\nclass {short}{sig_of(obj)}\n```")
    elif callable(obj):
        lines.append(f"```python\n{short}{sig_of(obj)}\n```")
    else:
        lines.append(f"```python\n{short} = {re.sub(r' at 0x[0-9a-fA-F]+', '', repr(obj))}\n```")
    lines.append("")
    doc = inspect.getdoc(obj) if (inspect.isclass(obj) or callable(obj)) else None
    if doc:
        lines += [doc, ""]
    if inspect.isclass(obj):
        rows = method_rows(obj)
        if rows:
            lines += ["**Methods**", "", "| method | summary |", "|---|---|"]
            for mname, mdoc in rows:
                lines.append(f"| `{mname}` | {mdoc.replace('|', '│')} |")
            lines.append("")
    return lines


def public_names(mod) -> list[str]:
    """``__all__``, or where a module has none (``utils``), its public
    attributes that are not modules."""
    if hasattr(mod, "__all__"):
        return list(mod.__all__)
    return sorted(n for n, v in vars(mod).items()
                  if not n.startswith("_") and not inspect.ismodule(v))


def entries() -> list[tuple[str, str, object]]:
    """(group, label, object) of every public name: the top level's by its
    own name and its module's group; the subpackages' other names as
    ``<subpackage>.<name>`` in the subpackage's group."""
    out, top = [], {}
    for name in sorted(tdt.__all__):
        obj = getattr(tdt, name)
        mod = getattr(obj, "__module__", "") or ""
        out.append((mod.split(".")[1] if "." in mod else "utils", name, obj))
        top[name] = obj
    for sub in SUBPACKAGES:
        mod = importlib.import_module(f"torchdr_tpu_torch.{sub}")
        for name in sorted(public_names(mod)):
            obj = getattr(mod, name)
            if name in top and top[name] is obj:
                continue
            out.append((sub.split(".")[0], f"{sub}.{name}", obj))
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=ROOT, help="directory of torch_api.md (default docs/)")
    args = parser.parse_args(argv)

    groups: dict[str, list[tuple[str, object]]] = {}
    seen = set()
    for key, name, obj in entries():
        if name not in seen:
            seen.add(name)
            groups.setdefault(key, []).append((name, obj))
    ordered = [g for g in ORDER if g in groups] + sorted(set(groups) - set(ORDER))

    idx = [
        "# API reference of the PyTorch port",
        "",
        "Every public symbol of `torchdr_tpu_torch` (auto-generated from docstrings;",
        "regenerate with `python scripts/gen_torch_api_docs.py`). Each symbol links",
        "to its full entry — signature, docstring, methods — under `docs/torch_api/`.",
        "The JAX package's reference is `docs/api.md`.",
        "",
    ]
    os.makedirs(os.path.join(args.out, "torch_api"), exist_ok=True)
    total = 0
    for g in ordered:
        page = [f"# `{g}` — full API", ""]
        if g in GROUP_BLURBS:
            page += [GROUP_BLURBS[g], ""]
        idx += [f"## {g}", ""]
        if g in GROUP_BLURBS:
            idx += [GROUP_BLURBS[g], ""]
        idx += ["| symbol | summary |", "|---|---|"]
        for name, obj in groups[g]:
            doc = (inspect.getdoc(obj) or "").split("\n")[0] if callable(obj) else ""
            idx.append(f"| [`{name}`](torch_api/{g}.md#{anchor(name)}) | {doc.replace('|', '│')} |")
            page += full_entry(name, obj)
            total += 1
        idx.append("")
        with open(os.path.join(args.out, "torch_api", f"{g}.md"), "w") as f:
            f.write("\n".join(page))
    with open(os.path.join(args.out, "torch_api.md"), "w") as f:
        f.write("\n".join(idx))
    print("symbols:", total, "groups:", len(ordered))
    return 0


if __name__ == "__main__":
    sys.exit(main())
