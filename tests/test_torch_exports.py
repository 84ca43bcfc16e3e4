"""Every name a JAX package ``__init__`` exports resolves in the port.

The names are read from the JAX package's ``__init__`` files without
importing them (their ``from ... import`` lines, module-level definitions,
the top level's lazy ``_LAZY`` table and ``core``'s lazy ``prng``); a fresh
interpreter with no jax then resolves each one on the port's package of the
same path.  A name the port has not ported yet sits in :data:`WAITING` with
the ROADMAP.md queue-A item that will port it, and that item's entry must
mention it; a whole package still to port sits in :data:`WAITING_PACKAGES`
the same way.
"""

import ast
import json
import os
import re
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG = os.path.join(REPO, "znicz_tpu")
ROADMAP = open(os.path.join(REPO, "ROADMAP.md")).read()

# (package, name) -> the ROADMAP.md item that ports it
WAITING = {
    ("", "Ensemble"): "A11",
}
# JAX packages with no port package yet -> their ROADMAP.md item.  The
# static analyzer (``analysis``) is not ported: it is jax-free and checks
# the port's sources as they are (ROADMAP.md A11); ``ops/pallas`` holds the
# TPU kernels, whose Hopper kernels live under ``ops/kernels``.
WAITING_PACKAGES = {
    "ensemble": "A11",
    "genetics": "A11",
}
NOT_PORTED_AS_PACKAGES = {"analysis", "analysis.rules", "ops.pallas"}


def _exports(path):
    """The public names a package ``__init__`` exports, read off its AST."""
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "_LAZY" and isinstance(node.value, ast.Dict):
                        names.update(k.value for k in node.value.keys)
    if any(isinstance(n, ast.FunctionDef) and n.name == "__getattr__" for n in tree.body):
        names.update(re.findall(r'name == "(\w+)"', open(path).read()))
    return {n for n in names if not n.startswith("_")}


def _packages():
    out = {}
    for root, _, files in os.walk(JAX_PKG):
        if "__init__.py" in files and "__pycache__" not in root:
            rel = os.path.relpath(root, JAX_PKG)
            out["" if rel == "." else rel.replace(os.sep, ".")] = _exports(
                os.path.join(root, "__init__.py"))
    return out


PACKAGES = _packages()


def test_every_jax_package_is_mirrored_or_waits():
    for pkg in PACKAGES:
        top = pkg.split(".")[0] if pkg else ""
        if pkg in NOT_PORTED_AS_PACKAGES or top in WAITING_PACKAGES:
            continue
        port_dir = os.path.join(REPO, "znicz_tpu_torch", *pkg.split(".")) if pkg else os.path.join(
            REPO, "znicz_tpu_torch")
        assert os.path.exists(os.path.join(port_dir, "__init__.py")), pkg


def _entry(item):
    found = re.search(rf"^{item}\. \*\*.*?(?=^A\d+\. \*\*|^### )", ROADMAP, re.M | re.S)
    assert found, f"ROADMAP.md has no item {item}"
    return found.group(0)


@pytest.mark.parametrize("key", sorted(WAITING), ids=lambda k: f"{k[0] or 'top'}.{k[1]}")
def test_each_waiting_name_is_exported_by_jax_and_named_by_its_item(key):
    pkg, name = key
    assert name in PACKAGES[pkg], f"znicz_tpu.{pkg} does not export {name}"
    assert name in _entry(WAITING[key]), f"ROADMAP.md {WAITING[key]} does not mention {name}"


@pytest.mark.parametrize("pkg", sorted(WAITING_PACKAGES))
def test_each_waiting_package_is_named_by_its_item(pkg):
    assert f"{pkg}/" in _entry(WAITING_PACKAGES[pkg])


def _resolvable():
    out = {}
    for pkg, names in PACKAGES.items():
        top = pkg.split(".")[0] if pkg else ""
        if pkg in NOT_PORTED_AS_PACKAGES or top in WAITING_PACKAGES:
            continue
        out[pkg] = sorted(n for n in names if (pkg, n) not in WAITING)
    return out


def test_every_exported_name_resolves_on_a_fresh_interpreter():
    wanted = _resolvable()
    assert sum(len(v) for v in wanted.values()) > 100
    code = (
        "import importlib, json, sys\n"
        f"wanted = {wanted!r}\n"
        "missing = []\n"
        "for pkg, names in wanted.items():\n"
        "    mod = importlib.import_module('znicz_tpu_torch' + ('.' + pkg if pkg else ''))\n"
        "    for n in names:\n"
        "        try:\n"
        "            getattr(mod, n)\n"
        "        except AttributeError:\n"
        "            missing.append((pkg, n))\n"
        "bad = [m for m in sys.modules if m in ('jax', 'znicz_tpu') or m.startswith(('jax.', "
        "'znicz_tpu.'))]\n"
        "print(json.dumps({'missing': missing, 'bad': bad}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["missing"] == []
    assert res["bad"] == []


def test_the_top_level_is_lazy():
    """A bare ``import znicz_tpu_torch`` loads neither torch nor the
    subsystems; the lazy names load them on first use."""
    code = (
        "import json, sys\n"
        "import znicz_tpu_torch as z\n"
        "before = sorted(m for m in sys.modules if m.split('.')[0] in ('torch', 'numpy'))\n"
        "z.StandardWorkflow, z.prng\n"
        "print(json.dumps([before, 'torch' in sys.modules, 'StandardWorkflow' in dir(z)]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True)
    before, torch_after, listed = json.loads(out.stdout.strip().splitlines()[-1])
    assert before == [] and torch_after and listed
