"""What the benchmark imports, compared by whole top-level module names
(``repro_torch`` begins with ``repro``, and is not it)."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
JAX_SIDE = {"jax", "jaxlib", "flax", "repro"}
#: modules that must not reach the program either: the plain reference and
#: the generators of data and traffic (and the control, built on them)
PLAIN = ("reference", "data.py", "queries.py", "cell.py", "control.py")


def imports(path: Path):
    """(top-level name, perfbench module or None) of every import."""
    pkg = path.relative_to(ROOT).with_suffix("").parts[:-1]
    out = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out += [(a.name.split(".")[0], a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                base = list(pkg[: len(pkg) - node.level + 1])
                mod = ".".join(base + ([node.module] if node.module else []))
                out.append(("perfbench", mod))
                out += [("perfbench", f"{mod}.{a.name}") for a in node.names]
            else:
                out.append((node.module.split(".")[0], node.module))
                out += [(node.module.split(".")[0], f"{node.module}.{a.name}")
                        for a in node.names]
    return out


def sources():
    return sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in
                  p.parts)


def module_file(name: str):
    parts = name.split(".")
    f = ROOT.joinpath(*parts)
    if f.with_suffix(".py").is_file():
        return f.with_suffix(".py")
    if (f / "__init__.py").is_file():
        return f / "__init__.py"
    return None


def reachable(path: Path):
    """Every top-level name imported by ``path`` and the benchmark's modules
    it imports, transitively."""
    seen, todo, tops = set(), [path], set()
    while todo:
        p = todo.pop()
        if p in seen:
            continue
        seen.add(p)
        for top, mod in imports(p):
            tops.add(top)
            if top == "perfbench":
                f = module_file(mod)
                if f is not None:
                    todo.append(f)
    return tops


@pytest.mark.parametrize("path", sources(), ids=lambda p: p.name)
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not {t for t, _ in imports(path)} & JAX_SIDE


@pytest.mark.parametrize("path", [p for p in sources() if any(
    part in PLAIN for part in p.relative_to(HERE).parts)],
    ids=lambda p: str(p.relative_to(HERE)))
def test_reference_and_generators_never_reach_the_program(path):
    tops = reachable(path)
    assert "repro_torch" not in tops and not tops & JAX_SIDE, tops


def test_whole_names_are_compared():
    # the port's name begins with the JAX package's: a prefix test would
    # flag it, a whole-name test does not
    assert "repro_torch" not in JAX_SIDE
    assert "repro_torch".split(".")[0] != "repro"


def test_importing_the_plain_side_loads_neither():
    code = ("import sys; import perfbench.reference, perfbench.queries, "
            "perfbench.data, perfbench.control; "
            "bad = sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'repro', 'repro_torch'}); "
            "print(','.join(bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_harness_loads_no_jax():
    from perfbench.run import FORBIDDEN, forbidden_modules
    assert set(FORBIDDEN) == JAX_SIDE
    assert callable(forbidden_modules)
