"""The port covers the JAX package, read from both trees with ``ast`` (no
module of either is imported):

- every module of ``reak_tpu/`` has its file at the same path in
  ``reak_tpu_torch/``, except the three ``ops/*_pallas.py``, whose
  functions that reach ``pallas_call`` each map to a binding of the port's
  ``ops/``;
- every public top-level name (function, class, module constant) and every
  ``__all__`` entry of a JAX module exists in its counterpart, where a
  package's ``__all__`` may name a submodule file; the one exception is
  ``ops/chol_lanes.FORCE_INTERPRET``, the switch that runs the Pallas
  kernel in interpret mode (a CUDA kernel has none; the port's CPU path is
  the plain version);
- no file of ``reak_tpu_torch/``, nor ``chip_smoke.py``, imports ``jax`` or
  ``reak_tpu``.
"""
import ast
import functools
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "reak_tpu", ROOT / "reak_tpu_torch"
PALLAS = {
    "kte_core_pallas.py": {"make_step_lanes": "kte_step.py::make_step_lanes",
                           "make_core_lanes": "kte_core.py::make_core_lanes"},
    "pdip_whole_pallas.py": {
        "make_whole_pdip": "pdip_whole.py::make_whole_pdip"},
    "riccati_bwd_pallas.py": {
        "make_fused_backward": "riccati_bwd.py::fused_backward",
        "make_vector_backward": "riccati_bwd.py::vector_backward",
        "make_forward": "riccati_bwd.py::forward"},
}
NO_COUNTERPART = {("ops/chol_lanes.py", "FORCE_INTERPRET")}


@functools.lru_cache(maxsize=None)
def _tree(path):
    return ast.parse(path.read_text(), filename=str(path))


def _top_level(path):
    """(public top-level names, ``__all__`` entries) of a module."""
    names, exported = set(), []
    for node in _tree(path).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) \
                else [node.target]
            for target in targets:
                for n in ast.walk(target):
                    if isinstance(n, ast.Name):
                        names.add(n.id)
                        if n.id == "__all__":
                            exported = [e.value for e in node.value.elts]
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            names.update((a.asname or a.name).split(".")[0]
                         for a in node.names)
    return {n for n in names if not n.startswith("_")}, exported


def _jax_modules():
    return sorted(p.relative_to(JAX) for p in JAX.rglob("*.py"))


def test_every_module_has_its_file():
    missing = [str(rel) for rel in _jax_modules()
               if rel.parent.name + "/" + rel.name
               not in {"ops/" + f for f in PALLAS}
               and not (PORT / rel).exists()]
    assert not missing, f"no counterpart in reak_tpu_torch/: {missing}"


def test_pallas_functions_map_to_bindings():
    """Each function of a ``*_pallas.py`` that reaches ``pallas_call``
    (directly or through another function of its module) is in the table,
    and its binding is a top-level function of the port's ``ops/``."""
    for name, table in PALLAS.items():
        tree = _tree(JAX / "ops" / name)
        defs = {n.name: n for n in tree.body
                if isinstance(n, ast.FunctionDef)}
        calls = {k: {c.func.id for c in ast.walk(n)
                     if isinstance(c, ast.Call)
                     and isinstance(c.func, ast.Name) and c.func.id in defs}
                 for k, n in defs.items()}
        reach = {k for k, n in defs.items()
                 if any(isinstance(a, ast.Attribute) and a.attr ==
                        "pallas_call" for a in ast.walk(n))}
        while new := {k for k in defs if calls[k] & reach} - reach:
            reach |= new
        assert reach == set(table), (name, sorted(reach))
        for binding in table.values():
            path, func = binding.split("::")
            port_defs = {n.name for n in _tree(PORT / "ops" / path).body
                         if isinstance(n, ast.FunctionDef)}
            assert func in port_defs, binding


def test_public_names_exist():
    missing = []
    for rel in _jax_modules():
        if not (PORT / rel).exists():
            continue
        names, exported = _top_level(JAX / rel)
        port_names, port_exported = _top_level(PORT / rel)
        if rel.name == "__init__.py":
            # a package's exports may be its submodules
            port_names |= {p.stem for p in (PORT / rel).parent.glob("*.py")}
        # a module's imports are public names only where it exports them
        local = {n for n in names if n in exported
                 or not _imported(JAX / rel, n)}
        for n in sorted(local | set(exported)):
            if (str(rel), n) in NO_COUNTERPART:
                continue
            if n not in port_names:
                missing.append(f"{rel}::{n}")
        for n in exported:
            if n not in port_exported:
                missing.append(f"{rel}::__all__[{n}]")
    assert not missing, missing


def _imported(path, name):
    return any(isinstance(node, (ast.Import, ast.ImportFrom))
               and name in {(a.asname or a.name).split(".")[0]
                            for a in node.names}
               for node in _tree(path).body)


def test_port_imports_no_jax():
    offenders = []
    for path in sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        for node in ast.walk(_tree(path)):
            if isinstance(node, ast.Import):
                mods = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                mods = [node.module or ""]
            else:
                continue
            for m in mods:
                if m.split(".")[0] in ("jax", "jaxlib", "reak_tpu"):
                    offenders.append(f"{path.relative_to(ROOT)}: {m}")
    assert not offenders, offenders
