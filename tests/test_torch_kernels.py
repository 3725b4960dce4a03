"""The port's kernel registry and launch seam (gsdf_tpu_torch/kernels.py) on
the CPU: the registry covers every kernel source of csrc/ and states each
C entry point as the source declares it, in both forms; LAUNCHES has a key
for each kernel form the registry can launch and no other; and kernels.py
sits below the wrapper layers, which import it and not each other's
builders."""
import ast
import ctypes
import os
import re

import pytest

from gsdf_tpu_torch import kernels

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "gsdf_tpu_torch")
C_TYPES = {"float": ctypes.c_float, "int": ctypes.c_int, "int64_t": ctypes.c_int64,
           "long long": ctypes.c_int64}
EXTERN_C = re.compile(
    r'extern "C"(?: __attribute__\(\(weak\)\))? ([\w ]+?)\s*\b(gsdf_\w+)\(([^)]*)\)')


def _c_type(decl: str):
    if "*" in decl:
        return ctypes.c_void_p
    return C_TYPES[decl.replace("const ", "").strip().rsplit(" ", 1)[0]]


def _declared(template: str) -> dict:
    """C function -> (return type, argument types) as the template and the
    csrc/ files it includes declare them (with the parameter header,
    which declares gsdf_params_by_value)."""
    spec = kernels.TEMPLATES[template]
    names = (template, *spec.includes, kernels.PARAMS_HEADER)
    out = {}
    for name in names:
        with open(os.path.join(kernels.CSRC, name)) as f:
            for ret, fn, args in EXTERN_C.findall(f.read()):
                args = [a for a in args.split(",") if a.strip()]
                out[fn] = (C_TYPES[ret.strip()], [_c_type(a) for a in args])
    return out


def test_the_registry_covers_every_kernel_source():
    sources = {f for f in os.listdir(kernels.CSRC) if f.endswith(".cu")}
    assert set(kernels.TEMPLATES) == sources
    per_tree = {t for t, spec in kernels.TEMPLATES.items() if spec.per_tree}
    assert {t for templates in kernels.LIBRARIES.values() for t in templates} == per_tree
    assert {f"{name}.cu" for name in kernels.STATIC_KERNELS} == sources - per_tree
    for spec in kernels.TEMPLATES.values():
        for header in spec.includes:
            assert os.path.exists(os.path.join(kernels.CSRC, header)), header
        assert not (spec.generated and not spec.per_tree)


@pytest.mark.parametrize("template", sorted(kernels.TEMPLATES))
def test_each_signature_is_the_sources(template):
    """Every C function a library of the template loads, in each form it
    has, with the return and argument types its source declares: the
    parametric entry points are derived from the baked ones."""
    declared = _declared(template)
    spec = kernels.TEMPLATES[template]
    for parametric in (False, True) if spec.parametric else (False,):
        sigs = kernels._signatures((template,), parametric)
        assert len(sigs) == len(spec.entries) + len(spec.queries) + parametric
        for fn, (restype, argtypes) in sigs.items():
            assert declared[fn] == (restype, argtypes), fn


def test_launches_has_each_form_the_registry_launches():
    expected = set()
    for template, spec in kernels.TEMPLATES.items():
        name = template[: -len(".cu")]
        if not spec.counts_as:
            expected |= {name, f"{name}_param"} if spec.parametric else {name}
        else:
            assert spec.counts_as in kernels.LAUNCHES
    assert set(kernels.LAUNCHES) == expected and len(kernels.LAUNCHES) == 19


class _StubCDLL:
    """Any gsdf_* attribute: a C function that returns 0."""

    def __getattr__(self, name):
        if not name.startswith("gsdf_"):
            raise AttributeError(name)
        return lambda *args: 0


@pytest.mark.parametrize("library", sorted(kernels.LIBRARIES) + list(kernels.STATIC_KERNELS))
def test_every_library_counts_under_a_launches_key(library):
    templates = kernels.LIBRARIES.get(library, (f"{library}.cu",))
    forms = (False, True) if all(kernels.TEMPLATES[t].parametric for t in templates) else (False,)
    for parametric in forms:
        lib = kernels.Library(_StubCDLL(), templates, parametric)
        names = {name for name, _ in lib._entries.values()}
        assert names and names <= set(kernels.LAUNCHES)
        assert all(name.endswith("_param") == parametric for name in names)


def _imports(path):
    """(module imported, inside a function) of every import in the file,
    relative imports resolved against the package."""
    with open(path) as f:
        tree = ast.parse(f.read())
    package = os.path.relpath(os.path.dirname(path), REPO).split(os.sep)
    out = []

    def visit(node, in_function):
        for child in ast.iter_child_nodes(node):
            inside = in_function or isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef))
            if isinstance(child, ast.Import):
                out.extend((a.name, inside) for a in child.names)
            elif isinstance(child, ast.ImportFrom):
                base = package[: len(package) - child.level + 1] if child.level else []
                module = ".".join(base + ([child.module] if child.module else []))
                out.append((module, inside))
                out.extend((f"{module}.{a.name}", inside) for a in child.names)
            visit(child, inside)

    visit(tree, False)
    return out


def test_kernels_sits_below_the_wrapper_layers():
    """kernels.py imports no module of eval/, ops/, render/, visual/ or
    pipeline/ but the table modules, and no module of ops/ imports K1's
    wrapper module inside a function."""
    layers = tuple(f"gsdf_tpu_torch.{layer}" for layer in
                   ("eval", "ops", "render", "visual", "pipeline"))
    tables = {"gsdf_tpu_torch.ops.mc_tables", "gsdf_tpu_torch.ops.dc_tables"}
    bad = [m for m, _ in _imports(os.path.join(PKG, "kernels.py"))
           if m.startswith(layers) and m not in tables and m not in layers]
    assert not bad, bad
    ops = os.path.join(PKG, "ops")
    for f in sorted(os.listdir(ops)):
        if f.endswith(".py"):
            late = [m for m, inside in _imports(os.path.join(ops, f))
                    if inside and m.startswith("gsdf_tpu_torch.eval.grid_kernels")]
            assert not late, (f, late)


def test_core_sits_below_the_codegen():
    """No module of core/ imports codegen/, which imports core.node: a
    node asks its Codegen for what it emits (the bin table of a threshold
    form's loop is `Codegen.table_walk`'s)."""
    core = os.path.join(PKG, "core")
    for f in sorted(os.listdir(core)):
        if f.endswith(".py"):
            up = [m for m, _ in _imports(os.path.join(core, f))
                  if m.startswith("gsdf_tpu_torch.codegen")]
            assert not up, (f, up)
