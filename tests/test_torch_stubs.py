"""Typed surface of the port: ppca_rs_tpu_torch/__init__.pyi against the
runtime, in both directions.

As tests/test_stubs.py does for the JAX package (no type checker is
installed here): every class, method, function and attribute the stub
declares exists at runtime with the same parameter names in the same
order.  And the reverse, which the JAX test does not hold: every name in
``__all__``, and every public method, property and attribute that the
port's own classes define (what a class inherits from ``torch.nn.Module``
or ``object`` is not the port's surface), is declared in the stub.
"""

import ast
import dataclasses
import inspect
import pathlib

import ppca_rs_tpu_torch as tp

STUB = pathlib.Path(tp.__file__).with_name("__init__.pyi")

#: Names of the stub with no runtime counterpart: its type aliases.
TYPE_ALIASES = {"ArrayLike", "Device", "DeviceMesh", "Metric", "MetricsCallback", "ChunkLike"}
#: Dunder methods that are part of the surface (``len(ds)``, iteration).
DUNDERS = {"__init__", "__len__", "__iter__", "__next__"}


def stub_tree():
    return ast.parse(STUB.read_text())


def stub_classes():
    return {n.name: n for n in stub_tree().body if isinstance(n, ast.ClassDef)}


def runtime_class(name):
    return type(tp.config) if name == "Config" else getattr(tp, name, None)


def is_property(node):
    return any(isinstance(d, ast.Name) and d.id == "property" for d in node.decorator_list)


def stub_members(node):
    """(functions by name, attribute names) declared in a stub class."""
    funcs = {i.name: i for i in node.body if isinstance(i, ast.FunctionDef)}
    attrs = {i.target.id for i in node.body
             if isinstance(i, ast.AnnAssign) and isinstance(i.target, ast.Name)}
    return funcs, attrs


def stub_names(fn):
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs if x.arg not in ("self", "cls")]


def runtime_names(fn):
    params = inspect.signature(fn).parameters.values()
    return [p.name for p in params if p.name not in ("self", "cls")
            and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]


def own_members(cls):
    """Public members that the port's own classes in ``cls``'s MRO define:
    {name: the raw class attribute}."""
    out = {}
    for base in reversed(cls.__mro__):
        if not base.__module__.startswith("ppca_rs_tpu_torch"):
            continue
        for name, value in vars(base).items():
            if not name.startswith("_") or name in DUNDERS:
                out[name] = value
    return out


def own_attributes(cls):
    """Instance attributes the port's classes declare: slots, annotations
    and dataclass fields, the public ones."""
    names = set()
    for base in cls.__mro__:
        if base.__module__.startswith("ppca_rs_tpu_torch"):
            names.update(getattr(base, "__slots__", ()))
            names.update(vars(base).get("__annotations__", {}))
    if dataclasses.is_dataclass(cls):
        names.update(f.name for f in dataclasses.fields(cls))
    return {n for n in names if not n.startswith("_")}


def test_stub_parses_and_imports_only_typing_numpy_torch():
    roots = set()
    for node in ast.walk(stub_tree()):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert roots == {"typing", "numpy", "torch"}


def test_every_stub_name_exists_at_runtime():
    missing = []
    for node in stub_tree().body:
        if isinstance(node, ast.ClassDef):
            cls = runtime_class(node.name)
            if cls is None:
                missing.append(node.name)
                continue
            funcs, attrs = stub_members(node)
            missing += [f"{node.name}.{f}" for f in funcs if not hasattr(cls, f)]
            missing += [f"{node.name}.{a}" for a in attrs
                        if not hasattr(cls, a) and a not in own_attributes(cls)]
        elif isinstance(node, ast.FunctionDef):
            if not hasattr(tp, node.name):
                missing.append(node.name)
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            if node.target.id not in TYPE_ALIASES and not hasattr(tp, node.target.id):
                missing.append(node.target.id)
    assert not missing, missing


def test_stub_signatures_match_runtime():
    """Parameter names and their order, for every function and method the
    stub declares; properties, static and class methods declared as such."""
    mismatches = []
    for node in stub_tree().body:
        if isinstance(node, ast.FunctionDef):
            if stub_names(node) != runtime_names(getattr(tp, node.name)):
                mismatches.append(f"{node.name}: {stub_names(node)} != "
                                  f"{runtime_names(getattr(tp, node.name))}")
        if not isinstance(node, ast.ClassDef):
            continue
        cls = runtime_class(node.name)
        for name, fn in stub_members(node)[0].items():
            impl = inspect.getattr_static(cls, name)
            kinds = {d.id for d in fn.decorator_list if isinstance(d, ast.Name)}
            if is_property(fn):
                if not isinstance(impl, property):
                    mismatches.append(f"{node.name}.{name}: not a property at runtime")
                continue
            for kind, typ in (("staticmethod", staticmethod), ("classmethod", classmethod)):
                if (kind in kinds) != isinstance(impl, typ):
                    mismatches.append(f"{node.name}.{name}: {kind} in one of stub and runtime")
            impl = impl.__func__ if isinstance(impl, (staticmethod, classmethod)) else impl
            if stub_names(fn) != runtime_names(impl):
                mismatches.append(f"{node.name}.{name}: stub {stub_names(fn)} != "
                                  f"runtime {runtime_names(impl)}")
    assert not mismatches, "\n".join(mismatches)


def test_all_and_every_public_member_is_in_the_stub():
    tree = stub_tree()
    declared = {n.name for n in tree.body if isinstance(n, (ast.ClassDef, ast.FunctionDef))}
    declared |= {n.target.id for n in tree.body
                 if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name)}
    assert set(tp.__all__) <= declared, sorted(set(tp.__all__) - declared)

    classes = stub_classes()
    undeclared = []
    for name in tp.__all__:
        obj = getattr(tp, name)
        if name == "config":
            name, obj = "Config", type(obj)
        if not inspect.isclass(obj):
            continue
        funcs, attrs = stub_members(classes[name])
        undeclared += [f"{name}.{m}" for m, v in own_members(obj).items()
                       if m not in funcs and m not in attrs
                       and (callable(v) or isinstance(v, (property, staticmethod, classmethod)))]
        undeclared += [f"{name}.{a}" for a in own_attributes(obj)
                       if a not in attrs and a not in funcs]
    assert not undeclared, undeclared
