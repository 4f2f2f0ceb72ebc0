"""The port's import surface against the JAX package's: every module of
iqwaveform_tpu has a counterpart in iqwaveform_torch, and every public
name of it, with every parameter of its signature, exists there, so that
code written against the JAX package runs on the port by changing the
package name.

Which names count:
- a facade (the package root, ``fourier``, ``power_analysis``, ``util``,
  ``windows``, ``ofdm``) or a package ``__init__``: every public name it
  binds, re-exports included (the reference's import surface);
- any other module: every public name it defines itself (functions,
  classes, assignments; not what it imports for its own use).

Exclusions, and nothing else:
- imported modules from outside the package (``jax``, ``np``, ``pd``,
  ``signal``, ...); a submodule of the package counts, as a module;
- the JAX mesh types (``Mesh``, ``P``, ``NamedSharding``,
  ``PartitionSpec``);
- ``ops.pallas`` and its modules (the port's ``ops.kernels`` takes their
  place), and private modules (a leading underscore).

The port may add parameters (``device``, among others): a signature's
check is that each JAX parameter exists in the port's, and that the
parameters a caller can pass by position come in the same order.
"""

import ast
import importlib
import inspect
import pkgutil
import types
from pathlib import Path

import matplotlib

matplotlib.use('Agg')

import pytest  # noqa: E402

import iqwaveform_tpu  # noqa: E402

FACADES = {'', 'fourier', 'power_analysis', 'util', 'windows', 'ofdm'}
MESH_TYPES = {'Mesh', 'P', 'NamedSharding', 'PartitionSpec'}
EXCLUDED_MODULES = ('ops.pallas',)


def _jax_modules():
    names = ['']
    for info in pkgutil.walk_packages(iqwaveform_tpu.__path__, 'iqwaveform_tpu.'):
        rel = info.name[len('iqwaveform_tpu.'):]
        if any(part.startswith('_') for part in rel.split('.')):
            continue
        if any(rel == m or rel.startswith(m + '.') for m in EXCLUDED_MODULES):
            continue
        names.append(rel)
    return names


JAX_MODULES = _jax_modules()


def _module(pkg: str, rel: str):
    return importlib.import_module(pkg + ('.' + rel if rel else ''))


def _defined_names(module) -> set:
    """the public names a module's own top-level statements bind (function
    and class definitions and assignments, inside if / try blocks too)."""
    tree = ast.parse(Path(module.__file__).read_text())
    names = set()

    def visit(stmts):
        for node in stmts:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                names.add(node.name)
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    for n in ast.walk(t):
                        if isinstance(n, ast.Name):
                            names.add(n.id)
            elif isinstance(node, ast.If):
                visit(node.body)
                visit(node.orelse)
            elif isinstance(node, ast.Try):
                visit(node.body)
                for h in node.handlers:
                    visit(h.body)
                visit(node.orelse)

    visit(tree.body)
    return {n for n in names if not n.startswith('_')}


def surface(rel: str) -> dict:
    """{name: JAX value} of the names that count in module ``rel``."""
    jm = _module('iqwaveform_tpu', rel)
    is_package = hasattr(jm, '__path__')
    own = None if (rel in FACADES or is_package) else _defined_names(jm)
    out = {}
    for name, value in vars(jm).items():
        if name.startswith('_') or name in MESH_TYPES:
            continue
        if own is not None and name not in own:
            continue
        if isinstance(value, types.ModuleType):
            sub = value.__name__
            if not sub.startswith('iqwaveform_tpu.'):
                continue  # an imported module from outside the package
            sub_rel = sub[len('iqwaveform_tpu.'):]
            if any(sub_rel == m or sub_rel.startswith(m + '.') for m in EXCLUDED_MODULES):
                continue
        out[name] = value
    return out


@pytest.mark.parametrize('rel', JAX_MODULES, ids=lambda r: r or '<root>')
def test_every_module_and_name_exists(rel):
    port = _module('iqwaveform_torch', rel)
    missing = []
    for name, value in surface(rel).items():
        if not hasattr(port, name):
            missing.append(name)
        elif isinstance(value, types.ModuleType):
            want = 'iqwaveform_torch.' + value.__name__[len('iqwaveform_tpu.'):]
            got = getattr(port, name)
            if not isinstance(got, types.ModuleType) or got.__name__ != want:
                missing.append(f'{name} (not the module {want})')
    assert not missing, f'iqwaveform_torch.{rel} lacks {missing}'


def _params(fn):
    try:
        return inspect.signature(fn).parameters
    except (TypeError, ValueError):
        return None


def _check_signature(label: str, jax_fn, port_fn, problems: list):
    jp, tp = _params(jax_fn), _params(port_fn)
    if jp is None:
        return
    if tp is None:
        problems.append(f'{label}: no signature in the port')
        return
    absent = [p for p in jp if p not in tp and jp[p].kind not in (
        inspect.Parameter.VAR_POSITIONAL, inspect.Parameter.VAR_KEYWORD)]
    if absent:
        problems.append(f'{label}: lacks {absent}')
    positional = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)
    j_pos = [p for p, v in jp.items() if v.kind in positional]
    t_pos = [p for p, v in tp.items() if v.kind in positional]
    if t_pos[: len(j_pos)] != j_pos:
        problems.append(f'{label}: positional order {t_pos} against {j_pos}')


def _public_methods(cls) -> dict:
    out = {}
    for klass in reversed(cls.__mro__):
        if not klass.__module__.startswith('iqwaveform_tpu'):
            continue
        for name, value in vars(klass).items():
            if not name.startswith('_') and callable(value) and not isinstance(value, type):
                out[name] = value
    return out


@pytest.mark.parametrize('rel', JAX_MODULES, ids=lambda r: r or '<root>')
def test_every_signature_holds(rel):
    port = _module('iqwaveform_torch', rel)
    problems = []
    for name, value in surface(rel).items():
        if isinstance(value, types.ModuleType) or not callable(value):
            continue
        other = getattr(port, name, None)
        if other is None:
            continue  # reported by the test above
        _check_signature(f'{rel}.{name}', value, other, problems)
        if isinstance(value, type) and value.__module__.startswith('iqwaveform_tpu'):
            for method, fn in _public_methods(value).items():
                theirs = getattr(other, method, None)
                if theirs is None:
                    problems.append(f'{rel}.{name}.{method}: absent')
                else:
                    _check_signature(f'{rel}.{name}.{method}', fn, theirs, problems)
    assert not problems, '\n'.join(problems)


def test_the_surface_is_not_empty():
    """the walk sees the modules the port added in this slice."""
    for rel in ('env', 'figures', 'type_stubs', 'util', 'windows', 'ops.mxu_fft', 'io'):
        assert rel in JAX_MODULES
    assert {'read_sigmf', 'write_sigmf', 'waveform_to_frame'} <= set(surface('io'))
    assert len(surface('ops')) >= 49 and len(surface('fourier')) >= 50
