"""The port's public surface against the JAX package's, module by module.

For ``regex_fpga_tpu`` and its ``api``, ``re_compat``, ``ops``, ``utils``,
``models`` and ``parallel`` packages with every submodule, each public name
(the module's ``__all__`` and every name it defines at top level without a
leading underscore) must resolve in the port's counterpart module, and each
public callable (functions, jitted ones through ``inspect.signature``,
classes and their methods) must take JAX's positional parameters first, in
JAX's order. The exceptions are named here, each with its reason: the
TPU-only names, the recorded renames (``torch_jax_alias.RENAMES``, which
the JAX suites' import hook answers too) and the deliberate signature
differences (``ROADMAP.md`` section 3).
"""

from __future__ import annotations

import ast
import importlib
import inspect
import pkgutil

import pytest

import regex_fpga_tpu
from torch_jax_alias import RENAMES

#: JAX modules whose port counterpart has another name: the Pallas kernels'
#: modules, whose kernels the port runs from ``hopper_dfa`` and ``hopper_kgram``
COUNTERPART = {"ops.pallas_dfa": "ops.hopper_dfa",
               "ops.pallas_kgram": "ops.hopper_kgram"}

#: names left out of the port on purpose, by module: they describe or drive
#: the TPU build
TPU_ONLY = {
    "ops.dfa_fast": {
        "mm_dtype": "the one-hot GEMM's matmul dtype",
        "mm_precision": "the one-hot GEMM's matmul precision",
        "split_states": "the state-split GEMM layout",
        "step_orientation_costs": "the GEMM orientation's cost model",
        "transposed_step": "the state-contracted GEMM orientation",
    },
    "ops.kgram": {"make_kgram_step": "the k-gram GEMM step of the XLA pass"},
    "ops.router": {"DEVICE_TILE_BPS": "a TPU tile's measured rate"},
    "parallel.comm_model": {
        "V5E_ICI_LINK_BPS": "the TPU v5e interconnect's link rate",
        "COLLECTIVE_LATENCY_S": "the TPU v5e collective latency",
    },
    "ops.pallas_dfa": {
        "LANE_TILE": "the Pallas grid's lane tile",
        "chain_pass_counts_pallas": "the Pallas entry of K2 (port: dfa_chain_counts)",
        "chain_pass_finals_pallas": "the Pallas entry of K1 (port: dfa_chain)",
        "chain_pass_full_pallas": "the Pallas entry of K1's full mode (port: dfa_chain)",
    },
    "ops.pallas_kgram": {
        "KGRAM_LANE_TILE": "the Pallas grid's lane tile",
        "kgram_chain_pallas": "the Pallas entry of K3 (port: kgram_chain)",
        "pack_ta128": "K3's table packed for 128-lane vregs",
    },
}


_MESH_DEVICES = ("devices: JAX devices of the mesh; the port's mesh ranks are "
                 "torch.distributed processes")
_PALLAS = "use_pallas picks the TPU's Pallas kernel; the port has one kernel a pass"
_KGRAM = ("the TPU's (table, acc_table) pair is one table ``ta`` on the card, "
          "with its byte maps (``maps``); use_pallas and acc_bound are TPU-only")
_COMM = ("link_bps and latency_s default to TPU v5e constants in JAX; the port "
         "states no link rate and takes them as required keywords")

#: callables whose positional parameters differ from JAX's on purpose
SIGNATURE_DIFFERENCES = {
    ("ops", "dfa_scan_fast"): _PALLAS,
    ("ops.dfa_fast", "dfa_scan_fast"): _PALLAS,
    ("ops", "dfa_scan_kgram"): _KGRAM,
    ("ops.kgram", "dfa_scan_kgram"): _KGRAM,
    ("ops.kgram", "kgram_pass_full"): _KGRAM,
    ("parallel", "make_mesh"): _MESH_DEVICES,
    ("parallel", "make_tp_mesh"): _MESH_DEVICES,
    ("parallel.mesh", "make_mesh"): _MESH_DEVICES,
    ("parallel.mesh", "make_tp_mesh"): _MESH_DEVICES,
    ("parallel.comm_model", "project_efficiency"): _COMM,
    ("parallel.comm_model", "min_shard_bytes_for_efficiency"): _COMM,
}


def _modules() -> list[str]:
    names = ["", "api", "re_compat"]
    for pkg in ("ops", "utils", "models", "parallel"):
        names.append(pkg)
        path = importlib.import_module(f"regex_fpga_tpu.{pkg}").__path__
        names += [f"{pkg}.{m.name}" for m in pkgutil.iter_modules(path)]
    return names


def _module(package: str, name: str):
    return importlib.import_module(package + (f".{name}" if name else ""))


def public_names(mod) -> list[str]:
    """``__all__`` and every top-level definition without a leading
    underscore (JAX's ``__all__`` lists leave some functions out)."""
    names = set(getattr(mod, "__all__", ()))
    for node in ast.parse(inspect.getsource(mod)).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets if isinstance(t, ast.Name))
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target, ast.Name):
            names.add(node.target.id)
    return sorted(n for n in names if not n.startswith("_"))


def positional(fn) -> list[str] | None:
    """The positional parameter names of ``fn``, or None without a
    signature (builtins)."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]


def signature_faults(jax_fn, port_fn) -> str | None:
    want = positional(jax_fn)
    if want is None:
        return None
    got = positional(port_fn)
    if got is None or got[:len(want)] != want:
        return f"JAX {want}, port {got}"
    return None


def surface_faults(name: str) -> list[str]:
    jax_mod = _module("regex_fpga_tpu", name)
    port_mod = _module("regex_fpga_tpu_torch", COUNTERPART.get(name, name))
    tpu_only = TPU_ONLY.get(name, {})
    faults = []
    for attr in public_names(jax_mod):
        if attr in tpu_only:
            assert not hasattr(port_mod, attr), f"{attr} is ported: drop it from TPU_ONLY"
            continue
        port_attr = RENAMES.get(name, {}).get(attr, attr)
        if not hasattr(port_mod, port_attr):
            faults.append(f"{name}.{attr}: missing")
            continue
        jv, tv = getattr(jax_mod, attr), getattr(port_mod, port_attr)
        if not callable(jv):
            continue
        fault = signature_faults(jv, tv)
        if (name, attr) in SIGNATURE_DIFFERENCES:
            assert fault, f"{name}.{attr} matches JAX: drop it from SIGNATURE_DIFFERENCES"
        elif fault:
            faults.append(f"{name}.{attr}: {fault}")
        if inspect.isclass(jv):
            for meth in sorted(vars(jv)):
                if meth.startswith("_"):
                    continue
                if not hasattr(tv, meth):
                    faults.append(f"{name}.{attr}.{meth}: missing")
                    continue
                jm, tm = getattr(jv, meth), getattr(tv, meth)
                if callable(jm) and not inspect.isclass(jm):
                    fault = signature_faults(jm, tm)
                    if fault:
                        faults.append(f"{name}.{attr}.{meth}: {fault}")
    return faults


MODULES = _modules()


@pytest.mark.parametrize("name", MODULES)
def test_port_surface_matches_jax(name):
    assert surface_faults(name) == []


def test_every_jax_module_is_covered():
    """Every module file of the JAX package is a case above, and the lists
    of exceptions name only modules and names that exist."""
    files = {m.name for m in pkgutil.walk_packages(regex_fpga_tpu.__path__,
                                                   "regex_fpga_tpu.")}
    covered = {f"regex_fpga_tpu.{m}" for m in MODULES if m}
    assert files - {"regex_fpga_tpu.__main__"} <= covered
    for name, names in TPU_ONLY.items():
        assert set(names) <= set(public_names(_module("regex_fpga_tpu", name)))
    renamed = [(name, attr) for name, names in RENAMES.items() for attr in names]
    for name, attr in renamed + list(SIGNATURE_DIFFERENCES):
        assert hasattr(_module("regex_fpga_tpu", name), attr)


def test_cli_module_matches_jax():
    """``python -m regex_fpga_tpu_torch`` has the JAX CLI's commands."""
    jax_main = _module("regex_fpga_tpu", "__main__")
    port_main = _module("regex_fpga_tpu_torch", "__main__")
    for attr in public_names(jax_main):
        assert hasattr(port_main, attr), attr
        if callable(getattr(jax_main, attr)):
            assert signature_faults(getattr(jax_main, attr),
                                    getattr(port_main, attr)) is None, attr
