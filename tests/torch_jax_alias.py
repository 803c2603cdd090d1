"""Run the JAX package's own test files, unchanged, against the port.

A helper of ``tests/test_torch_jax_suite_*.py`` (not collected: its name
does not start with ``test_``). ``run_suite`` starts one subprocess that

- puts a ``sys.meta_path`` finder first, which answers every import of
  ``regex_fpga_tpu`` and of its submodules with the port's module of the
  same name (``regex_fpga_tpu_torch``); a JAX module that the port does not
  have fails to import instead of falling through to the JAX package;
- makes the CPU the default device of the run: ``ops.tables.resolve_device``
  is wrapped wherever a port module bound it by name (``None`` -> ``"cpu"``),
  the CLI's ``main`` gets ``--device cpu`` in front of its arguments, and a
  ``python -m regex_fpga_tpu ...`` subprocess that a test starts runs the
  port's CLI with the same hook. The package itself gains nothing for this;
- runs ``pytest`` on the listed files with ``-p no:xdist -p no:cacheprovider
  -p no:randomly -m 'not slow'`` and a JUnit XML report, deselecting the
  tests a caller names. ``tests/conftest.py`` loads as it is, and its
  imports of ``regex_fpga_tpu`` get the port's copies.

``check_suite`` then holds every collected test to "passed", except the
entries of the caller's table of expected failures, each with a class and a
one-line reason. The table is strict: an entry that passes, or that no
longer exists, fails the check, so the table can only shrink.

The JAX test files that feed JAX arrays or meshes to the functions under
test stay out of the suites (``test_dfa_fast``, ``test_kgram``,
``test_dfa_engine``, ``test_nfa_engine``, ``test_batch_scan``,
``test_dist*``, ``test_tp_scan``, ``test_comm_model``,
``test_multi_ruleset``, ``test_pallas_dfa``), and so does ``test_router``,
which imports a TPU-only constant at module level. The port's own
``test_torch_*`` files hold each of those modules to JAX function by
function.
"""

from __future__ import annotations

import importlib
import importlib.abc
import importlib.machinery
import os
import subprocess
import sys
import xml.etree.ElementTree as ET

JAX_PACKAGE = "regex_fpga_tpu"
PORT_PACKAGE = "regex_fpga_tpu_torch"
TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TESTS_DIR)

#: the classes of the expected-failure table
CLASSES = {
    "private": "calls a private method, or reads the tuple of one",
    "jax-input": "passes JAX arrays or a JAX device in",
    "deliberate": "a difference named in ROADMAP.md section 3",
    "tpu-only": "needs a name or a parameter that only the TPU build has",
    "fixture": "needs the reference fixtures without the fixture's guard",
    "cpu-speed": "a JAX timing limit that the port's plain CPU path cannot meet",
}


#: JAX names that the port exports under another name, by module (the
#: renames of ROADMAP.md section 3); the hook answers the JAX name too
RENAMES = {"ops": {"nfa_scan_jax": "nfa_scan"},
           "ops.nfa_engine": {"nfa_scan_jax": "nfa_scan"}}


def _is_aliased(fullname: str) -> bool:
    return fullname == JAX_PACKAGE or fullname.startswith(JAX_PACKAGE + ".")


class _AliasLoader(importlib.abc.Loader):
    """Hands out the port's module itself, already imported."""

    def __init__(self, module):
        self.module = module
        self.own_spec = module.__spec__

    def create_module(self, spec):
        return self.module

    def exec_module(self, module):
        # the import system has just set the alias's spec on the port's
        # module; give the module its own back
        module.__spec__ = self.own_spec


class AliasFinder(importlib.abc.MetaPathFinder):
    """``regex_fpga_tpu[.x]`` -> ``regex_fpga_tpu_torch[.x]``."""

    def find_spec(self, fullname, path=None, target=None):
        if not _is_aliased(fullname):
            return None
        name = PORT_PACKAGE + fullname[len(JAX_PACKAGE):]
        try:
            module = importlib.import_module(name)
        except ModuleNotFoundError as err:
            if err.name != name:
                raise
            raise ModuleNotFoundError(
                f"{fullname} has no counterpart {name} in the port",
                name=fullname) from None
        for jax_name, port_name in RENAMES.get(fullname[len(JAX_PACKAGE) + 1:],
                                               {}).items():
            setattr(module, jax_name, getattr(module, port_name))
        spec = importlib.machinery.ModuleSpec(
            fullname, _AliasLoader(module),
            is_package=hasattr(module, "__path__"))
        if hasattr(module, "__path__"):
            spec.submodule_search_locations = list(module.__path__)
        return spec


def _cpu_default() -> None:
    """The CPU as the default device of this process."""
    import pkgutil

    port = importlib.import_module(PORT_PACKAGE)
    tables = importlib.import_module(PORT_PACKAGE + ".ops.tables")
    original = tables.resolve_device

    def resolve_device(device=None):
        return original("cpu" if device is None else device)

    for info in pkgutil.walk_packages(port.__path__, PORT_PACKAGE + "."):
        module = importlib.import_module(info.name)
        if getattr(module, "resolve_device", None) is original:
            module.resolve_device = resolve_device
    cli = importlib.import_module(PORT_PACKAGE + ".__main__")
    cli.main = _cpu_main(cli.main)


def _cpu_main(main):
    def cpu_main(argv=None):
        argv = sys.argv[1:] if argv is None else list(argv)
        return main(["--device", "cpu", *argv])
    return cpu_main


_BOOT = ("import sys; sys.path[:0] = [{root!r}, {tests!r}]; "
         "import torch_jax_alias as a; a.install(); ")


def _boot(then: str) -> str:
    return _BOOT.format(root=ROOT, tests=TESTS_DIR) + then


class _AliasPopen(subprocess.Popen):
    """``python -m regex_fpga_tpu ARGS`` runs the port's CLI under the hook."""

    def __init__(self, args, *rest, **kw):
        if (isinstance(args, (list, tuple)) and len(args) >= 3
                and args[1] == "-m" and args[2] == JAX_PACKAGE):
            args = [args[0], "-c",
                    _boot("sys.exit(a.port_cli(sys.argv[1:]))"), *args[3:]]
        super().__init__(args, *rest, **kw)


def jax_modules_loaded() -> list[str]:
    """Modules of the JAX package itself in ``sys.modules``: none, when
    every import went to the port."""
    return sorted(n for n, m in list(sys.modules.items()) if _is_aliased(n)
                  and not getattr(m, "__name__", "").startswith(PORT_PACKAGE))


def port_cli(argv) -> int:
    return importlib.import_module(PORT_PACKAGE + ".__main__").main(argv)


def install() -> None:
    """Put the alias finder first and make the CPU the default device, in
    this process and in the CLI subprocesses it starts."""
    if not any(isinstance(f, AliasFinder) for f in sys.meta_path):
        sys.meta_path.insert(0, AliasFinder())
    _cpu_default()
    subprocess.Popen = _AliasPopen


def case_id(case: ET.Element) -> str:
    """``test_api.py::test_x[param]`` (``::Class::`` for a class's tests;
    ``test_api.py`` alone for a file that failed to collect)."""
    parts = (case.get("classname") or case.get("name", "")).split(".")
    if not case.get("classname"):
        return (parts[-1] + ".py") if parts else ""
    if parts and parts[0] == "tests":
        parts = parts[1:]
    path = parts[0] + ".py" if parts else ""
    return "::".join([path, *parts[1:], case.get("name", "")])


def run_suite(files: list[str], deselect: list[str], xml_path: str,
              timeout: float = 300) -> tuple[dict, str]:
    """Run the JAX test ``files`` (names in ``tests/``) against the port in
    one subprocess. Returns ({test id: (outcome, message)}, the output)."""
    args = ["-q", "-p", "no:xdist", "-p", "no:cacheprovider", "-p", "no:randomly",
            "-m", "not slow", "--continue-on-collection-errors", "-o", "addopts=", "--junitxml", xml_path,
            "-W", "ignore::DeprecationWarning"]
    for test in deselect:
        args += ["--deselect", f"tests/{test}"]
    args += [f"tests/{f}" for f in files]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-c",
         _boot("import pytest; rc = pytest.main(sys.argv[1:]); "
               "print('JAX package modules loaded:', a.jax_modules_loaded()); "
               "sys.exit(rc)"), *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)
    out = proc.stdout + proc.stderr
    if "JAX package modules loaded: []" not in out:
        raise AssertionError("the JAX package itself was imported:\n" + out[-4000:])
    if not os.path.exists(xml_path):
        raise AssertionError(f"pytest wrote no report (exit {proc.returncode}):\n"
                             + out[-4000:])
    results = {}
    for case in ET.parse(xml_path).getroot().iter("testcase"):
        outcome, message = "passed", ""
        for child in case:
            if child.tag in ("failure", "error", "skipped"):
                outcome = "skipped" if child.tag == "skipped" else "failed"
                message = (child.get("message") or child.text or "").strip()
                break
        results[case_id(case)] = (outcome, message.splitlines()[0][:300]
                                  if message else "")
    return results, out


#: why the JAX suites may skip a test under the port as they do under JAX
ALLOWED_SKIPS = ("reference fixtures not available",)


def check_suite(files: list[str], expected: dict, xml_path: str,
                timeout: float = 300) -> dict:
    """Run ``files`` and hold every test to "passed", except ``expected``:
    {test id: (class, reason)}; ``cpu-speed`` entries are deselected, every
    other entry must fail. Returns the results."""
    for test, (cls, reason) in expected.items():
        assert cls in CLASSES and reason, (test, cls, reason)
    deselect = [t for t, (cls, _) in expected.items() if cls == "cpu-speed"]
    results, out = run_suite(files, deselect, xml_path, timeout)
    faults = []
    for f in files:
        if not any(t.startswith(f + "::") for t in results):
            faults.append(f"{f}: no test ran")
    for test, (outcome, message) in sorted(results.items()):
        want_fail = test in expected
        if outcome == "skipped":
            if want_fail or not any(r in message for r in ALLOWED_SKIPS):
                faults.append(f"{test}: skipped ({message})")
        elif outcome == "failed" and not want_fail:
            faults.append(f"{test}: {message}")
        elif outcome == "passed" and want_fail:
            faults.append(f"{test}: passes: drop its entry ({expected[test][0]})")
    for test, (cls, _) in expected.items():
        if cls != "cpu-speed" and test not in results:
            faults.append(f"{test}: in the table but not collected")
        if cls == "cpu-speed" and test in results:
            faults.append(f"{test}: cpu-speed entry ran")
    assert not faults, "\n".join(faults) + "\n\n" + out[-3000:]
    return results
