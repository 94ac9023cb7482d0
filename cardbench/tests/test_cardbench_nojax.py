"""Nothing the benchmark runs imports ``jax``, ``jaxlib``, ``flax`` or
``bbcat_dsp_tpu``, and the reference loads no module of
``bbcat_dsp_torch``.  An import hook in a fresh process refuses the
forbidden packages, compared by the part of a module's name before the
first dot, whole: ``bbcat_dsp_torch`` begins with ``bbcat_dsp_t`` too."""

import subprocess
import sys
import textwrap

from conftest import ROOT

HOOK = textwrap.dedent("""
    import sys

    FORBIDDEN = {forbidden!r}

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".", 1)[0] in FORBIDDEN:
                raise ImportError(f"forbidden import: {{name}}")
            return None

    sys.meta_path.insert(0, Refuse())
    sys.path.insert(0, {root!r})
""")


def _python(code: str, forbidden):
    src = HOOK.format(forbidden=set(forbidden), root=str(ROOT)) + code
    return subprocess.run([sys.executable, "-c", src], cwd=ROOT,
                          capture_output=True, text=True, timeout=300)


def test_every_module_of_the_benchmark_imports_without_jax():
    code = textwrap.dedent("""
        import importlib, json
        from pathlib import Path
        from cardbench.core import manifest
        bench = manifest.load()
        root = Path("cardbench")
        names = []
        for pkg in ("core", "drivers", "engines", "reference", "rooflines"):
            for p in sorted((root / pkg).glob("*.py")):
                mod = f"cardbench.{pkg}.{p.stem}".removesuffix(".__init__")
                importlib.import_module(mod)
                names.append(mod)
        for p in sorted((root / "metrics").glob("*.py")):
            bench.reader(p.stem)
            names.append(p.name)
        sys.path.insert(0, "cardbench")
        import run, control
        tops = {m.split(".", 1)[0] for m in sys.modules}
        print(json.dumps({"names": names, "tops": sorted(tops)}))
    """)
    p = _python(code, ("jax", "jaxlib", "flax", "bbcat_dsp_tpu"))
    assert p.returncode == 0, p.stderr
    import json

    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert "cardbench.engines.nonuniform" in out["names"]
    assert "cardbench.drivers.paced_blocks" in out["names"]
    assert "rtf.py" in out["names"]
    assert "bbcat_dsp_torch" in out["tops"]          # the program, allowed
    assert not {"jax", "jaxlib", "flax", "bbcat_dsp_tpu"} & set(out["tops"])


def test_the_hook_refuses_a_forbidden_import():
    p = _python("import jax.numpy\n", ("jax",))
    assert p.returncode != 0 and "forbidden import: jax" in p.stderr


def test_the_reference_loads_nothing_of_the_program():
    code = textwrap.dedent("""
        import cardbench.reference.nonuniform
        import cardbench.core.verdict
        tops = {m.split(".", 1)[0] for m in sys.modules}
        assert "bbcat_dsp_torch" not in tops, sorted(tops)
        print("ok")
    """)
    p = _python(code, ("jax", "jaxlib", "flax", "bbcat_dsp_tpu",
                       "bbcat_dsp_torch"))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip() == "ok"
