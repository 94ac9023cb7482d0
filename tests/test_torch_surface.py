"""The port's public surface against the JAX package's, parameter by
parameter, from the source alone (``ast``; nothing is imported, JAX
least of all).

For every module of ``bbcat_dsp_tpu``, every public function, class and
method (``__init__`` included) has a counterpart of the same name in the
same module of ``bbcat_dsp_torch`` that takes each of its parameters by
the same name (the port may take more, such as its keyword-only
``device``).  The exceptions are one allowlist below, each with its
reason and the ROADMAP queue 3 entry that records it ("The port's surface
against the reference's"); a later test fails when an entry is no longer
needed, so the list stays the list of differences.
"""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
JAX_PKG, PORT_PKG = ROOT / "bbcat_dsp_tpu", ROOT / "bbcat_dsp_torch"

_Q3 = "ROADMAP queue 3, The port's surface against the reference's"
TPU = f"a TPU workaround, not ported (rule 3; {_Q3}: TPU workarounds)"
RENAMED = f"renamed on purpose ({_Q3}: deliberate renames)"

# modules the port does not have, by path under the package
MODULES = {
    "golden": "the float64 test oracle: the CPU tests import it from the "
              f"JAX package, chip_smoke.py re-derives it ({_Q3}: golden)",
    "ops/pallas": "the Pallas kernels: ported as csrc/ and ops/kernels/ "
                  f"({_Q3}: ops/pallas)",
    "ops_pallas_hook.py": "ported as ops_hook.py and ops/autograd.py "
                          f"({_Q3}: ops/pallas)",
    "utils/dwfloat.py": f"double-word float32; the card has float64. {TPU}",
    "utils/layouts.py": f"TPU layout pinning. {TPU}",
}

# parameters the port never takes, in any function
PARAMS = {
    "spec": f"the spectral layout (the standard one only). {TPU}",
    "spectral": f"the spectral layouts of an engine. {TPU}",
    "specs": f"the spectral layouts of both levels. {TPU}",
    "backend": f"the TPU's FFT backend registry. {TPU}",
    "precision": f"the MXU's matmul precision. {TPU}",
    "slot0": f"a static queue slot for the TPU compiler. {TPU}",
    "tail_slot0": f"a static queue slot for the TPU compiler. {TPU}",
    "migrate_layout": f"the permuted layout's state migration. {TPU}",
}

# names, or (name, parameter) pairs, of one module
NAMES = {
    ("convolve/fft.py", n): f"the permuted layout and the TPU's FFT. {TPU}"
    for n in ("set_precision", "half_engine_layout", "ensure_layout_usable",
              "resolve_spectral_spec", "half_sign_section", "half_sign_tail",
              "permute_half_spectrum", "unpermute_half_spectrum",
              "convert_perm_order", "default_backend", "register_backend",
              "backends")
}
NAMES.update({
    ("convolve/nonuniform.py", "nonuniform_render_pinned"):
        f"TPU layout pinning. {TPU}",
    ("filters/iir.py", "DWCoeffs"):
        f"double-word coefficients; the card has float64. {TPU}",
    ("parallel/mesh.py", "channel_sharding"):
        f"a JAX NamedSharding; shard_channels is its counterpart. {TPU}",
    ("formats/device.py", "quantize", "key"):
        f"a JAX PRNG key; the port takes a torch.Generator. {RENAMED}",
    ("parallel/comms.py", "collective_seconds", "hops_ici"):
        f"a TPU's ICI hops; the port counts NVLink hops. {RENAMED}",
    ("parallel/comms.py", "collective_seconds", "hops_dcn"):
        f"a TPU pod's DCN hops; the port counts InfiniBand hops. {RENAMED}",
    ("parallel/comms.py", "time_sharded_efficiency", "hops_dcn"):
        f"a TPU pod's DCN hops; the port counts InfiniBand hops. {RENAMED}",
})


def _params(fn) -> list:
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += [v.arg for v in (a.vararg, a.kwarg) if v is not None]
    return [n for n in names if n not in ("self", "cls")]


def surface(path: Path) -> dict:
    """Public top-level functions (their parameters), classes (None) and
    their public methods and ``__init__`` (``Class.method``)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            out[node.name] = _params(node)
        elif isinstance(node, ast.ClassDef) and not node.name.startswith("_"):
            out[node.name] = None
            for sub in node.body:
                if isinstance(sub, ast.FunctionDef) and (
                        not sub.name.startswith("_") or sub.name == "__init__"):
                    out[f"{node.name}.{sub.name}"] = _params(sub)
    return out


def _allowed_module(rel: str):
    return next((why for m, why in MODULES.items()
                 if rel == m or rel.startswith(m + "/")), None)


JAX_MODULES = sorted(str(p.relative_to(JAX_PKG))
                     for p in JAX_PKG.rglob("*.py"))


def gaps(rel: str) -> list:
    """What the port's module lacks of the JAX module ``rel``, each as
    ``(key, what)``; ``key`` is the allowlist entry that would cover it."""
    jax_s = surface(JAX_PKG / rel)
    port_path = PORT_PKG / rel
    port_s = surface(port_path) if port_path.exists() else None
    out = []
    for name, params in jax_s.items():
        if port_s is None or name not in port_s:
            out.append(((rel, name.split(".")[0]), f"{name} missing"))
        elif params is not None:
            for p in params:
                if p not in (port_s[name] or []):
                    key = (p if p in PARAMS and (rel, name, p) not in NAMES
                           else (rel, name, p))
                    out.append((key, f"{name}({p})"))
    return out


def _covered(key) -> bool:
    return key in PARAMS or key in NAMES


@pytest.mark.parametrize("rel", JAX_MODULES)
def test_the_port_takes_every_public_parameter(rel):
    why = _allowed_module(rel)
    if why is not None:
        assert not (PORT_PKG / rel).exists(), \
            f"{rel} is allowlisted as not ported ({why}) but exists"
        return
    assert (PORT_PKG / rel).exists(), f"no counterpart of {rel}"
    missing = [what for key, what in gaps(rel) if not _covered(key)]
    assert not missing, f"{rel}: the port lacks {missing}"


def test_every_allowlist_entry_is_still_needed():
    used = {key for rel in JAX_MODULES if _allowed_module(rel) is None
            for key, _ in gaps(rel)}
    assert set(PARAMS) <= used, set(PARAMS) - used
    assert set(NAMES) <= used, set(NAMES) - used
    for m in MODULES:
        assert any(r == m or r.startswith(m + "/") for r in JAX_MODULES), m
        assert not (PORT_PKG / m).exists(), m


def test_the_reference_keywords_of_the_mesh_reach_the_port():
    """``make_mesh(n_devices=...)`` and ``shard_channels(arr=...)``, as the
    reference names them (the keyword calls themselves run in
    ``tests/test_torch_parallel.py``)."""
    port = surface(PORT_PKG / "parallel" / "mesh.py")
    assert port["make_mesh"][0] == "n_devices"
    assert port["shard_channels"][0] == "arr"
