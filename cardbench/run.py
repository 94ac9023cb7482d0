"""The benchmark of ``bbcat_dsp_torch`` on one NVIDIA H100: one cell, one
run.

    python3 cardbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  ``<name>`` is a ``workloads`` entry of
``BENCHMARK.json``.  The run makes its IRs and signals on the card from
``--seed``, builds the engine, warms up every shape the cell's traffic
uses (all of that is ``setup_s``), measures for ``--seconds``, then
compares a sample of the outputs the window produced with the plain
float64 reference (``reference/``).  The last line of standard output is
one JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``:
each number compared beside its limit); the same checks are the last lines
of standard error.  With ``--trace 0`` the metrics are the cell's
end-to-end ones; with ``--trace 1`` its per-layer ones, read from one
bounded slice of the window that ``torch.profiler`` traces.

Without a CUDA card, with fewer cards than the cell asks for, or when
``jax``, ``jaxlib``, ``flax`` or ``bbcat_dsp_tpu`` is loaded once the
window has closed, it exits nonzero and prints no result.

Files: the program's kernels build into ``bbcat_dsp_torch/_build/`` and
any PyTorch extension or Triton cache goes to ``.cardbench_cache/``, both
inside the checkout and at fixed paths; the trace slice's chrome trace is
a temporary file in ``TMPDIR``, deleted once read.  Nothing is written to
``/dev/shm`` or to a fixed ``/tmp`` path.

Adding to the benchmark is adding files and entries in ``BENCHMARK.json``:
a configuration is ``configs/<name>.json`` (its ``engine`` names
``engines/<engine>.py`` and ``reference/<engine>.py``, whose contracts
their packages' docstrings give); a traffic mix is
``traffic/<name>.json`` (its ``driver`` names ``drivers/<driver>.py``);
a metric is read by ``metrics/<name>.py`` with ``read(ctx)``, or by the
file of its name's longest dotted prefix (``rtf.<config>`` by
``metrics/rtf.py``); a kernel's device time goes to the function that
``kernels/<kernel>.json`` names, and a function's least time is
``rooflines/<function>.py``.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "bbcat_dsp_tpu")


def forbidden_loaded() -> list[str]:
    """The forbidden top-level packages in ``sys.modules``, compared by
    whole top-level name."""
    tops = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(tops.intersection(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / ".cardbench_cache"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(cache / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(cache / "triton"))
    sys.path.insert(0, str(ROOT))

    import torch

    from cardbench.core import manifest

    bench = manifest.load(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cardbench: {args.workload} needs {chips} CUDA card(s), "
              f"found {found}; no result", file=sys.stderr)
        return 2
    torch.set_num_threads(1)

    from cardbench.core.cell import run_cell

    def log(line):
        print(line, file=sys.stderr, flush=True)

    result, checks, _ = run_cell(bench, args.workload, args.seed,
                                 args.seconds, bool(args.trace),
                                 device="cuda:0", t_process=T_PROCESS,
                                 log=log)
    bad = forbidden_loaded()
    if bad:
        log(f"cardbench: loaded in this process: {bad}; no result")
        return 3
    result["checks"] = checks.as_json()
    for line in checks.lines():
        log(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
