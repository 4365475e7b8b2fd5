"""Regenerate docs/API.md: one line per public symbol.

Usage:  python tools/gen_api.py > docs/API.md
(run from the repo root; CPU backend is fine).
"""
import importlib
import inspect

SECTIONS = [
    ("sdr_tpu.ops", "Pure DSP ops (offline kernels)"),
    ("sdr_tpu.stream", "Streaming operators + pipelines"),
    ("sdr_tpu.parallel", "Sharded execution over device meshes"),
    ("sdr_tpu.io", "Host I/O sources and sinks"),
    ("sdr_tpu.apps.chains", "Canonical receive chains (BASELINE configs)"),
    ("sdr_tpu.utils", "Device dispatch, profiling, roofline, args"),
    ("sdr_tpu.kernels", "Pallas GPU kernels, Triton route (the L0 layer)"),
]


def one_line(obj) -> str:
    doc = inspect.getdoc(obj) or ""
    line = doc.splitlines()[0] if doc else ""
    return line.replace("|", "\\|")


def main():
    print("# sdr_tpu public API\n")
    print("One line per public symbol (`module.__all__` or exported"
          " names);\nsee docstrings for full contracts.  Regenerate with"
          " `python tools/gen_api.py > docs/API.md`.\n")
    for modname, title in SECTIONS:
        mod = importlib.import_module(modname)
        names = sorted(getattr(mod, "__all__", None)
                       or [n for n in dir(mod) if not n.startswith("_")])
        print(f"## `{modname}` — {title}\n")
        print("| symbol | summary |")
        print("|---|---|")
        for n in names:
            obj = getattr(mod, n, None)
            if obj is None:
                continue
            kind = ("class" if inspect.isclass(obj)
                    else "fn" if callable(obj) else "const")
            print(f"| `{n}` ({kind}) | {one_line(obj)} |")
        print()


if __name__ == "__main__":
    main()
