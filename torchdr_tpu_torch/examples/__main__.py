"""Run every script of the gallery, each in a fresh process, as living
tests (counterpart of ``scripts/run_examples.py``).

    python -m torchdr_tpu_torch.examples [--fast] [--match SUBSTR] [--timeout S]
                                         [--device cpu]

``--fast`` shrinks the dataset-sized scripts as the JAX runner does;
``--device`` is passed to every script (default: none, so each runs on the
card). Exits 1 if any script fails or outlives ``--timeout``.
"""

import argparse
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))

# extra argv per script in --fast mode (the JAX runner's sizes; scripts
# without a size flag are already toy-scale)
FAST_ARGS = {
    "single_cell/single_cell.py": ["--n", "3000"],
    "distributed/distributed_umap.py": ["--n", "1024"],
}


def find_examples():
    """The scripts' paths under this package, as ``folder/name.py``."""
    out = []
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py") and not f.startswith("_"):
                out.append(os.path.relpath(os.path.join(dirpath, f), HERE).replace(os.sep, "/"))
    return sorted(p for p in out if "/" in p)


def module_name(rel: str) -> str:
    return "torchdr_tpu_torch.examples." + rel[: -len(".py")].replace("/", ".")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="Run the examples gallery.")
    ap.add_argument("--fast", action="store_true", help="toy-scale args")
    ap.add_argument("--match", default="", help="only paths containing this")
    ap.add_argument("--timeout", type=int, default=900)
    ap.add_argument("--device", default=None, help="passed to every script")
    args = ap.parse_args(argv)

    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")

    failures = []
    examples = [e for e in find_examples() if args.match in e]
    for rel in examples:
        argv_ = [sys.executable, "-m", module_name(rel)]
        if args.fast:
            argv_ += FAST_ARGS.get(rel, [])
        if args.device is not None:
            argv_ += ["--device", args.device]
        t0 = time.time()
        try:
            proc = subprocess.run(argv_, env=env, cwd=ROOT, capture_output=True, text=True,
                                  timeout=args.timeout)
            code, out, err = proc.returncode, proc.stdout, proc.stderr
        except subprocess.TimeoutExpired as e:
            code, out, err = "timeout", e.stdout or "", e.stderr or ""
            out, err = (s.decode() if isinstance(s, bytes) else s for s in (out, err))
        status = "ok" if code == 0 else f"FAIL({code})"
        print(f"[examples] {rel}: {status} in {time.time() - t0:.1f}s", flush=True)
        if code != 0:
            failures.append(rel)
            sys.stderr.write(out[-1500:] + "\n" + err[-3000:] + "\n")

    print(f"[examples] {len(examples) - len(failures)}/{len(examples)} passed", flush=True)
    if failures:
        print("[examples] failed: " + ", ".join(failures), flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
