"""The JAX package's digits quality record, for the port's gates.

Runs ``benchmarks/real_digits.py``'s ``main`` on the CPU and writes what it
prints to ``torchdr_tpu_torch/benchmarks/real_digits_reference.json``: the
dataset line, each estimator's quality readings and scikit-learn's t-SNE
line, without their seconds (CPU seconds say nothing of the card), with the
versions of jax and scikit-learn that made them.

    JAX_PLATFORMS=cpu python tests/_real_digits_reference.py [--print]

``--print`` prints the record instead of writing the file.
"""

import contextlib
import io
import json
import os
import pathlib
import runpy
import sys
import time

os.environ.setdefault("TORCHDR_TPU_NO_COMPILE_CACHE", "1")

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "torchdr_tpu_torch" / "benchmarks" / "real_digits_reference.json"
SECONDS = ("cold_s", "warm_s")


def record() -> dict:
    import sklearn

    buf = io.StringIO()
    t0 = time.perf_counter()
    script = runpy.run_path(str(ROOT / "benchmarks" / "real_digits.py"), run_name="jax_digits")
    with contextlib.redirect_stdout(buf):
        script["main"]()
    print(f"JAX script: {time.perf_counter() - t0:.1f} s on the CPU", file=sys.stderr)
    lines = [json.loads(line[len("JSON "):]) for line in buf.getvalue().splitlines()
             if line.startswith("JSON ")]
    (dataset,) = [line for line in lines if line["step"] == "dataset"]
    fits = {line["model"]: {k: v for k, v in line.items() if k not in ("step", "model", *SECONDS)}
            for line in lines if line["step"] == "fit"}
    return {"recorded": "cpu", "jax": jax.__version__, "sklearn": sklearn.__version__,
            "command": "JAX_PLATFORMS=cpu python benchmarks/real_digits.py",
            "dataset": {k: v for k, v in dataset.items() if k != "step"}, "fits": fits}


def main() -> None:
    rec = record()
    text = json.dumps(rec, indent=1) + "\n"
    if "--print" in sys.argv[1:]:
        print(text, end="")
    else:
        OUT.write_text(text)
        print(f"wrote {OUT.relative_to(ROOT)}", file=sys.stderr)


if __name__ == "__main__":
    main()
