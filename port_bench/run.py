"""Run one cell of the port's benchmark once, on the card this process sees.

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``,
with ``--trace 1`` a ``breakdown``, and last ``checks``: each number the
correctness check compared, beside its limit.  The same numbers end
standard error.  Exits 2, printing no result, without a CUDA card (or with
fewer cards than the cell asks for), without the program under ``src/``,
or where JAX or the reference package got loaded into this process.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import NoReturn  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# every build and kernel cache at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("CUDA_CACHE_PATH", "cuda_cache")):
    os.environ[var] = str(ROOT / "build" / "port_bench" / sub)
os.environ["USE_FLAX"] = "0"
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def fail(msg: str) -> NoReturn:
    print(f"port_bench: {msg}", file=sys.stderr, flush=True)
    sys.exit(2)


def loaded_forbidden() -> list[str]:
    return sorted({name.split(".", 1)[0] for name in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    if not (ROOT / "src" / "repro_torch").is_dir():
        fail("the program (src/repro_torch) is not in this checkout")
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(HERE))
    import torch

    from pbench import cell

    spec = cell.spec(ROOT)
    try:
        chips = cell.find(spec["workloads"], args.workload)["chips"]
    except KeyError:
        fail(f"no cell named {args.workload!r} in BENCHMARK.json")
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        fail(f"the cell needs {chips} CUDA card(s); this process sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    log = lambda msg: print(msg, file=sys.stderr, flush=True)  # noqa: E731
    log(f"port_bench: {torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} card(s), "
        f"{cell.power_limit()}; torch {torch.__version__} cuda {torch.version.cuda}")
    out = cell.run(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                   t_start=T_START, log=log)
    found = loaded_forbidden()
    if found:
        fail(f"modules loaded that the run may not load: {found}")
    for name, c in out["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
