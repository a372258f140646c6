"""The benchmark of neuman_tpu_torch: one run of one cell.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Reads BENCHMARK.json at the root of the checkout, and the cell's
configuration (benchmark/configs/<config>.json) and traffic mix
(benchmark/traffic/<traffic>.json) by the names the manifest gives. Then:
make the inputs from the seed on the device and warm up the cell's shapes
(set-up), measure whole steps or frames until `--seconds` have passed,
check the timed path's outputs against the plain reference, and print one
JSON line last on standard output.

--trace 0 reports the cell's end-to-end metrics: the set-up time
(`setup_s`, from process start to the first timed unit) and the window's
time per step or per frame. --trace 1 reports its per-layer metrics: the
window is measured as in --trace 0 (the step or frame time the MFU reads,
the batch draws by CUDA events, the peak memory), then `trace_units` more
units are traced with torch.profiler, and each metric's reader
(benchmark/metrics/<name>.py) takes its number from them.

Exits non-zero, printing no result, without CUDA or with fewer cards than
the cell asks for, when the program cannot be imported, or when jax,
jaxlib, flax, optax or the JAX package neuman_tpu is loaded once the window
has closed. `--device cpu` (the CPU tests only) runs the plain versions on
the CPU and reports platform "cpu".
"""

import time

START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "neuman_tpu")


def caches():
    """Every build and kernel cache inside the checkout, at fixed paths;
    the program keeps its kernel libraries in neuman_tpu_torch/_build/."""
    base = os.path.join(ROOT, "benchmark", "_cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = os.path.join(base, sub)
    os.environ.setdefault("USE_FLAX", "0")


def forbidden_modules(names=None):
    """The loaded modules (or `names`) of JAX or the JAX package, by whole
    top-level name: neuman_tpu_torch is not neuman_tpu."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


def load_manifest(root=ROOT):
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        return json.load(f)


def find_cell(manifest, name, bench=BENCH):
    """(cell, configuration file, traffic file) of cell `name`."""
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    cell = cells[name]
    config = {c["name"]: c for c in manifest["configs"]}[cell["config"]]
    with open(os.path.join(os.path.dirname(bench), config["file"])) as f:
        cfg = json.load(f)
    with open(os.path.join(bench, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    return cell, cfg, traffic


def metric_reader(name, bench=BENCH):
    """The `read(ctx)` of benchmark/metrics/<name>.py."""
    path = os.path.join(bench, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location("benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--device", default="cuda", help=argparse.SUPPRESS)
    return p.parse_args(argv)


def run(args, manifest, cell, cfg, traffic, bench=BENCH):
    """One run: returns (the result line's dict, the numbers compared);
    `bench` is the folder whose metrics/ holds the readers."""
    import torch

    from benchmark import cells, trace

    device = torch.device(args.device)
    cuda = device.type == "cuda"
    if cuda and (not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]):
        raise SystemExit(f"the cell needs {cell['chips']} CUDA device(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
    # one host thread: the steps and frames are launch-bound, and idle
    # worker threads that spin take the cores the launching thread needs
    torch.set_num_threads(1)
    runner = cells.KINDS[traffic["kind"]](cfg, traffic, args.seed, device)
    sync = (lambda: torch.cuda.synchronize(device)) if cuda else (lambda: None)
    sync()
    # the set-up's objects leave the collector's generations: a collection
    # in the window scans what the window makes, not the inputs and nets
    gc.collect()
    gc.freeze()
    setup_s = time.perf_counter() - START
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    draws = [] if (args.trace and cuda and runner.unit_name == "step") else None
    t0 = time.perf_counter()
    ends = []
    while True:
        runner.unit(draws)
        ends.append(time.perf_counter())
        if ends[-1] - t0 >= args.seconds:
            break
    sync()
    window_s = time.perf_counter() - t0
    units = len(ends)
    runner.finish_window()
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    peak = max(peak, window_peak)
    unit_s = window_s / units
    metrics, breakdown, dev_extra = {}, None, {}
    if args.trace:
        prof = trace.profile(runner, traffic["trace_units"], device)
        hits = runner.trace_hits() if hasattr(runner, "trace_hits") else None
        ctx = trace.context(runner, prof, unit_s, draws, window_peak, hits)
        for m in manifest["per_layer"]:
            if cell["name"] in m.get("workloads", [cell["name"]]):
                value = metric_reader(m["name"], bench)(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = prof.breakdown()
        dev_extra = {"busy_s": prof.busy_s, "window_s": prof.window_s}
    else:
        per_unit = {"train_step_ms": unit_s * 1e3, "frame_s": unit_s}
        for m in manifest["end_to_end"]:
            if cell["name"] not in m.get("workloads", [cell["name"]]):
                continue
            value = setup_s if m["name"] == "setup_s" else per_unit.get(m["name"])
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    each = sorted(1e3 * (b - a) for a, b in zip([t0] + ends, ends))
    pick = lambda q: each[min(len(each) - 1, int(q * len(each)))]
    print(f"{cell['name']}: {units} {runner.unit_name}s in {window_s:.3f} s (host ms a unit: min "
          f"{each[0]:.1f}, p10 {pick(0.1):.1f}, p50 {pick(0.5):.1f}, p90 {pick(0.9):.1f}, max "
          f"{each[-1]:.1f}); {runner.restarts} dead-net restarts in set-up and window", file=sys.stderr)
    t_check = time.perf_counter()
    numbers = runner.check()
    left = ""
    if hasattr(runner, "unsettled"):
        left = f"; {runner.unsettled} rays whose hit test f32 cannot settle left out"
    print(f"{cell['name']}: the check took {time.perf_counter() - t_check:.3f} s{left}", file=sys.stderr)
    limits = traffic["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits) and not runner.failed
    result = {"correct": bool(correct), "attempted": units, "failed": runner.failed, "metrics": metrics,
              "device": {"platform": "gpu" if cuda else "cpu",
                         "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                         "count": cell["chips"] if cuda else 1, "memory_peak_bytes": int(peak), **dev_extra}}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {k: {"value": numbers[k], "limit": limits[k]} for k in limits}
    return result, numbers


def emit(result):
    """The numbers compared, beside their limits, as the last lines on
    standard error; the result as the last line on standard output."""
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)


def main(argv=None):
    caches()
    args = parse_args(argv)
    manifest = load_manifest()
    cell, cfg, traffic = find_cell(manifest, args.workload)
    result, _ = run(args, manifest, cell, cfg, traffic)
    bad = forbidden_modules()
    if bad:
        print(f"modules of JAX or the JAX package are loaded: {', '.join(bad)}", file=sys.stderr)
        return 3
    emit(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
