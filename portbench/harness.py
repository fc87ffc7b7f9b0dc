"""One run of one cell: find the cell's pieces by name, run the system,
judge its output with the reference, read the metrics and print the
result line.

Everything is found by the names in `BENCHMARK.json`, so a cell, a
configuration, a traffic mix or a metric is added as files of its own:
  * the cell (`workloads`) names a configuration and a mix;
  * the configuration's file (`configs[].file`) names its system, a
    module `portbench/systems/<system>.py` with
    `run(config, traffic, seed, seconds, trace, device, hook)`;
  * the mix is `portbench/traffic/<traffic>.json`, with
    `portbench/traffic/<traffic>.py` beside it where the mix needs code
    (its order, arrivals or end: `inputs.Mix`);
  * each metric is `portbench/metrics/<name>.py`, whose `read(run)`
    returns its number, or None when the run gave it nothing to read
    (the metric is then left out of the line).
With `--trace 0` the line holds the cell's end-to-end metrics, with
`--trace 1` its per-layer ones (a metric's `workloads`, where given,
lists the cells it is read in).

The window's output is judged after the window by `reference/check.py`
in a process of its own (plain Python; no torch, no port). The numbers it
compares are printed beside their limits as the last lines of standard
error and under "compared", the result line's last key."""

import importlib
import importlib.util
import json
import os
import subprocess
import sys
from types import SimpleNamespace

# modules that must not be loaded in the process that prints the result:
# the JAX stack and the JAX package (top-level names, compared whole)
FORBIDDEN = ("jax", "jaxlib", "flax", "zprize_tpu")
REFERENCE_TIMEOUT_S = 240

# the numbers the reference's verdict gives, each with its limit
LIMITS = {"rejected_proofs": 0}


class Bench:
    """`BENCHMARK.json` at `root`, and the files it names."""

    def __init__(self, root):
        self.root = root
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.spec = json.load(f)

    def cell(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name):
        for c in self.spec["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name):
        """The mix `name` (`inputs.Mix`)."""
        from .inputs import load_mix
        return load_mix(os.path.join(self.root, "portbench", "traffic"),
                        name)

    def metrics(self, cell, traced):
        """The metric entries that `cell` reports in this kind of run."""
        kind = "per_layer" if traced else "end_to_end"
        return [m for m in self.spec[kind]
                if cell in m.get("workloads", [cell])]

    def reader(self, name):
        path = os.path.join(self.root, "portbench", "metrics", name + ".py")
        spec = importlib.util.spec_from_file_location(
            "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
            path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def forbidden_modules():
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def judge(root, config, traffic, seed, proofs):
    """The reference's verdict on `proofs` ([[witness, hex], ...])."""
    job = {"height": config["height"], "seed": seed,
           "witnesses": traffic["witnesses"], "proofs": proofs}
    env = dict(os.environ, OPENBLAS_NUM_THREADS="1", OMP_NUM_THREADS="1",
               MKL_NUM_THREADS="1")
    p = subprocess.run([sys.executable, "-m", "portbench.reference.check"],
                       input=json.dumps(job), capture_output=True, text=True,
                       cwd=root, env=env, timeout=REFERENCE_TIMEOUT_S)
    if p.returncode != 0:
        sys.stderr.write(p.stderr[-4000:])
        raise RuntimeError(f"the reference exited with {p.returncode}")
    return json.loads(p.stdout.strip().splitlines()[-1])


def run_cell(root, workload, seed, seconds, trace, t_start, device="cuda",
             hook=None):
    """Run `workload` once and return (result line dict, the run, the
    verdict). On a card the metrics are the cell's; a rehearsal on the
    CPU (`device="cpu"`) reads none: its times are not the card's."""
    bench = Bench(root)
    cell = bench.cell(workload)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    system = importlib.import_module("portbench.systems." + config["system"])
    out = system.run(config, traffic, seed, seconds, trace, device, hook)
    on_card = None not in out["peak_bytes"]
    run = SimpleNamespace(
        chips=cell["chips"], setup_s=out["window_t0"] - t_start,
        window_s=out["window_s"], proofs=len(out["proofs"][0]),
        requests=out["requests"],
        peak_bytes=max(out["peak_bytes"]) if on_card else None,
        resident_bytes=max(out["resident_bytes"]) if on_card else None,
        busy_s=out["busy_s"], traced_s=out["traced_s"], trace=out["trace"],
        forbidden={r: found for r, found in enumerate(out["forbidden"])
                   if found})
    every = [p for rank in out["proofs"] for p in rank]
    verdict = judge(root, config, traffic, seed, every)
    ok = verdict.pop("ok")
    # a proof of the window failed when any rank's bytes of it are rejected
    failed = sum(not all(ok[r * run.proofs + i]
                         for r in range(len(out["proofs"])))
                 for i in range(run.proofs))
    compared = {"rejected_proofs": verdict["rejected"]}
    metrics = {}
    if device == "cuda":
        for m in bench.metrics(workload, trace):
            value = bench.reader(m["name"]).read(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": all(compared[k] <= LIMITS[k] for k in LIMITS)
            and run.proofs > 0,
            "attempted": run.proofs, "failed": failed,
            "metrics": metrics, "device": device_info(device, run, trace)}
    if trace and run.trace is not None and run.trace.marks:
        from .trace import device_ops, idle_gaps
        line["breakdown"] = {"device_ops": device_ops(run.trace),
                             "idle_gaps": idle_gaps(run.trace)}
    line["compared"] = {k: {"value": v, "limit": LIMITS[k]}
                        for k, v in compared.items()}
    return line, run, verdict


def device_info(device, run, trace):
    if device != "cuda":
        return {"platform": "cpu", "count": run.chips}
    import torch
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": run.chips, "memory_peak_bytes": run.peak_bytes,
            "power_limit": power_limit()}
    if trace:
        # each card's union of program intervals inside its traced
        # proofs, and the proofs' length, averaged over the cards
        busy = [b for b in run.busy_s if b is not None]
        info["busy_s"] = sum(busy) / len(busy) if busy else None
        traced = [w for w in run.traced_s if w is not None]
        info["window_s"] = sum(traced) / len(traced) if traced else None
    return info


def power_limit():
    """`nvidia-smi`'s name and power limit of the run's cards."""
    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi failed: {e}"
    return sorted(set(p.stdout.strip().splitlines()))


def main(argv, t_start, root):
    import argparse
    ap = argparse.ArgumentParser(
        description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    chips = Bench(root).cell(args.workload)["chips"]
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"this machine has {have}", file=sys.stderr)
        return 2
    line, run, verdict = run_cell(root, args.workload, args.seed,
                                  args.seconds, bool(args.trace), t_start)
    return report(line, run, verdict)


def report(line, run, verdict):
    """Print the run's result, or refuse it (exit code 3, no line) where
    this process or a rank's had loaded a forbidden module by the
    window's close."""
    found = dict(run.forbidden)
    if forbidden_modules():
        found["the harness"] = forbidden_modules()
    if found:
        for where, names in found.items():
            where = where if isinstance(where, str) else f"rank {where}"
            print(f"portbench: {where} loaded {', '.join(names)}",
                  file=sys.stderr)
        return 3
    if run.trace is not None:
        for note in run.trace.notes:
            print(f"trace: {note}", file=sys.stderr)
    print(f"reference: {json.dumps(verdict)}", file=sys.stderr)
    for k, v in line["compared"].items():
        print(f"{k} {v['value']} (limit {v['limit']})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0
