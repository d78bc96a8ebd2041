"""The benchmark of ``kfnet_tpu_torch`` on one NVIDIA GPU: runs one cell of
``BENCHMARK.json`` once.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell's configuration names its model family, whose module
(``families/<family>.py``) holds everything that depends on the model.
Set-up makes the cell's weights from the seed on the card, renders its
traffic there into pinned host memory, builds the program's objects and
warms up every shape the traffic uses; then the window runs for
``--seconds``; then the family's check compares the window's answers with
its plain reference, and ``check.judge`` holds them to the cell's limits.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks``: each number compared beside its
limit); the numbers compared are also the last lines of
standard error. Without a CUDA device, with fewer than the cell asks for,
with a configuration whose family has no module, or without the program
beside this folder, it exits non-zero and prints no result. Builds and
caches stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import types  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# where families/<family>.py is looked for, in order
FAMILY_DIRS = [os.path.join(HERE, "families")]
BANNED = ("jax", "jaxlib", "flax", "kfnet_tpu")
TRACE_SECONDS = 2.0


def _env():
  """Caches of everything built or compiled, at fixed paths inside the
  checkout; no JAX pulled in by a library."""
  cache = os.path.join(ROOT, "build", "perfbench")
  for var, sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = os.path.join(cache, sub)
  os.environ["USE_FLAX"] = "0"
  os.environ["USE_JAX"] = "0"
  if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def load_benchmark(root: str = ROOT) -> dict:
  with open(os.path.join(root, "BENCHMARK.json")) as f:
    return json.load(f)


def load_config(bench: dict, name: str) -> dict:
  entry = next(c for c in bench["configs"] if c["name"] == name)
  with open(os.path.join(ROOT, entry["file"])) as f:
    return json.load(f)


def load_reader(metric: str):
  """``read(ctx)`` of ``metrics/<metric>.py``."""
  path = os.path.join(HERE, "metrics", f"{metric}.py")
  spec = importlib.util.spec_from_file_location(
      "perfbench.metrics." + metric.replace(".", "_"), path)
  mod = importlib.util.module_from_spec(spec)
  spec.loader.exec_module(mod)
  return mod.read


def metrics_of(bench: dict, cell: str, kind: str):
  return [m for m in bench[kind] if cell in m.get("workloads", [cell])]


def banned_modules():
  """Loaded modules whose top-level name is banned, compared whole."""
  tops = {m.split(".")[0] for m in list(sys.modules)}
  return sorted(tops & set(BANNED))


def percentile(values, q: float) -> float:
  import numpy as np
  return float(np.percentile(np.asarray(values, np.float64), q))


def nvidia_smi() -> str:
  try:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip()
  except (OSError, subprocess.TimeoutExpired) as e:
    return f"nvidia-smi failed: {e}"


def family_file(cfg: dict) -> str:
  """The module of the configuration's family, the first found in
  ``FAMILY_DIRS``; LookupError where it names none or none is found."""
  name = cfg.get("family")
  if not isinstance(name, str) or not name.isidentifier():
    raise LookupError(f"configuration {cfg.get('name')!r} names no family")
  for d in FAMILY_DIRS:
    path = os.path.join(d, f"{name}.py")
    if os.path.isfile(path):
      return path
  raise LookupError(f"family {name!r} of configuration {cfg.get('name')!r}"
                    f" has no module in {FAMILY_DIRS}")


def load_family(cfg: dict):
  """The configuration's family module, loaded once a process as
  ``perfbench.families.<family>``."""
  path = family_file(cfg)
  key = "perfbench.families." + cfg["family"]
  mod = sys.modules.get(key)
  if mod is not None and os.path.abspath(mod.__file__) == path:
    return mod
  spec = importlib.util.spec_from_file_location(key, path)
  mod = importlib.util.module_from_spec(spec)
  sys.modules[key] = mod
  try:
    spec.loader.exec_module(mod)
  except BaseException:
    del sys.modules[key]
    raise
  return mod


def attribution(family, prog, params, frame_shape, device, spans):
  """[(kernel name, layer or None)] in launch order, from the trace of one
  eager step of the family under the layer spans."""
  import torch
  from perfbench import tracing
  step = family.attribution_step(prog, params, frame_shape, device)
  sync = (lambda: torch.cuda.synchronize(device)
          if device.type == "cuda" else None)
  step()  # warm
  sync()
  prof = tracing.profile()
  spans.profiling = True
  with prof:
    step()
    sync()
  spans.profiling = False
  return tracing.eager_sequence(tracing.read_trace(prof), family.LAYERS)


def run_cell(cell: dict, cfg: dict, mix: dict, seed: int, seconds: float,
             trace: bool, device, limits: dict, bench: dict | None = None,
             log=lambda *a: None):
  """One run of a cell on ``device``: set-up, window, check. Returns the
  result's dict (without ``device``) and the parts of the set-up."""
  import torch
  from perfbench import check, loops, flops, tracing
  from perfbench.traffic import generator

  parts = {}
  t = time.perf_counter()
  family = load_family(cfg)
  family.modules()
  parts["import_program_s"] = time.perf_counter() - t
  t = time.perf_counter()
  family.build_kernels(device)
  parts["build_kernels_s"] = time.perf_counter() - t
  frame_shape = tuple(cfg["frame"])
  t = time.perf_counter()
  params = family.make_weights(cfg, seed, device)
  prog = family.program_config(cfg)
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  parts["weights_s"] = time.perf_counter() - t
  t = time.perf_counter()
  pool = generator.frames(mix, seed, frame_shape, device)
  parts["render_s"] = time.perf_counter() - t
  tr, restore = None, None
  if trace:
    t = time.perf_counter()
    spans = tracing.Spans()
    restore = tracing.patch(spans, family)
    tr = types.SimpleNamespace(
        spans=spans, trace_s=min(TRACE_SECONDS, seconds / 4),
        layers=family.LAYERS, replay_span=family.REPLAY_SPAN,
        eager_seq=attribution(family, prog, params, frame_shape, device,
                              spans))
    spans.times.clear()
    spans.events.clear()
    parts["attribution_s"] = time.perf_counter() - t
  if device.type == "cuda":
    torch.cuda.reset_peak_memory_stats(device)
  t = time.perf_counter()
  if mix["mode"] == "offline":
    rec = loops.offline(family, prog, params, cfg, mix, pool, seed, seconds,
                        device, tr)
  else:
    rec = loops.serve(family, prog, params, cfg, mix, pool, seed, seconds,
                      device, tr)
  parts["program_and_warmup_s"] = rec.t0 - t
  memory_peak = (torch.cuda.max_memory_allocated(device)
                 if device.type == "cuda" else 0)
  setup_s = rec.t0 - T_START
  parts["setup_s"] = setup_s
  result = {"attempted": rec.attempted}
  metrics, per_layer = {}, {}
  if bench is not None:
    if not trace:
      for m in metrics_of(bench, cell["name"], "end_to_end"):
        v = {"setup_s": setup_s,
             "pose_fps": rec.frames / rec.window_s,
             "filtered_fps": rec.frames / rec.window_s,
             "pose_ms_p95": (percentile(rec.latencies, 95) * 1e3
                             if rec.latencies else None)}[m["name"]]
        if v is not None:
          metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
      ctx = types.SimpleNamespace(
          rec=rec, spans=tr.spans, family=family, cfg=cfg, mix=mix,
          frame_shape=frame_shape,
          batch=mix["cameras"], peaks=(flops.peaks_for(
              torch.cuda.get_device_name(device))
              if device.type == "cuda" else None))
      for m in metrics_of(bench, cell["name"], "per_layer"):
        v = load_reader(m["name"])(ctx)
        if v is not None:
          per_layer[m["name"]] = {"value": v, "unit": m["unit"]}
      metrics = per_layer
  if restore is not None:
    restore()
  if rec.latencies:
    log(json.dumps({"latency_ms": {
        "p50": percentile(rec.latencies, 50) * 1e3,
        "p95": percentile(rec.latencies, 95) * 1e3,
        "count": len(rec.latencies)}, "window_s": rec.window_s,
        "frames": rec.frames, "first_frames": rec.first_frames}))
  else:
    log(json.dumps({"window_s": rec.window_s, "frames": rec.frames,
                    "first_frames": rec.first_frames}))
  if rec.trace is not None:
    log(json.dumps({"trace": {
        "window_s": rec.trace.window_s, "busy_s": rec.trace.busy_s,
        "layer_shares": rec.trace.layer_shares(),
        "spans": dict(rec.trace.span_counts)}}))
  result["metrics"] = metrics
  if rec.trace is not None:
    result["trace"] = {"busy_s": rec.trace.busy_s,
                       "window_s": rec.trace.window_s,
                       "breakdown": {"device_ops": rec.trace.top_ops(10),
                                     "idle_gaps": [list(g) for g in
                                                   rec.trace.gaps[:10]]}}
  rec.trace = None
  gc.collect()
  if device.type == "cuda":
    torch.cuda.empty_cache()
  t = time.perf_counter()
  numbers = family.compare(cfg, mix, params, pool, rec, seed, device)
  odd, failed = family.failures(cfg, mix, rec, seed, device)
  parts["check_s"] = time.perf_counter() - t
  log(json.dumps({"poses_not_finite": odd, "of_them_failed": failed}))
  correct, shown = check.judge(numbers, limits, family.NUMBERS)
  result["failed"] = failed
  result["correct"] = correct and failed == 0
  result["numbers"] = numbers
  result["checks"] = shown
  result["memory_peak_bytes"] = memory_peak
  return result, parts


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seed", type=int, required=True)
  ap.add_argument("--seconds", type=float, required=True)
  ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
  args = ap.parse_args(argv)
  _env()
  log = lambda s: print(s, file=sys.stderr, flush=True)
  bench = load_benchmark()
  cell = next((w for w in bench["workloads"] if w["name"] == args.workload),
              None)
  if cell is None:
    log(f"no workload {args.workload!r} in BENCHMARK.json")
    return 2
  cfg = load_config(bench, cell["config"])
  try:
    family_file(cfg)
  except LookupError as e:
    log(str(e))
    return 2
  t = time.perf_counter()
  import torch
  torch.set_num_threads(1)  # the host's cores are shared: one thread
  early = {"start_to_torch_s": t - T_START,
           "import_torch_s": time.perf_counter() - t}
  t = time.perf_counter()
  if not torch.cuda.is_available():
    log("no CUDA device: this benchmark runs on the card only")
    return 3
  if torch.cuda.device_count() < cell["chips"]:
    log(f"{cell['name']} needs {cell['chips']} CUDA devices, "
        f"{torch.cuda.device_count()} visible")
    return 3
  log("nvidia-smi: " + nvidia_smi())
  early["cuda_query_and_nvidia_smi_s"] = time.perf_counter() - t
  from perfbench import check
  from perfbench.traffic import generator
  mix = generator.load(cell["traffic"])
  limits = check.load_limits(cell["name"])
  device = torch.device("cuda", 0)
  t = time.perf_counter()
  torch.cuda.set_device(device)
  torch.empty(1, device=device)  # the context
  early["cuda_context_s"] = time.perf_counter() - t
  result, parts = run_cell(cell, cfg, mix, args.seed, args.seconds,
                           bool(args.trace), device, limits, bench, log)
  log(json.dumps({"setup_parts_s": dict(early, **parts)}))
  found = banned_modules()
  if found:
    log(f"modules of JAX or of the JAX package are loaded: {found}")
    return 4
  out = {"correct": result["correct"], "attempted": result["attempted"],
         "failed": result["failed"], "metrics": result["metrics"],
         "device": {"platform": "gpu",
                    "kind": torch.cuda.get_device_name(device),
                    "count": cell["chips"],
                    "memory_peak_bytes": result["memory_peak_bytes"]}}
  if "trace" in result:
    out["device"]["busy_s"] = result["trace"]["busy_s"]
    out["device"]["window_s"] = result["trace"]["window_s"]
    out["breakdown"] = result["trace"]["breakdown"]
  out["checks"] = result["checks"]
  log(json.dumps({"numbers": result["numbers"]}))
  for name, c in result["checks"].items():
    log(f"check {name}: {c['value']} (limit {c['limit']})")
  print(json.dumps(out), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
