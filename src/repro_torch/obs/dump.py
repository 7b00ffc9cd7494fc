"""Obs dump CLI: drive a smoke workload, export snapshot + Chrome trace
(torch port of ``repro.obs.dump``).

    PYTHONPATH=src python -m repro_torch.obs.dump [--target train_sync|sync|serve]
                                                  [--out DIR] [--steps N]
                                                  [--report] [--device cpu]

Runs a small instrumented workload end to end on ``--device`` (the card by
default) and writes three artifacts to ``--out`` (default
``REPRO_TRACE_DIR``):

  * ``trace_<target>.json``   — Chrome-trace/Perfetto timeline of the run
  * ``metrics_<target>.json`` — the metrics-registry snapshot
  * ``metrics_<target>.md``   — the same snapshot as a markdown table

``--report`` additionally renders the wire-efficiency observatory
(``report_<target>.md`` / ``.json``): top width-regret buckets
(``obs/regret.py``), drift events and currently-stale plans
(``obs/drift.py``), and sparkline tables of the recorded ratio series
(``obs/recorder.py``).

Targets are pluggable (``TARGETS``) and sized as the reference's; the
default ``train_sync`` runs the smollm smoke model through the
fault-tolerant step runner and then a publish/update/ack weight-sync loop —
one file that shows nested ``train:step`` / ``plan:*`` / ``sync:*`` spans
on a common clock.  :func:`run` is the twin of the reference's
``benchmarks/run.py`` entry (key ``obs``): the default dump with the
observatory report.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile


def _run_train(steps: int, device) -> None:
    """A few fault-tolerant train steps on the smoke smollm config."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.launch.train import single_process_group
    from repro_torch.optim.optimizers import OptimConfig
    from repro_torch.runtime.fault_tolerance import RunnerConfig, StepRunner
    from repro_torch.train import step as step_lib

    cfg = configs.get_smoke("smollm_135m")
    tcfg = step_lib.TrainConfig(policy=CompressionPolicy(min_bytes=0),
                                optim=OptimConfig(lr=1e-3, warmup_steps=2))
    rng = np.random.default_rng(0)  # the reference's make_batch(cfg, 2, 32)
    with single_process_group(device) as group:
        state = step_lib.build_train_state(
            cfg, tcfg, generator=torch.Generator().manual_seed(0), group=group,
            device=device)
        dev = state.model.leaves()[0].device
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 32))).to(dev)
                 for k in ("tokens", "labels")}

        def step(state, batch):
            return state, step_lib.train_step(state, batch, tcfg, group=group)

        with tempfile.TemporaryDirectory() as ckpt_dir:
            runner = StepRunner(step, None, RunnerConfig(ckpt_dir=ckpt_dir))
            for _ in range(steps):
                state, _ = runner.run_step(state, batch)


def _run_sync(publishes: int, device) -> None:
    """A publish -> update -> ack weight-sync loop with two replicas, on the
    reference's numpy draws."""
    import numpy as np
    import torch

    from repro_torch import kernels
    from repro_torch.core.calibrate import CompressionProfile
    from repro_torch.core.policy import CompressionPolicy
    from repro_torch.sync.engine import WeightSyncEngine, apply_update

    dev = kernels.resolve_device(device)
    rng = np.random.default_rng(0)

    def bf16(a):
        return torch.from_numpy(a).to(device=dev, dtype=torch.bfloat16)

    params = {
        "wq": bf16(rng.normal(0, 0.02, (1 << 14,))),
        "wk": bf16(rng.normal(0, 0.02, (1 << 13,))),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }
    prof = CompressionProfile(widths={"weight": 5, "delta": 2, "delta_lo": 4})
    eng = WeightSyncEngine(policy=CompressionPolicy(min_bytes=0, profile=prof))
    replicas = {"r0": None, "r1": None}
    for i in range(publishes):
        version = eng.publish(params)
        for r in replicas:
            if r == "r1" and i < 2:
                continue  # r1 joins late: exercises the full-send path
            upd = eng.update_for(r)
            base = replicas[r] if upd.base_version is not None else None
            replicas[r] = apply_update(upd, base_params=base, device=dev)
            eng.ack(r, version)
        # a small simulated optimizer step between publishes: sub-ULP
        # relative updates, so most bf16 weights round to NO change and
        # the warm XOR delta stays within the calibrated widths
        # (leaves in sorted key order, the draw order of the reference's
        # jax.tree.map; the f32 x f64 product is cast to bf16 as there)
        params = {k: bf16(params[k].float().cpu().numpy()
                          * (1 + rng.normal(0, 2e-4, params[k].shape)))
                  if params[k].dtype == torch.bfloat16 else params[k]
                  for k in sorted(params)}
        params["step"] = params["step"] + 1


def _run_serve(steps: int, device) -> None:
    """A tiny PD-disaggregated serve loop (admission + decode)."""
    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.models import transformer
    from repro_torch.serve.engine import Request, ServeConfig, ServeEngine

    cfg = configs.get_smoke("smollm_135m")
    model = transformer.init(cfg, generator=torch.Generator().manual_seed(0),
                             device=device)
    engine = ServeEngine(cfg, model, ServeConfig(
        batch_slots=2, max_len=64, prefill_chunk=8, pd_disaggregated=True))
    rng = np.random.default_rng(0)
    for rid in range(3):
        prompt = rng.integers(0, cfg.vocab, 8).astype(np.int32)
        engine.submit(Request(rid=rid, prompt=prompt, max_new=4))
    engine.run(max_steps=max(steps, 16))


def _target_train_sync(steps: int, device) -> None:
    _run_train(steps, device)
    _run_sync(max(steps, 3), device)


TARGETS = {
    "train_sync": _target_train_sync,  # default: train steps + sync loop
    "sync": _run_sync,
    "serve": _run_serve,
}


def build_report(*, window: int = 200, top: int = 10) -> dict:
    """Assemble the observatory report from the live analysis layer:
    top width-regret rows, the drift report, per-kind ledger totals, and
    windowed stats + sparklines of every recorded ratio series."""
    from repro_torch import obs
    from repro_torch.obs import drift as drift_lib
    from repro_torch.obs import regret as regret_lib

    rec = obs.recorder()
    series = {}
    for key in rec.series():
        name, _, labels_key = key.partition("|")
        if "ratio" not in name:
            continue
        st = rec.window(name, n=window, labels_key=labels_key)
        vals = [s.value for s in rec.samples(name, n=window,
                                             labels_key=labels_key)]
        series[key] = dict(st.to_dict(), spark=obs.sparkline(vals))
    ledger = regret_lib.ledger_totals()
    return {
        "regret": [r.to_dict() for r in regret_lib.width_regret()[:top]],
        "drift": drift_lib.detector().report().to_dict(),
        "ledger_by_kind": ledger["by_kind"],
        "ledger_by_bucket": {
            f"{k}/{d}/w{w}": v
            for (k, d, w), v in sorted(ledger["by_bucket"].items())},
        "ratio_series": series,
    }


def report_to_markdown(rep: dict) -> str:
    """Human rendering of :func:`build_report`'s dict."""
    lines = ["# Wire-efficiency observatory", ""]
    lines += ["## Top regret buckets", ""]
    if rep["regret"]:
        lines += ["| kind | dtype | width (achieved→optimal) | wire KiB "
                  "(achieved/optimal) | regret KiB | regret/raw |",
                  "|---|---|---|---|---|---|"]
        for r in rep["regret"]:
            lines.append(
                f"| {r['kind']} | {r['dtype_name']} "
                f"| {r['achieved_width']}→{r['optimal_width']} "
                f"| {r['achieved_wire_bytes']/2**10:.1f}/"
                f"{r['optimal_wire_bytes']/2**10:.1f} "
                f"| {r['regret_bytes']/2**10:+.1f} "
                f"| {r['regret_frac']:+.4f} |")
    else:
        lines.append("(no host-path samples recorded)")
    lines += ["", "## Drift", ""]
    ev = rep["drift"]["events"]
    if ev:
        lines += ["| plan key | kind | predicted | live at fire |",
                  "|---|---|---|---|"]
        lines += [f"| {e['key_hex']} | {e['kind']} "
                  f"| {e['predicted_ratio']:.4f} | {e['live_ratio']:.4f} |"
                  for e in ev]
        stale = rep["drift"]["stale"]
        lines += ["", f"currently stale: "
                  f"{', '.join(s['key_hex'] for s in stale) or 'none'}"]
    else:
        lines.append("no drift events (live wire matched every plan's "
                     "prediction)")
    lines += ["", "## Ratio series (flight recorder)", ""]
    if rep["ratio_series"]:
        lines += ["| series | n | mean | last | spark |",
                  "|---|---|---|---|---|"]
        esc = "\\|"  # literal pipe inside a markdown table cell
        lines += [f"| {key.replace('|', esc)} | {s['count']} "
                  f"| {s['mean']:.4f} | {s['last']:.4f} | {s['spark']} |"
                  for key, s in sorted(rep["ratio_series"].items())]
    else:
        lines.append("(no ratio series recorded)")
    return "\n".join(lines) + "\n"


def dump(target: str = "train_sync", out: str = None, steps: int = 3,
         report: bool = False, device="cuda") -> dict:
    """Run ``target`` on ``device`` and write trace + metric artifacts;
    returns their paths."""
    from repro_torch import obs

    if target not in TARGETS:
        raise KeyError(f"unknown target {target!r}; have {sorted(TARGETS)}")
    obs.reset()
    TARGETS[target](steps, device)
    out = obs.trace_dir() if out is None else out
    os.makedirs(out, exist_ok=True)
    trace_path = obs.export_chrome_trace(
        os.path.join(out, f"trace_{target}.json"))
    json_path = os.path.join(out, f"metrics_{target}.json")
    with open(json_path, "w") as f:
        f.write(obs.registry().to_json(indent=2))
    md_path = os.path.join(out, f"metrics_{target}.md")
    with open(md_path, "w") as f:
        f.write(obs.registry().to_markdown() + "\n")
    paths = {"trace": trace_path, "metrics_json": json_path,
             "metrics_md": md_path}
    if report:
        rep = build_report()
        rep_json = os.path.join(out, f"report_{target}.json")
        with open(rep_json, "w") as f:
            json.dump(rep, f, indent=2, sort_keys=True)
        rep_md = os.path.join(out, f"report_{target}.md")
        with open(rep_md, "w") as f:
            f.write(report_to_markdown(rep))
        paths.update({"report_json": rep_json, "report_md": rep_md})
    return paths


def run(device="cuda") -> None:
    """The default smoke dump on ``device``, observatory report included;
    prints the reference's three lines."""
    paths = dump(report=True, device=device)
    print(f"obs dump: trace -> {paths['trace']}")
    print(f"obs dump: metrics -> {paths['metrics_json']}")
    print(f"obs dump: report -> {paths['report_md']}")


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--target", default="train_sync",
                    choices=sorted(TARGETS))
    ap.add_argument("--out", default=None,
                    help="output directory (default: REPRO_TRACE_DIR)")
    ap.add_argument("--steps", type=int, default=3,
                    help="workload size (train steps / publishes / "
                         "decode steps)")
    ap.add_argument("--report", action="store_true",
                    help="also write the observatory report "
                         "(regret/drift/sparklines)")
    ap.add_argument("--device", default="cuda",
                    help="where the workload runs (cuda, or cpu)")
    args = ap.parse_args(argv)
    paths = dump(args.target, args.out, args.steps, report=args.report,
                 device=args.device)
    for k, v in paths.items():
        print(f"{k}: {v}")


if __name__ == "__main__":
    main()
