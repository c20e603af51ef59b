"""kfs CLI: kubectl-style command line over the control API.

    python -m kfserving_tpu_torch.client apply -f isvc.json
    python -m kfserving_tpu_torch.client get [NAME]
    python -m kfserving_tpu_torch.client delete NAME
    python -m kfserving_tpu_torch.client wait NAME --timeout 120
    python -m kfserving_tpu_torch.client predict NAME -d '{"instances": [[...]]}'
    python -m kfserving_tpu_torch.client canary NAME --percent 20
    python -m kfserving_tpu_torch.client promote NAME
    python -m kfserving_tpu_torch.client rollouts
    python -m kfserving_tpu_torch.client profile --window 60 -o trace.json
    python -m kfserving_tpu_torch.client cache [--replica HOST] [--top-k N] \
        [--top-cost N]
    python -m kfserving_tpu_torch.client history [SERIES] [--window S] \
        [--replica HOST]
    python -m kfserving_tpu_torch.client incidents [ID] [--state open]
    python -m kfserving_tpu_torch.client doctor

The reference splits this between kubectl (CRDs) and the SDK; the TPU
build ships one client for both planes.  Port of
``kfserving_tpu/client/cli.py``: the same commands and flags.
"""

import argparse
import asyncio
import json
import sys
import time

from kfserving_tpu_torch.client.client import KFServingClient

parser = argparse.ArgumentParser(prog="kfs")
parser.add_argument("--control-url", default="http://127.0.0.1:8081")
parser.add_argument("--ingress-url", default="http://127.0.0.1:8080")
parser.add_argument("--namespace", "-n", default="default")
sub = parser.add_subparsers(dest="command", required=True)

p_apply = sub.add_parser("apply", help="create or update from a spec file")
p_apply.add_argument("-f", "--filename", required=True)

p_get = sub.add_parser("get", help="get one isvc (or list all)")
p_get.add_argument("name", nargs="?")

p_delete = sub.add_parser("delete")
p_delete.add_argument("name")

p_wait = sub.add_parser("wait", help="block until ready")
p_wait.add_argument("name")
p_wait.add_argument("--timeout", type=float, default=120.0)

p_predict = sub.add_parser("predict")
p_predict.add_argument("name")
p_predict.add_argument("-d", "--data", help="inline JSON payload")
p_predict.add_argument("-f", "--filename", help="payload file")
p_predict.add_argument("--protocol", default="v1", choices=["v1", "v2"])
p_predict.add_argument("--model", default=None,
                       help="model name when it differs from the isvc "
                            "(TrainedModel under a multi-model isvc)")

p_explain = sub.add_parser("explain")
p_explain.add_argument("name")
p_explain.add_argument("-d", "--data")
p_explain.add_argument("-f", "--filename")

p_canary = sub.add_parser("canary", help="set canary traffic percent")
p_canary.add_argument("name")
p_canary.add_argument("--percent", type=int, required=True)

p_promote = sub.add_parser("promote", help="promote canary to 100%%")
p_promote.add_argument("name")

sub.add_parser("rollouts",
               help="progressive-delivery status (active rollouts, "
                    "rollbacks with evidence, quarantine)")

p_profile = sub.add_parser(
    "profile",
    help="fetch the fleet device-time profile (engine event timeline "
         "as Chrome-trace JSON) and save it for Perfetto")
p_profile.add_argument("--window", type=float, default=None,
                       help="trailing window in seconds (default: "
                            "the whole event ring)")
p_profile.add_argument("--replica", default=None,
                       help="narrow to one replica host:port")
p_profile.add_argument("-o", "--output", default="trace.json",
                       help="file to write the trace to (load it at "
                            "ui.perfetto.dev)")

p_cache = sub.add_parser(
    "cache",
    help="fleet cache & cost snapshot (per-replica prefix-index "
         "census, hot chains, pool/HBM occupancy)")
p_cache.add_argument("--replica", default=None,
                     help="narrow to one replica host:port")
p_cache.add_argument("--top-k", type=int, default=None,
                     help="hot chains per model (default 10)")
p_cache.add_argument("--top-cost", type=int, default=None,
                     help="also list the top-N cost-attribution "
                          "records by attributed device-ms and by KV "
                          "blocks held")

p_history = sub.add_parser(
    "history",
    help="telemetry history (ring-TSDB frames) rendered as one "
         "sparkline per fleet series")
p_history.add_argument("series", nargs="?",
                       help="family name (e.g. kfserving_tpu_"
                            "request_latency_ms_p99); omit for every "
                            "live series")
p_history.add_argument("--labels", default=None,
                       help="label filter, k=v[,k2=v2...]")
p_history.add_argument("--window", type=float, default=None,
                       help="lookback seconds (default 600)")
p_history.add_argument("--step", type=float, default=None,
                       help="alignment grid seconds (default 1)")
p_history.add_argument("--replica", default=None,
                       help="narrow to one replica host:port")
p_history.add_argument("--json", action="store_true",
                       help="raw federated frames instead of "
                            "sparklines")

p_incidents = sub.add_parser(
    "incidents",
    help="diagnosed incidents (detector firings joined into "
         "evidence-bearing records with ranked causal hypotheses)")
p_incidents.add_argument("id", nargs="?",
                         help="incident id for the full record "
                              "(evidence bundle included)")
p_incidents.add_argument("--state", default=None,
                         choices=["open", "closed"],
                         help="filter the listing by state")
p_incidents.add_argument("--limit", type=int, default=None)
p_incidents.add_argument("--replica", default=None,
                         help="narrow to one replica host:port")
p_incidents.add_argument("--json", action="store_true",
                         help="raw wire body instead of the rendered "
                              "digest")

p_doctor = sub.add_parser(
    "doctor",
    help="one-shot fleet health digest: open incidents with top "
         "hypotheses, trend slopes, latency/MFU/occupancy snapshot")
p_doctor.add_argument(
    "--exit-code", action="store_true",
    help="exit nonzero (2) when any incident is open — makes the "
         "doctor scriptable as a CI / cron health gate")

p_creds = sub.add_parser(
    "credentials",
    help="register storage credentials (reference set_credentials)")
creds_sub = p_creds.add_subparsers(dest="creds_command", required=True)
for _provider in ("gcs", "s3", "azure"):
    cp = creds_sub.add_parser(f"set-{_provider}")
    cp.add_argument("-f", "--credentials-file", required=True)
    cp.add_argument("--service-account", default="default")
    if _provider == "s3":
        cp.add_argument("--profile", default="default")
        cp.add_argument("--endpoint", default=None)
        cp.add_argument("--region", default=None)
        cp.add_argument("--use-https", default=None)
        cp.add_argument("--verify-ssl", default=None)
creds_sub.add_parser("list")
creds_del = creds_sub.add_parser("delete")
creds_del.add_argument("name")

p_tm = sub.add_parser("trainedmodel", help="TrainedModel ops")
tm_sub = p_tm.add_subparsers(dest="tm_command", required=True)
tm_apply = tm_sub.add_parser("apply")
tm_apply.add_argument("-f", "--filename", required=True)
tm_delete = tm_sub.add_parser("delete")
tm_delete.add_argument("name")
tm_get = tm_sub.add_parser("get")
tm_get.add_argument("name", nargs="?")


def _payload(args) -> dict:
    if getattr(args, "data", None):
        return json.loads(args.data)
    if getattr(args, "filename", None):
        with open(args.filename) as f:
            return json.load(f)
    return json.load(sys.stdin)


async def _payload_async(args) -> dict:
    """`_payload` off the loop (kfslint async-blocking): `kfs predict
    -f -` reads stdin, which can block indefinitely on a pipe."""
    return await asyncio.get_running_loop().run_in_executor(
        None, _payload, args)


_SPARK = "▁▂▃▄▅▆▇█"


def _sparkline(values) -> str:
    """One unicode block character per frame, scaled to the series'
    own min..max (a flat series renders as a flat floor line)."""
    if not values:
        return ""
    lo, hi = min(values), max(values)
    if hi <= lo:
        return _SPARK[0] * len(values)
    span = hi - lo
    return "".join(
        _SPARK[min(len(_SPARK) - 1,
                   int((v - lo) / span * len(_SPARK)))]
        for v in values)


def _render_history(body: dict) -> str:
    """The fleet rollup as text: one header + sparkline per series.

    Accepts both wire shapes: the router's federation (`replicas` +
    `fleet`) and a single replica's flat `series` list (pointing
    --ingress-url straight at a model server works too)."""
    lines = []
    if "series" in body and "fleet" not in body:
        lines.append("replicas: (single replica)")
        fleet = body.get("series") or []
    else:
        replicas = sorted((body.get("replicas") or {}).keys())
        lines.append(f"replicas: {', '.join(replicas) or '(none)'}")
        fleet = body.get("fleet") or []
    if not fleet:
        lines.append("(no series matched)")
    for s in fleet:
        values = [f[1] for f in (s.get("frames") or [])]
        label = ",".join(f"{k}={v}" for k, v in
                         sorted((s.get("labels") or {}).items()))
        name = s.get("name", "")
        head = f"{name}{{{label}}}" if label else name
        if values:
            head += (f"  [{s.get('kind')}] last={values[-1]:.4g} "
                     f"min={min(values):.4g} max={max(values):.4g} "
                     f"n={len(values)}")
        lines.append(head)
        lines.append("  " + (_sparkline(values) or "(no frames)"))
    return "\n".join(lines)


def _fmt_ts(ts) -> str:
    if ts is None:
        return "-"
    return time.strftime("%H:%M:%S", time.localtime(ts))


def _fmt_hyp(hyp: dict) -> str:
    """One hypothesis with its supporting numbers inline."""
    ev = hyp.get("evidence") or {}
    nums = ", ".join(f"{k}={v}" for k, v in sorted(ev.items()))
    line = (f"{hyp.get('cause')} (score {hyp.get('score', 0):.2f}): "
            f"{hyp.get('summary', '')}")
    if nums:
        line += f" [{nums}]"
    return line


def _render_incident_detail(inc: dict) -> str:
    lines = [f"incident {inc.get('id')}  [{inc.get('state')}]  "
             f"model={inc.get('model')}  root_cause="
             f"{inc.get('root_cause') or 'unclassified'}"]
    if inc.get("replica"):
        lines.append(f"replica: {inc['replica']}")
    lines.append(f"opened: {_fmt_ts(inc.get('opened_ts'))}  "
                 f"updated: {_fmt_ts(inc.get('updated_ts'))}  "
                 f"closed: {_fmt_ts(inc.get('closed_ts'))}")
    counts = inc.get("trigger_counts") or {}
    if counts:
        lines.append("triggers: " + ", ".join(
            f"{k}x{v}" for k, v in sorted(counts.items())))
    lines.append("hypotheses:")
    for hyp in inc.get("hypotheses") or []:
        lines.append("  " + _fmt_hyp(hyp))
    if not inc.get("hypotheses"):
        lines.append("  (unclassified — bundle held no usable "
                     "decomposition)")
    sources = (inc.get("evidence") or {}).get("sources") or []
    lines.append(f"evidence sources: {', '.join(sources) or '(none)'}")
    return "\n".join(lines)


def _render_incidents(body: dict) -> str:
    """All three wire shapes: the router federation (`replicas` +
    `fleet` rollup), a bare replica's report (`incidents`), and the
    `?id=` full record."""
    if body.get("id"):
        return _render_incident_detail(body)
    lines = []
    if "fleet" in body or "replicas" in body:
        replicas = sorted((body.get("replicas") or {}).keys())
        lines.append(f"replicas: {', '.join(replicas) or '(none)'}")
        fleet = body.get("fleet") or []
        lines.append(f"fleet incidents: {len(fleet)} "
                     f"({body.get('open', 0)} open)")
        for f in fleet:
            state = "OPEN" if f.get("open") else "closed"
            lines.append(
                f"[{state}] {f.get('root_cause') or 'unclassified'} "
                f"model={f.get('model')} x{f.get('count')} on "
                f"{len(f.get('replicas') or [])} replica(s)")
            if f.get("top_hypothesis"):
                lines.append("  " + _fmt_hyp(f["top_hypothesis"]))
            for ref in (f.get("incident_ids") or [])[:5]:
                lines.append(f"  {ref.get('replica')}: "
                             f"{ref.get('id')}")
        brown = ((body.get("router") or {})
                 .get("brownout_levels")) or {}
        active = {m: lvl for m, lvl in brown.items() if lvl}
        if active:
            lines.append("router brownout: " + ", ".join(
                f"{m}=L{lvl}" for m, lvl in sorted(active.items())))
    else:
        lines.append("replicas: (single replica)")
        if body.get("enabled") is False:
            lines.append("incident engine disabled (KFS_INCIDENTS=0)")
            return "\n".join(lines)
        incidents = body.get("incidents") or []
        lines.append(f"incidents: {len(incidents)} "
                     f"({body.get('open', 0)} open, "
                     f"{body.get('total_opened', 0)} opened total)")
        for inc in incidents:
            state = ("OPEN" if inc.get("state") == "open"
                     else inc.get("state"))
            lines.append(
                f"[{state}] {inc.get('id')} "
                f"{inc.get('root_cause') or 'unclassified'} "
                f"model={inc.get('model')}")
            if inc.get("top_hypothesis"):
                lines.append("  " + _fmt_hyp(inc["top_hypothesis"]))
    return "\n".join(lines)


# Series the doctor digests alongside the incident list: tail
# latency, the trend detector's slopes, and the MFU / KV-pool
# occupancy snapshot.
_DOCTOR_SERIES = (
    "kfserving_tpu_request_latency_ms_p99",
    "kfserving_tpu_trend_slope_per_second",
    "kfserving_tpu_engine_mfu",
    "kfserving_tpu_generator_pool_occupancy_ratio",
)


def _series_list(body: dict) -> list:
    """History series in either wire shape (router fleet rollup vs a
    bare replica's flat list)."""
    if "series" in body and "fleet" not in body:
        return body.get("series") or []
    return body.get("fleet") or []


def _render_doctor(incidents_body: dict, histories: dict) -> str:
    open_count = incidents_body.get("open", 0) or 0
    verdict = ("HEALTHY — no open incidents" if not open_count
               else f"ATTENTION — {open_count} open incident(s)")
    lines = [f"kfs doctor: {verdict}", "", "-- incidents --",
             _render_incidents(incidents_body), "", "-- signals --"]
    for name, body in histories.items():
        if body.get("_error"):
            lines.append(f"  {name}: unavailable ({body['_error']})")
            continue
        series = _series_list(body)
        if not series:
            lines.append(f"  {name}: (no frames)")
            continue
        for s in series[:8]:
            values = [f[1] for f in (s.get("frames") or [])]
            if not values:
                continue
            label = ",".join(f"{k}={v}" for k, v in
                             sorted((s.get("labels") or {}).items()))
            head = s.get("name", name) + (f"{{{label}}}"
                                          if label else "")
            lines.append(f"  {head}: last={values[-1]:.4g} "
                         f"min={min(values):.4g} "
                         f"max={max(values):.4g}  "
                         + _sparkline(values[-40:]))
    return "\n".join(lines)


def _read_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def _write_json(path: str, data: dict) -> None:
    with open(path, "w") as f:
        json.dump(data, f)


async def _run(args) -> dict:
    loop = asyncio.get_running_loop()
    async with KFServingClient(args.control_url, args.ingress_url) as c:
        ns = args.namespace
        if args.command == "apply":
            spec = await loop.run_in_executor(None, _read_json,
                                              args.filename)
            return await c.create(spec)
        if args.command == "get":
            return await c.get(args.name, ns) if args.name \
                else await c.get()
        if args.command == "delete":
            return await c.delete(args.name, ns)
        if args.command == "wait":
            await c.wait_isvc_ready(args.name, ns,
                                    timeout_seconds=args.timeout)
            return {"name": args.name, "ready": True}
        if args.command == "predict":
            return await c.predict(args.name,
                                   await _payload_async(args),
                                   protocol=args.protocol,
                                   model_name=args.model)
        if args.command == "explain":
            return await c.explain(args.name,
                                   await _payload_async(args))
        if args.command == "canary":
            return await c.rollout_canary(args.name, args.percent, ns)
        if args.command == "promote":
            return await c.promote(args.name, ns)
        if args.command == "rollouts":
            return await c.rollouts()
        if args.command == "cache":
            return await c.cache(replica=args.replica,
                                 top_k=args.top_k,
                                 top_cost=args.top_cost)
        if args.command == "incidents":
            body = await c.incidents(incident_id=args.id,
                                     state=args.state,
                                     limit=args.limit,
                                     replica=args.replica)
            if args.json:
                return body
            return {"_rendered": _render_incidents(body)}
        if args.command == "doctor":
            incidents_body = await c.incidents()
            histories = {}
            for name in _DOCTOR_SERIES:
                try:
                    histories[name] = await c.history(series=name)
                except Exception as e:
                    # A partial digest still diagnoses: a replica
                    # without the history ring just loses sparklines.
                    histories[name] = {"_error": str(e)}
            out = {"_rendered": _render_doctor(incidents_body,
                                               histories)}
            if getattr(args, "exit_code", False) and \
                    (incidents_body.get("open", 0) or 0):
                # Health-gate mode: open incidents flip the process
                # exit status so cron/CI wrappers need no parsing.
                out["_exit_code"] = 2
            return out
        if args.command == "history":
            labels = None
            if args.labels:
                labels = {}
                for pair in args.labels.split(","):
                    if "=" not in pair:
                        raise SystemExit(
                            "--labels must be k=v[,k2=v2...]")
                    k, v = pair.split("=", 1)
                    labels[k] = v
            body = await c.history(series=args.series, labels=labels,
                                   window_s=args.window,
                                   step_s=args.step,
                                   replica=args.replica)
            if args.json:
                return body
            # Rendered (not JSON) output: main() prints this text
            # verbatim so the sparkline glyphs survive.
            return {"_rendered": _render_history(body)}
        if args.command == "profile":
            trace = await c.profile(window_s=args.window,
                                    replica=args.replica)
            await loop.run_in_executor(None, _write_json,
                                       args.output, trace)
            return {"saved": args.output,
                    "events": len(trace.get("traceEvents", []))}
        if args.command == "credentials":
            if args.creds_command == "set-gcs":
                name = await c.set_gcs_credentials(
                    args.credentials_file, args.service_account)
                return {"secret": name,
                        "serviceAccount": args.service_account}
            if args.creds_command == "set-s3":
                name = await c.set_s3_credentials(
                    args.credentials_file, args.service_account,
                    s3_profile=args.profile, s3_endpoint=args.endpoint,
                    s3_region=args.region, s3_use_https=args.use_https,
                    s3_verify_ssl=args.verify_ssl)
                return {"secret": name,
                        "serviceAccount": args.service_account}
            if args.creds_command == "set-azure":
                name = await c.set_azure_credentials(
                    args.credentials_file, args.service_account)
                return {"secret": name,
                        "serviceAccount": args.service_account}
            if args.creds_command == "list":
                return await c.list_secrets()
            if args.creds_command == "delete":
                return await c.delete_secret(args.name)
        if args.command == "trainedmodel":
            if args.tm_command == "apply":
                return await c.create_trained_model(
                    await loop.run_in_executor(None, _read_json,
                                               args.filename))
            if args.tm_command == "delete":
                return await c.delete_trained_model(args.name, ns)
            return await c.get_trained_model(args.name, ns) \
                if args.name else await c.get_trained_model()
        raise SystemExit(f"unknown command {args.command}")


def main(argv=None) -> int:
    args = parser.parse_args(argv)
    try:
        result = asyncio.run(_run(args))
    except Exception as e:
        print(json.dumps({"error": str(e)}), file=sys.stderr)
        return 1
    if isinstance(result, dict) and "_rendered" in result:
        print(result["_rendered"])
        return int(result.get("_exit_code", 0))
    print(json.dumps(result, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
