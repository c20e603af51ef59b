"""`python -m kfserving_tpu_torch.control serve` — the manager entry point
of the port (reference cmd/manager/main.go:59-186).  Replicas serve on
``--device`` (default cuda)."""

import argparse
import logging

from kfserving_tpu_torch.control.clusterconfig import ClusterConfig
from kfserving_tpu_torch.control.manager import ServingManager

parser = argparse.ArgumentParser(prog="kfserving_tpu_torch.control")
sub = parser.add_subparsers(dest="command", required=True)

serve = sub.add_parser("serve", help="run the serving fabric")
serve.add_argument("--config", default=None,
                   help="cluster config JSON (tier-1; defaults if absent)")
serve.add_argument("--control-port", type=int, default=8081,
                   help="control API port (the apiserver surface)")
serve.add_argument("--ingress-port", type=int, default=None,
                   help="data-plane ingress port (default: the cluster "
                        "config's ingress block, else 8080)")
serve.add_argument("--host", default=None,
                   help="bind address (default: cluster config ingress "
                        "host, else 127.0.0.1)")
serve.add_argument("--orchestrator", default="inprocess",
                   choices=["inprocess", "subprocess"],
                   help="replica actuation backend")
serve.add_argument("--apply", action="append", default=[],
                   help="InferenceService spec file(s) to apply at boot")
serve.add_argument("--device", default="cuda",
                   help="torch device the replicas serve on (cuda, "
                        "cuda:N or cpu)")
serve.add_argument("--log-level", default="INFO")


def main(argv=None):
    args = parser.parse_args(argv)
    logging.basicConfig(
        level=getattr(logging, args.log_level.upper(), logging.INFO),
        format="%(asctime)s %(name)s %(levelname)s %(message)s")
    if args.command == "serve":
        manager = ServingManager(
            cluster_config=ClusterConfig.load(args.config),
            orchestrator=args.orchestrator,
            control_port=args.control_port,
            ingress_port=args.ingress_port,
            host=args.host,
            device=args.device)
        manager.run(apply=args.apply)


if __name__ == "__main__":
    main()
