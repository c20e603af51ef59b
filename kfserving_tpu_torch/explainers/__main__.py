"""``python -m kfserving_tpu_torch.explainers``: the standalone explainer
server.

Port of ``kfserving_tpu/explainers/__main__.py``.  One entry point
covers every in-tree explainer type:

    python -m kfserving_tpu_torch.explainers \\
        --model_name iris --explainer_type anchor_tabular \\
        --storage_uri file:///path/to/artifacts \\
        --predictor_host 127.0.0.1:8080 --http_port 8081

``--predictor_host`` defaults to ``$KFS_CLUSTER_LOCAL_URL/direct/predictor``
(the cluster-local gateway an orchestrator injects), so an explainer
replica needs no explicit wiring.  ``--device`` places the saliency
explainer's model (default cuda).
"""

import argparse
import logging
import os

from kfserving_tpu_torch.explainers import EXPLAINER_TYPES, build_explainer
from kfserving_tpu_torch.server.app import ModelServer, parser as server_parser

logging.basicConfig(level=logging.INFO)

parser = argparse.ArgumentParser(parents=[server_parser])
parser.add_argument("--model_name", default="model")
parser.add_argument("--explainer_type", default="saliency",
                    choices=EXPLAINER_TYPES)
parser.add_argument("--storage_uri", default="",
                    help="explainer artifact dir (train.npy / *.json)")
parser.add_argument("--predictor_host", default=None,
                    help="host:port[/prefix] of the predictor; defaults "
                         "to the injected cluster-local gateway")
parser.add_argument("--device", default="cuda",
                    help="torch device of the saliency explainer's model "
                         "(cuda, cuda:N or cpu)")


def main(argv=None):
    args, _ = parser.parse_known_args(argv)
    predictor_host = args.predictor_host
    if not predictor_host:
        gateway = os.environ.get("KFS_CLUSTER_LOCAL_URL")
        if gateway:
            predictor_host = f"{gateway}/direct/predictor"
    model = build_explainer(args.model_name, args.explainer_type,
                            args.storage_uri, predictor_host,
                            device=args.device)
    model.load()
    ModelServer(http_port=args.http_port,
                container_concurrency=args.container_concurrency
                ).start([model])


if __name__ == "__main__":
    main()
