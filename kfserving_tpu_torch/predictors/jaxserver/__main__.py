"""jaxserver entry point of the port:
``python -m kfserving_tpu_torch.predictors.jaxserver``.

Serves the jaxserver artifact format (config.json plus an optional Flax
checkpoint.msgpack) with the PyTorch port:

    python -m kfserving_tpu_torch.predictors.jaxserver --model_name bert \
        --model_dir /path/to/model --http_port 8080 [--device cuda]

With ``--multi_model``, ``--model_dir`` is the catalog root and the
replica is demand-paged, as the JAX package boots it: the server starts
with no model, ``POST /v2/repository/models/{name}/load`` registers
``<model_dir>/<name>`` (a config read, no device memory), and the first
predict faults it onto the card under one device-memory ledger
(``KFS_HBM_BUDGET`` or 90% of the card).  Least-recently-used idle models
are offloaded to their mmap host params (``KFS_PARAM_CACHE``) to make
room and fault back in on their next request; ``GET /debug/cache`` shows
the ledger and the residency states.

Without ``--multi_model``, ``KFS_STANDBY`` arms standby: the server starts
with no model and loads it on ``POST /standby/activate``.
"""

import argparse
import logging
import os

from kfserving_tpu_torch.predictors.jaxserver.repository import (
    TorchModelRepository,
)
from kfserving_tpu_torch.predictors.torch_model import TorchModel
from kfserving_tpu_torch.server.app import ModelServer, parser as server_parser

parser = argparse.ArgumentParser(parents=[server_parser])
parser.add_argument("--model_name", default="model",
                    help="name under which the model is served")
parser.add_argument("--model_dir", required=True,
                    help="model artifact storage URI (a local path, file://, "
                         "http(s)://, gs://, s3:// or an Azure blob URL) "
                         "or, with --multi_model, the models root dir")
parser.add_argument("--multi_model", action="store_true",
                    help="serve a demand-paged repository of models "
                         "registered via /v2/repository/models/{name}/load")
parser.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, cuda:N or cpu)")


def main(argv=None) -> None:
    args, _ = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    if args.multi_model:
        repo = TorchModelRepository(models_dir=args.model_dir,
                                    device=args.device)
        ModelServer(http_port=args.http_port, registered_models=repo,
                    container_concurrency=args.container_concurrency
                    ).start([])
        return
    model = TorchModel(args.model_name, args.model_dir, device=args.device)
    server = ModelServer(http_port=args.http_port,
                         container_concurrency=args.container_concurrency)
    if os.environ.get("KFS_STANDBY"):
        # Recycle fast swap: imports and server setup are done; the load
        # waits for POST /standby/activate.
        server.standby_model(lambda: (model.load(), model)[1])
        server.start([])
    else:
        model.load()
        server.start([model])


if __name__ == "__main__":
    main()
