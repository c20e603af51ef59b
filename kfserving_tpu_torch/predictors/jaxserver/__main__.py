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

With ``--config_dir`` (a models.json file, or a directory holding one)
the replica is also multi-model and runs the agent in-process: the
watcher reads the TrainedModel config the controller writes, the puller
downloads each model into ``--model_dir`` and loads it into the
repository, and a removed model is unloaded.  ``--log_url`` tees every
request and response to a CloudEvents sink (``--log_mode``
all|request|response, ``--source_uri`` the events' source).

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
parser.add_argument("--config_dir", default=None,
                    help="model-config file/dir to watch for multi-model "
                         "serving (agent --config-dir equivalent)")
parser.add_argument("--log_url", default=None,
                    help="CloudEvents sink for payload logging "
                         "(agent --log-url equivalent)")
parser.add_argument("--log_mode", default="all",
                    choices=["all", "request", "response"])
parser.add_argument("--source_uri", default="",
                    help="CloudEvents source attribute")
parser.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, cuda:N or cpu)")


def build_server(args) -> ModelServer:
    """The server the flags describe, with its agent services (watcher and
    puller, payload logger) attached; no model registered yet."""
    cc = args.container_concurrency
    if args.multi_model or args.config_dir:
        repo = TorchModelRepository(models_dir=args.model_dir,
                                    device=args.device)
        server = ModelServer(http_port=args.http_port,
                             registered_models=repo,
                             container_concurrency=cc,
                             grpc_port=args.grpc_port)
    else:
        server = ModelServer(http_port=args.http_port,
                             container_concurrency=cc,
                             grpc_port=args.grpc_port)
    if args.config_dir:
        import asyncio

        from kfserving_tpu_torch.agent import (
            Downloader,
            ModelConfigWatcher,
            Puller,
        )

        events: asyncio.Queue = asyncio.Queue()
        watcher = ModelConfigWatcher(args.config_dir, events=events)
        puller = Puller(server.repository, Downloader(args.model_dir),
                        events=events)
        server.services += [watcher, puller]
    if args.log_url:
        from kfserving_tpu_torch.agent import RequestLogger

        request_logger = RequestLogger(
            args.log_url, source_uri=args.source_uri,
            log_mode=args.log_mode)
        request_logger.attach(server)
        server.services.append(request_logger)
    return server


def main(argv=None) -> None:
    args, _ = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    server = build_server(args)
    if args.multi_model or args.config_dir:
        server.start([])
        return
    model = TorchModel(args.model_name, args.model_dir, device=args.device)
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
