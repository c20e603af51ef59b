"""llmserver entry point of the port:
``python -m kfserving_tpu_torch.predictors.llmserver``.

Serves a generative model directory (config.json plus an optional Flax
checkpoint.msgpack) with the PyTorch port — V1 ``:predict``,
``:generate`` and ``generate_stream``:

    python -m kfserving_tpu_torch.predictors.llmserver --model_name gen \
        --model_dir /path/to/model --http_port 8080 [--device cuda] \
        [--grpc_port 8081]

``--grpc_port`` adds the V2 gRPC API and the generation service's
``Generate`` and ``GenerateStream`` over the same model.

With ``KFS_STANDBY`` set the server starts with no model and loads it on
``POST /standby/activate``.  ``--log_url`` tees every request and
response to a CloudEvents sink (``--log_mode``, ``--source_uri``), as
the jaxserver entry does.
"""

import argparse
import logging
import os

from kfserving_tpu_torch.predictors.llm import GenerativeModel
from kfserving_tpu_torch.server.app import ModelServer, parser as server_parser

parser = argparse.ArgumentParser(parents=[server_parser])
parser.add_argument("--model_name", default="model",
                    help="name under which the model is served")
parser.add_argument("--model_dir", required=True,
                    help="model artifact directory (local path or file://)")
parser.add_argument("--log_url", default=None,
                    help="CloudEvents sink for payload logging")
parser.add_argument("--log_mode", default="all",
                    choices=["all", "request", "response"])
parser.add_argument("--source_uri", default="",
                    help="CloudEvents source attribute")
parser.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, cuda:N or cpu)")


def build_server(args) -> ModelServer:
    server = ModelServer(http_port=args.http_port,
                         container_concurrency=args.container_concurrency,
                         grpc_port=args.grpc_port)
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
    model = GenerativeModel(args.model_name, args.model_dir,
                            device=args.device)
    server = build_server(args)
    if os.environ.get("KFS_STANDBY"):
        # Recycle fast swap: the load (device init, compile) waits for
        # POST /standby/activate, once the predecessor released the card.
        server.standby_model(lambda: (model.load(), model)[1])
        server.start([])
    else:
        model.load()
        server.start([model])


if __name__ == "__main__":
    main()
