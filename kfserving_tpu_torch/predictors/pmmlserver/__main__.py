"""``python -m kfserving_tpu_torch.predictors.pmmlserver``: serve one
PMML artifact directory on the host.

    python -m kfserving_tpu_torch.predictors.pmmlserver \
        --model_name m --model_dir /path/with/model.pmml --http_port 8080

Unknown arguments (the orchestrator's ``--device``) are ignored.
"""

import argparse
import logging

from kfserving_tpu_torch.predictors.pmmlserver.model import PMMLModel
from kfserving_tpu_torch.server.app import ModelServer, parser as server_parser

parser = argparse.ArgumentParser(parents=[server_parser])
parser.add_argument("--model_name", default="model")
parser.add_argument("--model_dir", required=True)


def main(argv=None) -> None:
    args, _ = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = PMMLModel(args.model_name, args.model_dir)
    model.load()
    ModelServer(http_port=args.http_port,
                container_concurrency=args.container_concurrency
                ).start([model])


if __name__ == "__main__":
    main()
