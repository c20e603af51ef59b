"""``python -m kfserving_tpu_torch.predictors.xgbserver``: serve one
xgboost artifact directory on the host.

    python -m kfserving_tpu_torch.predictors.xgbserver \
        --model_name m --model_dir /path/with/model.json --http_port 8080

Unknown arguments (the orchestrator's ``--device``) are ignored.
"""

import argparse
import logging

from kfserving_tpu_torch.predictors.xgbserver.model import XGBoostModel
from kfserving_tpu_torch.server.app import ModelServer, parser as server_parser

parser = argparse.ArgumentParser(parents=[server_parser])
parser.add_argument("--model_name", default="model")
parser.add_argument("--model_dir", required=True)
parser.add_argument("--nthread", default=1, type=int)


def main(argv=None) -> None:
    args, _ = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = XGBoostModel(args.model_name, args.model_dir, args.nthread)
    model.load()
    ModelServer(http_port=args.http_port,
                container_concurrency=args.container_concurrency
                ).start([model])


if __name__ == "__main__":
    main()
