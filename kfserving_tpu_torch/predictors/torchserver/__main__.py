"""``python -m kfserving_tpu_torch.predictors.torchserver``: serve one
PyTorch model directory (a class file and ``model.pt``) on the card.

    python -m kfserving_tpu_torch.predictors.torchserver --model_name m \
        --model_dir /path/to/model --model_class_name Net --device cuda
"""

import argparse
import logging

from kfserving_tpu_torch.predictors.torchserver.model import PyTorchModel
from kfserving_tpu_torch.server.app import ModelServer, parser as server_parser

parser = argparse.ArgumentParser(parents=[server_parser])
parser.add_argument("--model_name", default="model")
parser.add_argument("--model_dir", required=True)
parser.add_argument("--model_class_name", default="PyTorchModel")
parser.add_argument("--device", default="cuda",
                    help="torch device to serve on (cuda, cuda:N or cpu)")


def main(argv=None) -> None:
    args, _ = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = PyTorchModel(args.model_name, args.model_dir,
                         args.model_class_name, device=args.device)
    model.load()
    ModelServer(http_port=args.http_port,
                container_concurrency=args.container_concurrency
                ).start([model])


if __name__ == "__main__":
    main()
