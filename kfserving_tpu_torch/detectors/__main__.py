"""``python -m kfserving_tpu_torch.detectors``: a standalone detector
server, the sink of an InferenceService's payload logger.

    python -m kfserving_tpu_torch.detectors \
        --model_name cifar10-od --detector_type outlier \
        --storage_uri file:///path/with/train.npy --http_port 8082

Then in the isvc spec: "logger": {"url": "http://host:8082/v1/models/
cifar10-od:predict", "mode": "request"}.
"""

import argparse
import logging

from kfserving_tpu_torch.detectors import DETECTOR_TYPES, build_detector
from kfserving_tpu_torch.server.app import ModelServer, parser as server_parser

parser = argparse.ArgumentParser(parents=[server_parser])
parser.add_argument("--model_name", default="detector")
parser.add_argument("--detector_type", default="outlier",
                    choices=DETECTOR_TYPES)
parser.add_argument("--storage_uri", required=True,
                    help="artifact dir with train.npy (+ optional "
                         "outlier.json / drift.json)")
parser.add_argument("--alert_url", default=None,
                    help="POST an alert CloudEvent here on detection "
                         "(outlier type only)")


def main(argv=None):
    args, _ = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    model = build_detector(args.model_name, args.detector_type,
                           args.storage_uri, alert_url=args.alert_url)
    model.load()
    ModelServer(http_port=args.http_port,
                container_concurrency=args.container_concurrency
                ).start([model])


if __name__ == "__main__":
    main()
