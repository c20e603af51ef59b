"""Transformer example: preprocess images, proxy predict to the predictor.

Port of ``examples/image_transformer.py`` on the port's ``Model`` and
``ModelServer``.  It mirrors the reference sample (reference
docs/samples/v1alpha2/transformer/image_transformer/image_transformer/
image_transformer.py:45-53 — a KFModel subclass overriding preprocess
only; predict proxies to predictor_host over the cluster-local gateway,
reference kfmodel.py:88-104).  The preprocess is plain numpy on the host:
the predictor behind it does the device work.

Run:
    python -m kfserving_tpu_torch.examples.image_transformer \
        --predictor_host localhost:8080 --http_port 8081
"""

import argparse
import logging

import numpy as np

from kfserving_tpu_torch.model.model import Model
from kfserving_tpu_torch.server.app import ModelServer, parser as server_parser

MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


class ImageTransformer(Model):
    """Scales uint8 HWC images to the predictor's normalized float input."""

    def __init__(self, name: str, predictor_host: str):
        super().__init__(name)
        self.predictor_host = predictor_host
        self.ready = True

    async def preprocess(self, request):
        request = await super().preprocess(request)  # CloudEvent unwrap
        instances = request.get("instances", [])
        out = []
        for inst in instances:
            raw = np.asarray(inst)
            arr = raw.astype(np.float32)
            if arr.size and np.issubdtype(raw.dtype, np.integer):
                # Integer payloads are 0-255 pixel values; float payloads
                # are taken as already scaled to [0, 1].
                arr = arr / 255.0
            arr = (arr - MEAN) / STD
            out.append(arr)
        # Arrays stay dense: the proxy hop rides the V2 binary wire
        # instead of re-encoding megabytes of float text (model.py).
        return {"instances": out}


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(parents=[server_parser])
    parser.add_argument("--model_name", default="model")
    parser.add_argument("--predictor_host", required=True)
    args, _ = parser.parse_known_args(argv)
    logging.basicConfig(level=logging.INFO)
    transformer = ImageTransformer(args.model_name,
                                   predictor_host=args.predictor_host)
    ModelServer(http_port=args.http_port).start([transformer])


if __name__ == "__main__":
    main()
