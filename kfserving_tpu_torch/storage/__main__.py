"""Storage-initializer entry point:

    python -m kfserving_tpu_torch.storage <src-uri> <dest-dir>

Port of ``kfserving_tpu/storage/__main__.py``: downloads a model artifact
to a local directory before the serving process starts (the
init-container role), standalone or from any process supervisor.
"""

import logging
import sys

from kfserving_tpu_torch.storage import Storage

logging.basicConfig(level=logging.INFO)

if __name__ == "__main__":
    if len(sys.argv) != 3:
        print("usage: python -m kfserving_tpu_torch.storage <src-uri> "
              "<dest-dir>", file=sys.stderr)
        sys.exit(2)
    src, dest = sys.argv[1], sys.argv[2]
    logging.info("Initializing, args: src_uri [%s] dest_path [%s]",
                 src, dest)
    Storage.download(src, dest)
