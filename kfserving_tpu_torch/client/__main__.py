"""`python -m kfserving_tpu_torch.client` — the kfs CLI."""

import sys

from kfserving_tpu_torch.client.cli import main

if __name__ == "__main__":
    sys.exit(main())
