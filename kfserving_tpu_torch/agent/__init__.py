"""Agent capabilities of the port, in-process.

Port of ``kfserving_tpu/agent``.  The reference runs these in a Go
sidecar; here they are asyncio services of the model server process,
which hand models straight to its repository:

- logger.py:     CloudEvents request/response tee with a bounded queue
                 and a fixed worker pool (5 workers, queue 100).
- downloader.py: idempotent artifact download with SUCCESS.<sha> markers.
- watcher.py:    model-config file watcher (models.json, or a directory
                 holding one).
- puller.py:     per-model serialized load/unload pipeline.
"""

from kfserving_tpu_torch.agent.downloader import Downloader  # noqa: F401
from kfserving_tpu_torch.agent.logger import LogMode, RequestLogger  # noqa: F401
from kfserving_tpu_torch.agent.puller import Puller  # noqa: F401
from kfserving_tpu_torch.agent.watcher import ModelConfigWatcher  # noqa: F401
