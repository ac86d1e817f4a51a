"""A worker that ``parallel/launch.py`` starts for a training CLI's
``-mesh D``, with the host's available memory read as LM_STUB_AVAILABLE
bytes: it runs ``cli.train_reconstruction`` as the launcher asked and writes
what its dataset's ``preload`` kept, with its budget, to
LM_OUT_DIR/<LM_PROCESS_ID>.json.

Env: the launcher's LM_COORDINATOR, LM_NUM_PROCESSES, LM_PROCESS_ID and
LM_LOCAL_PROCESSES; LM_STUB_AVAILABLE, LM_OUT_DIR.
"""

import json
import os
import sys

from lecturemath_tpu_torch.cli import train_reconstruction
from lecturemath_tpu_torch.train import dataset as dataset_module

dataset_module.available_memory = lambda: int(
    os.environ["LM_STUB_AVAILABLE"])
real_preload = dataset_module.LectureNetDataset.preload


def preload(self, verbose=False):
    real_preload(self, verbose)
    path = os.path.join(os.environ["LM_OUT_DIR"],
                        f"{os.environ['LM_PROCESS_ID']}.json")
    with open(path, "w") as f:
        json.dump(dict(self.data_stats,
                       budget=dataset_module.preload_budget()), f)


dataset_module.LectureNetDataset.preload = preload

if __name__ == "__main__":
    train_reconstruction.main(["train_reconstruction", *sys.argv[1:]])
