"""Dynamic lecture scheduling across hosts: a filesystem claim queue.

The static ``-shard i/n`` split (reference has no multi-host story at
all; ours mirrors embarrassing parallelism over lectures) assigns every
n-th lecture to a host regardless of runtime — one long lecture can
leave the other hosts idle. ``-queue <dir>`` replaces the static split
with dynamic work-stealing: every host runs the same CLI against the
same shared directory (NFS/GCS-fuse on a pod), and each lecture is
processed by whichever host CLAIMS it first.

Claims are atomic file creations (``O_CREAT | O_EXCL`` — atomic on POSIX
and NFSv3+), so no coordinator process is needed and the mechanism
composes with any number of hosts joining or leaving mid-run. A claim
records host/pid/time for operability; ``release`` marks completion
(claim file gains a ``done`` marker) and crashed hosts' stale claims can
be re-queued with ``requeue_stale``.
"""

from __future__ import annotations

import json
import os
import socket
import time
from typing import List, Optional


def _claim_path(queue_dir: str, item_id: str) -> str:
    safe = "".join(ch if ch.isalnum() or ch in "-_." else "_"
                   for ch in item_id)
    return os.path.join(queue_dir, f"{safe}.claim")


def claim(queue_dir: str, item_id: str) -> bool:
    """Try to claim one work item; True if THIS process owns it now."""
    os.makedirs(queue_dir, exist_ok=True)
    path = _claim_path(queue_dir, item_id)
    try:
        handle = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    with os.fdopen(handle, "w") as f:
        json.dump({"item": item_id, "host": socket.gethostname(),
                   "pid": os.getpid(), "claimed_at": time.time()}, f)
    return True


def release(queue_dir: str, item_id: str, ok: bool = True) -> None:
    """Mark a claimed item finished (or failed — failed items stay
    claimed so the failure is visible; requeue_stale can recycle them).
    The rewrite is atomic (temp file + os.replace): a crash mid-write
    must not leave a truncated claim that every host then skips."""
    path = _claim_path(queue_dir, item_id)
    try:
        with open(path) as f:
            record = json.load(f)
    except (OSError, ValueError):
        record = {"item": item_id}
    record["done"] = bool(ok)
    record["finished_at"] = time.time()
    # hostname + pid: pids alone can collide across hosts sharing the
    # queue directory, and a shared temp name would interleave writes
    tmp = f"{path}.{socket.gethostname()}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(record, f)
    os.replace(tmp, path)


def queue_state(queue_dir: str) -> dict:
    """{item: record} for every claim file in the queue directory."""
    state = {}
    if not os.path.isdir(queue_dir):
        return state
    for name in os.listdir(queue_dir):
        if not name.endswith(".claim"):
            continue
        try:
            with open(os.path.join(queue_dir, name)) as f:
                record = json.load(f)
        except (OSError, ValueError):
            continue
        state[record.get("item", name[:-6])] = record
    return state


def requeue_stale(queue_dir: str, max_age_s: float,
                  now: Optional[float] = None) -> List[str]:
    """Delete claims older than ``max_age_s`` that never finished
    (done missing: the claiming host presumably died mid-lecture) or
    that finished with done=False (failed — release() keeps them visible
    and this recycles them); returns the re-queued item ids. Run from
    any host before/while claiming."""
    now = time.time() if now is None else now
    requeued = []
    for item, record in queue_state(queue_dir).items():
        if record.get("done") is True:
            continue
        failed = record.get("done") is False
        if failed or now - record.get("claimed_at", now) > max_age_s:
            path = _claim_path(queue_dir, item)
            try:
                # re-read right before unlinking: since queue_state was
                # read, another host may have requeued AND re-claimed the
                # item (fresh claimed_at), or the slow-but-alive claimer
                # may have finished it (done now True). Any change means
                # the stale verdict is outdated — deleting would either
                # double-process the lecture or destroy a completion
                # marker. The remaining read->unlink window is inherent
                # to a coordinator-free file queue; max_age_s should be
                # chosen >> a lecture's runtime so it stays theoretical.
                with open(path) as f:
                    current = json.load(f)
                if current != record:
                    continue
                os.unlink(path)
                requeued.append(item)
            except (OSError, ValueError):
                pass   # another host got there first
    return requeued
