"""Worker process for tests/test_torch_multiprocess.py: one process of a
2-process gloo world of the port (one CPU device each, a 2x1 mesh; two
each for a 4x1 mesh). It runs the sharded Binarizer on both meshes, both
uses of the model axis and the Binarizer on 1x2 and 2x2 meshes, the
cross-replica BatchNorm on its half of a batch, the three data-parallel training cases of
tests/_torch_mp_workload.py, and the model axis's training cases on 1x2
(a model group spanning the processes) and 2x2 (a group in each), process
0 writing each one's checkpoint, and saves what it got to LM_OUT_PATH
(.npz).

Launched as a subprocess, NOT a pytest module. Env contract:
LM_COORDINATOR, LM_NUM_PROCESSES, LM_PROCESS_ID, LM_OUT_PATH.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from lecturemath_tpu_torch.parallel.mesh import (  # noqa: E402
    MeshSpec, initialize_distributed_from_env, make_mesh, mesh_devices,
    parse_mesh_arg, shutdown_distributed, warmup_collectives)

import _torch_mp_workload as workload  # noqa: E402

# the model axis's training cases the two processes run on 1x2 and 2x2
AXIS_WORLD_CASES = ("live", "folded", "clipped")


def main():
    torch.set_num_threads(1)
    assert initialize_distributed_from_env("cpu")
    spec = MeshSpec(int(os.environ["LM_NUM_PROCESSES"]), 1)
    mesh = make_mesh(spec, mesh_devices("cpu", spec))
    assert len(mesh.local_devices) == 1 and mesh.device_count == spec.data
    warmup_collectives(mesh)
    frames = workload.make_frames()
    out = {"binary": workload.run_inference(frames, mesh)}
    # 2 CPU replicas a process: the rows split inside each process, then
    # across the processes
    wide = MeshSpec(2 * spec.data, 1)
    out["binary_2x2"] = workload.run_inference(
        frames, make_mesh(wide, mesh_devices("cpu", wide)))
    # the model axis: a 1x2 mesh whose model group spans the two
    # processes (one CPU shard each), and 2x2 with a group in each
    for text in ("1x2", "2x2"):
        spec = parse_mesh_arg(text)
        model_mesh = make_mesh(spec, mesh_devices("cpu", spec))
        warmup_collectives(model_mesh)
        for flag in workload.MODEL_AXIS_FLAGS:
            out[f"{flag}_{text}/binary"], out[f"{flag}_{text}/map"] = \
                workload.run_model_axis(frames, model_mesh, flag)
        out[f"binary_{text}"] = workload.run_inference(frames, model_mesh)
        out[f"binary_{text}/start"] = workload.run_inference(
            frames, model_mesh, "start")
        # a mesh made again reuses the world's sub-groups
        again = make_mesh(spec, mesh_devices("cpu", spec))
        assert (again.model_group, again.data_group) == \
            (model_mesh.model_group, model_mesh.data_group)
        for case in AXIS_WORLD_CASES:
            losses, state = workload.run_axis_training(
                case, model_mesh, checkpoint=os.environ["LM_OUT_PATH"]
                + f".{text}.{case}.msgpack")
            out[f"axis_{text}_{case}/losses"] = np.asarray(losses)
            for key, value in state.items():
                out[f"axis_{text}_{case}/{key}"] = value
    rows = slice(4 * mesh.rank, 4 * mesh.rank + 4)
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        got = workload.run_batch_norm(dtype, rows, dist.group.WORLD)
        out.update({f"bn_{name}/{key}": value for key, value in got.items()})
    for case in workload.TRAIN_CASES:
        losses, state = workload.run_training(case, mesh)
        out[f"{case}/losses"] = np.asarray(losses)
        for key, value in state.items():
            out[f"{case}/{key}"] = value
    np.savez(os.environ["LM_OUT_PATH"], **out)
    print(f"[proc {mesh.rank}] done", flush=True)
    shutdown_distributed()


if __name__ == "__main__":
    main()
