"""Full-lecture drive of the PyTorch port (lecturemath_tpu_torch): production
widths through the port's real CLIs on the card, end to end. It is the
port's counterpart of flagship_drive.py, phase by phase and with the same
names, and shares no code with it.

One scripted run of the full user story at the flagship model size (FCN
widths 48..768, pixel kernel 7, the reference's production configuration —
reference: FCN_lecturenet.py:371-431 defaults via train config):

  1. build a full-scale synthetic 1080p lecture workspace (real MJPG video
     file, 20 boards / 2,400 unique CCs / >=20 GT keyframes)
  2. TRAIN a production-width checkpoint briefly on the card (256^2 crops
     of the decoded video vs the known GT ink), with a held-out probe
     through the inference forward (kernel K2 on the heads)
  3. run the five STAGED CLIs (binarize on the card, 02-05 on the host)
     with per-step walls, then the fused express run_pipeline CLI
  4. author a GT annotation tree from the synthetic ground truth
     (eval/gt_authoring.export_gt_tree)
  5. run BOTH eval protocols at the user surface:
     scripts_torch/lecturenet_eval_keyframe_bin.py (binarizes the GT
     keyframes with the trained model on the card; CC + pixel metric
     tables) and cli.eval_summaries (scores the pipeline's exported summary
     against the GT tree)
  6. write this run's section of FLAGSHIP_DRIVE_TORCH.md (one section per
     frame count and resolution): each step's wall, its child's peak RSS
     and, for the steps on the card, the card's peak memory and the
     kernels' launches, beside the card's name and power limit, and both
     metric tables

Usage:
  python flagship_drive_torch.py [workdir] [-device cpu]   # full drive
  python flagship_drive_torch.py --train <workdir> [-device cpu]
  python flagship_drive_torch.py --gt <workdir>

The device steps run on the card; ``-device cpu`` runs them on the CPU and
is forwarded to every step. Without a card and without it, the drive
raises before it renders the lecture. Every step is a child process: the
drive's own --train and --gt modes, and ``flagship_drive_torch.py --child
<python arguments>`` for the CLIs and the wrapper script, which runs the
module or script in its own process as ``python -m`` or ``python script``
would (``runpy``). Each child prints, as its last line, its peak RSS, the
port's kernel launch counts and, where it used the card, the card's peak
memory. The report goes to FLAGSHIP_DRIVE_TORCH.md at the repository root,
or into the workdir under LM_FLAGSHIP_TINY. The workdir defaults to
``flagship_torch_ws`` in the temporary directory (TMPDIR); the drive reuses
the workspace it finds there only if its recipe.json names this recipe,
and raises otherwise.
"""

import json
import os
import re
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
ME = os.path.abspath(__file__)

DB_NAME = "FlagDB"
LECTURE = "flag01"

# the real AccessMath regime scaled to one drive: 1080p source (2.07 MP —
# below the 2.5 MP cap, so the net runs UNHALVED at full resolution),
# 20 write/erase cycles -> >=20 GT keyframes, 2,400 unique CCs.
# Env-overridable so the test suite can smoke the orchestration tiny.
N_FRAMES = int(os.environ.get("LM_FLAGSHIP_FRAMES", "1200"))
HEIGHT = int(os.environ.get("LM_FLAGSHIP_HEIGHT", "1080"))
WIDTH = int(os.environ.get("LM_FLAGSHIP_WIDTH", "1920"))
N_BOARDS = int(os.environ.get("LM_FLAGSHIP_BOARDS", "20"))
GLYPHS_PER_BOARD = int(os.environ.get("LM_FLAGSHIP_GLYPHS", "120"))
TINY = bool(os.environ.get("LM_FLAGSHIP_TINY"))

if TINY:   # suite smoke: orchestration only
    PRODUCTION_WIDTHS = {
        "DOWN_CONV_FILTERS": (2, 3, 4, 5, 6),
        "MIDDLE_CONV_FILTERS_MIDDLE": 6,
        "UPSAMPLE_FILTERS": (2, 3, 4, 5, 6),
        "UP_CONV_FILTERS": (2, 3, 4, 5, 6),
        "PIXEL_FEATURES": (3, 2),
    }
else:
    PRODUCTION_WIDTHS = {
        "DOWN_CONV_FILTERS": (48, 96, 192, 384, 768),
        "MIDDLE_CONV_FILTERS_MIDDLE": 768,
        "UPSAMPLE_FILTERS": (32, 48, 96, 192, 384),
        "UP_CONV_FILTERS": (32, 48, 96, 192, 384),
        "PIXEL_FEATURES": (32, 16),
    }

TRAIN_STEPS = int(os.environ.get("LM_FLAGSHIP_TRAIN_STEPS", "150"))
TRAIN_BATCH = 8
TRAIN_CROP = min(int(os.environ.get("LM_FLAGSHIP_CROP", "256")),
                 HEIGHT, WIDTH)

MODEL_FILE = "flagship.msgpack"
REPORT = "FLAGSHIP_DRIVE_TORCH.md"
CHILD_TAG = "flagship_child"

# The steps in the order the JAX drive runs them: (label, target,
# arguments). A target is the drive's own --train / --gt mode, a module (run
# as ``python -m``) or a script of the repository. {root}, {conf} and
# {model} stand for the workdir, its config and the trained checkpoint.
STEPS = (
    ("train checkpoint", "--train", ("{root}",)),
    ("stage01 binarize", "lecturemath_tpu_torch.cli.binarize",
     ("{conf}", "-d", "testing")),
    ("stage02 cc_analysis", "lecturemath_tpu_torch.cli.cc_analysis",
     ("{conf}", "-d", "testing")),
    ("stage03 cc_grouping", "lecturemath_tpu_torch.cli.cc_grouping",
     ("{conf}", "-d", "testing")),
    ("stage04 vid_segmentation", "lecturemath_tpu_torch.cli.vid_segmentation",
     ("{conf}", "-d", "testing")),
    ("stage05 generate_summary", "lecturemath_tpu_torch.cli.generate_summary",
     ("{conf}", "-d", "testing")),
    ("express run_pipeline", "lecturemath_tpu_torch.cli.run_pipeline",
     ("{conf}", "-d", "testing")),
    ("gt authoring", "--gt", ("{root}",)),
    ("eval keyframe_bin", "scripts_torch/lecturenet_eval_keyframe_bin.py",
     ("{conf}", "{model}", "1")),
    ("eval summaries", "lecturemath_tpu_torch.cli.eval_summaries",
     ("{conf}", "-d", "testing")),
)


def _source():
    from lecturemath_tpu_torch.utils.synthetic import \
        SyntheticRGBLectureSource

    return SyntheticRGBLectureSource(
        seed=42, n_frames=N_FRAMES, height=HEIGHT, width=WIDTH,
        n_boards=N_BOARDS, glyphs_per_board=GLYPHS_PER_BOARD, fps=1.0)


def _gt_keyframes(source):
    """GT keyframe sample indices: the last frame of each board era (the
    frame before each full erase) plus the final frame."""
    indices = sorted(int(t) - 1 for t in source.erase_times if t >= 1)
    if not indices or indices[-1] != source.n_frames - 1:
        indices.append(source.n_frames - 1)
    return indices


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        out = ""
    return out or "no card (nvidia-smi printed nothing)"


# --------------------------------------------------------------- workspace

# what the drive writes into its workdir, besides logs/ and the report
WORKSPACE_FILES = ("flagship.conf", "db.xml", "recipe.json",
                   "train_stats.json", "gt_stats.json")
WORKSPACE_DIRS = ("videos", "models", "output")


def _recipe(root):
    """What the workspace's files depend on."""
    return {"root": root, "frames": N_FRAMES, "height": HEIGHT,
            "width": WIDTH, "boards": N_BOARDS, "glyphs": GLYPHS_PER_BOARD,
            "widths": {key: list(value) if isinstance(value, tuple) else value
                       for key, value in PRODUCTION_WIDTHS.items()}}


def _check_recipe(root):
    """Raise if ``root`` holds a workspace the drive wrote with another
    recipe (or without its recipe.json): the drive reuses the video, config
    and outputs it finds, and they would not be this recipe's."""
    stamp = os.path.join(root, "recipe.json")
    try:
        with open(stamp) as f:
            if json.load(f) == _recipe(root):
                return
    except (OSError, ValueError):
        pass
    found = [name for name in WORKSPACE_FILES + WORKSPACE_DIRS
             if os.path.exists(os.path.join(root, name))]
    if found:
        raise RuntimeError(
            f"{root} holds {found} from a drive with another recipe (its "
            f"recipe.json differs from {_recipe(root)}); give the drive "
            f"another workdir or remove these")


def build_workspace(root):
    import cv2

    _check_recipe(root)
    conf_path = os.path.join(root, "flagship.conf")
    for sub in WORKSPACE_DIRS:
        os.makedirs(os.path.join(root, sub), exist_ok=True)

    source = _source()
    video_path = os.path.join(root, "videos", f"{LECTURE}.avi")
    if not os.path.exists(video_path):
        print(f"[workspace] rendering {N_FRAMES} x {WIDTH}x{HEIGHT} MJPG "
              f"frames -> {video_path}", flush=True)
        # fps=1.0: one video frame per sampled frame
        writer = cv2.VideoWriter(video_path,
                                 cv2.VideoWriter_fourcc(*"MJPG"),
                                 1.0, (WIDTH, HEIGHT))
        for t in range(N_FRAMES):
            writer.write(source.rgb_frame(t)[:, :, ::-1])
        writer.release()
        print(f"[workspace] video: "
              f"{os.path.getsize(video_path) / 1e6:.0f} MB", flush=True)

    db_path = os.path.join(root, "db.xml")
    if not os.path.exists(db_path):
        with open(db_path, "w") as f:
            f.write(f"""<AccessMath><DataBase><Name>{DB_NAME}</Name>
<OutputPaths><Temporal>temporal</Temporal><Images>images</Images>
<Videos>videos</Videos><Annotations>annotations</Annotations>
<Summaries>summaries</Summaries></OutputPaths>
<Datasets><Testing><LectureTitle>{LECTURE}</LectureTitle></Testing></Datasets>
<Lectures><Lecture><Id>{LECTURE}</Id><Title>{LECTURE}</Title>
<Parameters></Parameters>
<Videos><Main><Video><Path>{LECTURE}.avi</Path></Video></Main></Videos>
</Lecture></Lectures></DataBase></AccessMath>
""")

    if not os.path.exists(conf_path):
        lines = [
            f"VIDEO_DATABASE_PATH = {db_path}",
            f"VIDEO_FILES_PATH = {os.path.join(root, 'videos')}",
            f"OUTPUT_PATH = {os.path.join(root, 'output')}",
            "BINARIZATION_OUTPUT = tempo_binary_",
            "CC_STABILITY_OUTPUT = tempo_stability_",
            "CC_RECONSTRUCTED_OUTPUT = tempo_bin_reconstructed_",
            "CC_CONFLICTS_OUTPUT = tempo_cc_conflicts_",
            "CC_ST3D_OUTPUT = tempo_cc_ST3D_",
            "VIDEO_SEGMENTATION_OUTPUT = tempo_intervals_",
            "SUMMARY_KEYFRAMES_OUTPUT = tempo_segments_",
            f"BINARIZATION_FCN_LECTURENET_DIR = "
            f"{os.path.join(root, 'models')}",
            f"BINARIZATION_FCN_LECTURENET_FILENAME = {MODEL_FILE}",
            "FCN_BINARIZER_NET_KERNEL_SIZE = 3",
            "FCN_BINARIZER_NET_PIXEL_KERNEL_SIZE = 7",
            "UPLOAD_FORMAT = auto",
            "SAMPLING_FPS = 1.0",
            "CC_STABILITY_MIN_RECALL = 0.85",
            "CC_STABILITY_MIN_PRECISION = 0.85",
            "CC_STABILITY_MAX_GAP = 10",
            "CC_STABILITY_MIN_TIMES = 3",
            "CC_GROUPING_MIN_IMAGE_THRESHOLD = 0.5",
            "CC_GROUPING_TEMPORAL_WINDOW = 5",
            "CC_GROUPING_MIN_RECALL = 0.5",
            "VIDEO_SEGMENTATION_METHOD = 3",
            "VIDEO_SEGMENTATION_DEL_EVENT_MIN_LENGTH = 3",
            "VIDEO_SEGMENTATION_DEL_EVENT_ADD_THRESHOLD = 0.00005",
            "VIDEO_SEGMENTATION_DEL_EVENT_THRESHOLD = 0.0008",
            f"FCN_BINARIZER_SAVE_BINARY_PATH = "
            f"{os.path.join(root, 'output', 'eval_binaries')}",
        ]
        for key, value in PRODUCTION_WIDTHS.items():
            if isinstance(value, tuple):
                lines += [f"FCN_BINARIZER_NET_{key}_{i + 1} = {v}"
                          for i, v in enumerate(value)]
            else:
                lines.append(f"FCN_BINARIZER_NET_{key} = {value}")
        with open(conf_path, "w") as f:
            f.write("\n".join(lines) + "\n")
    with open(os.path.join(root, "recipe.json"), "w") as f:
        json.dump(_recipe(root), f)
    return conf_path


# ---------------------------------------------------------------- training

def train_phase(root, device=None):
    """Brief training of the production-width net on the card, on decoded
    video crops vs GT ink: enough that binarization is LEARNED (not a
    random net), not enough to saturate logits. fp32 master weights and
    steps, as the JAX drive trains; the held-out probe runs the trained
    weights through the inference forward in bf16 (kernel K2 takes bf16
    inputs)."""
    import cv2
    import numpy as np
    import torch

    from lecturemath_tpu_torch.core.backend_probe import ensure_backend
    from lecturemath_tpu_torch.core.device import resolve_device
    from lecturemath_tpu_torch.models.convert import save_checkpoint
    from lecturemath_tpu_torch.models.fcn_lecturenet import (FCNConfig,
                                                             FCNLectureNet)
    from lecturemath_tpu_torch.train.trainer import (Trainer,
                                                     init_variables_for)

    device = resolve_device(device)
    ensure_backend(device=device)

    t0 = time.time()
    source = _source()
    video_path = os.path.join(root, "videos", f"{LECTURE}.avi")
    capture = cv2.VideoCapture(video_path)
    # train on DECODED frames (codec noise included), spread over the
    # lecture; targets from the synthetic GT at the same indices
    train_indices = list(range(3, N_FRAMES, max(1, N_FRAMES // 32)))[:32]
    frames, targets = [], []
    for t in train_indices:
        capture.set(cv2.CAP_PROP_POS_FRAMES, t)
        ok, frame = capture.read()
        assert ok, f"decode failed at {t}"
        frames.append(frame[:, :, ::-1])
        targets.append((source.binary_frame(t) == 0).astype(np.float32))
    capture.release()
    frames = np.stack(frames).astype(np.float32) / 127.5 - 1.0
    targets = np.stack(targets)[..., None]   # ink=0 / bg=1
    print(f"[train] {len(frames)} frames decoded, targets rendered in "
          f"{time.time() - t0:.2f}s", flush=True)

    t0 = time.time()
    net_config = FCNConfig(
        down_filters=PRODUCTION_WIDTHS["DOWN_CONV_FILTERS"],
        mid_filters=PRODUCTION_WIDTHS["MIDDLE_CONV_FILTERS_MIDDLE"],
        upsample_filters=PRODUCTION_WIDTHS["UPSAMPLE_FILTERS"],
        up_filters=PRODUCTION_WIDTHS["UP_CONV_FILTERS"],
        pixel_features=PRODUCTION_WIDTHS["PIXEL_FEATURES"],
        kernel_size=3, pixel_kernel_size=7)
    model = FCNLectureNet(net_config)
    model.load_state_dict(init_variables_for(
        net_config, torch.Generator().manual_seed(3)))
    trainer = Trainer(model, learning_rate=0.05, phase="binarizer",
                      device=device)
    print(f"[train] model initialised and on {device} in "
          f"{time.time() - t0:.2f}s", flush=True)

    rng = np.random.default_rng(0)
    t_train = time.time()
    losses = []
    for step in range(TRAIN_STEPS):
        img = np.empty((TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 3), np.float32)
        tgt = np.empty((TRAIN_BATCH, TRAIN_CROP, TRAIN_CROP, 1), np.float32)
        for b in range(TRAIN_BATCH):
            k = rng.integers(len(frames))
            # max(1, ...): integers(0) raises; offset 0 when crop == frame
            y = rng.integers(max(1, HEIGHT - TRAIN_CROP))
            x = rng.integers(max(1, WIDTH - TRAIN_CROP))
            img[b] = frames[k, y:y + TRAIN_CROP, x:x + TRAIN_CROP]
            tgt[b] = targets[k, y:y + TRAIN_CROP, x:x + TRAIN_CROP]
        batch = {"image": img, "target": tgt, "text_mask": tgt}
        metrics = trainer.step(batch)
        if step % 25 == 0 or step == TRAIN_STEPS - 1:
            loss = float(metrics["total"])
            losses.append([step, round(loss, 4)])
            print(f"[train] step {step}: total={loss:.4f}", flush=True)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    train_wall = time.time() - t_train
    print(f"[train] {TRAIN_STEPS} steps in {train_wall:.2f}s", flush=True)

    state = {key: value.detach().float().cpu()
             for key, value in trainer.model.state_dict().items()}
    # quality gate on a held-out full-res frame (center crop to bound
    # device memory): the drive is meaningless with an untrained net
    t0 = time.time()
    ph, pw = min(512, HEIGHT), min(768, WIDTH)
    probe_model = FCNLectureNet(net_config, compute_dtype=torch.bfloat16,
                                bn_dtype=torch.float32)
    probe_model.load_state_dict(state)
    probe_model = probe_model.to(
        device, memory_format=torch.channels_last).eval()
    probe = torch.from_numpy(np.ascontiguousarray(
        frames[:1, :ph, :pw])).permute(0, 3, 1, 2).to(device).contiguous(
            memory_format=torch.channels_last)
    with torch.no_grad():
        logits, _, _ = probe_model(probe)
    pred = torch.sigmoid(logits[:, 0].float()).cpu().numpy() * 255 >= 128
    acc = float((pred == (targets[0, :ph, :pw, 0] > 0.5)).mean())
    print(f"[train] held-out pixel acc ({ph}x{pw} crop): {acc:.4f} "
          f"(probe {time.time() - t0:.2f}s)", flush=True)

    t0 = time.time()
    model_path = os.path.join(root, "models", MODEL_FILE)
    save_checkpoint(state, model_path)
    with open(os.path.join(root, "train_stats.json"), "w") as f:
        json.dump({"steps": TRAIN_STEPS, "batch": TRAIN_BATCH,
                   "crop": TRAIN_CROP, "losses": losses,
                   "train_wall_s": round(train_wall, 1),
                   "pixel_acc": round(acc, 4),
                   "checkpoint_mb": round(
                       os.path.getsize(model_path) / 1e6, 1)}, f)
    print(f"[train] saved {model_path} "
          f"({os.path.getsize(model_path) / 1e6:.0f} MB) in "
          f"{time.time() - t0:.2f}s", flush=True)


# ---------------------------------------------------------------- GT tree

def gt_phase(root):
    import cv2
    import numpy as np
    from scipy import ndimage

    from lecturemath_tpu_torch.eval.gt_authoring import export_gt_tree

    source = _source()
    indices = _gt_keyframes(source)
    print(f"[gt] {len(indices)} GT keyframes at {indices}", flush=True)

    video_path = os.path.join(root, "videos", f"{LECTURE}.avi")
    capture = cv2.VideoCapture(video_path)
    raws, binaries, times = [], [], []
    for t in indices:
        capture.set(cv2.CAP_PROP_POS_FRAMES, t)
        ok, frame = capture.read()
        assert ok, f"decode failed at {t}"
        raws.append(frame[:, :, ::-1].copy())
        binaries.append(255 - source.binary_frame(t))   # GT ink=0 polarity
        times.append(t * 1000.0)
    capture.release()

    # era boundaries as segments (absolute frame indices; fps=1.0 so
    # sample index == video frame index)
    bounds = [0] + sorted(int(t) for t in source.erase_times
                          if 0 < t < source.n_frames) + [source.n_frames]
    segments = list(zip(bounds[:-1], bounds[1:]))

    # 8-connected components of the ink, counted with the background label
    # as cv2.connectedComponents counts them (the JAX drive's count)
    eight = np.ones((3, 3), bool)
    n_ccs = sum(int(ndimage.label(b == 0, structure=eight)[1]) + 1
                for b in binaries)
    print(f"[gt] total GT CCs across keyframes: {n_ccs}", flush=True)

    prefix = export_gt_tree(
        os.path.join(root, "output", "annotations"), DB_NAME, LECTURE,
        indices, times, binaries, raw_keyframes=raws, segments=segments,
        video_paths=(f"{LECTURE}.avi",),
        # the keyframe_bin eval loader (mirroring the reference
        # LoadDatasetKeyframes) requires the portions tree
        write_portions=True)
    with open(os.path.join(root, "gt_stats.json"), "w") as f:
        json.dump({"keyframes": len(indices), "gt_ccs": n_ccs,
                   "segments": len(segments)}, f)
    print(f"[gt] tree -> {prefix}", flush=True)


# ------------------------------------------------------------ step child

class _PeakRss:
    """This process's peak resident set: the largest resident size of
    /proc/self/statm, sampled every 10 ms from ``start()`` on by a daemon
    thread. (VmHWM is not in /proc everywhere, and a child's ``ru_maxrss``
    also counts the parent it was forked from.)"""

    INTERVAL_S = 0.01

    def __init__(self):
        self.peak = 0
        self._page = os.sysconf("SC_PAGE_SIZE")

    def _sample(self):
        with open("/proc/self/statm") as f:
            self.peak = max(self.peak, int(f.read().split()[1]) * self._page)

    def start(self):
        import threading

        def loop():
            while True:
                time.sleep(self.INTERVAL_S)
                self._sample()

        try:
            self._sample()
        except (OSError, IndexError, ValueError):
            return
        threading.Thread(target=loop, daemon=True).start()

    def mb(self):
        """The peak in MB, or None where /proc/self/statm cannot be read."""
        try:
            self._sample()
        except (OSError, IndexError, ValueError):
            return None
        return self.peak / 2**20


# the port's kernel wrappers: (count name, module, function)
KERNELS = (("threshold_pack", "lecturemath_tpu_torch.ops.postprocess",
            "threshold_pack"),
           ("conv_same_nhwc", "lecturemath_tpu_torch.ops.conv7",
            "conv_same_nhwc"),
           ("cc_label", "lecturemath_tpu_torch.ops.cc_label",
            "label_components_batch"))


def child_report(rss):
    """A step's last line: its peak RSS (``rss``, a started ``_PeakRss``),
    the port's kernel launch counts in this process and, where it used the
    card, the card's peak memory. It imports nothing: a wrapper the step
    never imported launched nothing, and a host step starts without
    torch."""
    launches = {}
    for name, module, function in KERNELS:
        loaded = sys.modules.get(module)
        launches[name] = getattr(loaded, function).launches if loaded else 0
    numbers = {"rss_mb": rss.mb(), "launches": launches}
    torch = sys.modules.get("torch")
    if torch is not None and torch.cuda.is_initialized():
        numbers["card_peak_bytes"] = torch.cuda.max_memory_allocated()
    print(json.dumps({CHILD_TAG: numbers}), flush=True)


def run_child(args):
    """``python <args>`` in this process (``-m module ...`` or ``script
    ...``, as the interpreter runs them)."""
    import runpy

    if args[0] == "-m":
        sys.argv = [args[1]] + list(args[2:])
        runpy.run_module(args[1], run_name="__main__", alter_sys=True)
    else:
        sys.argv = list(args)
        runpy.run_path(args[0], run_name="__main__")


# ------------------------------------------------------------ orchestrator

def step_command(target, args, root, conf, device=None):
    """The interpreter's arguments of one step of STEPS: the drive's own
    mode, or ``--child`` and the module (``-m``) or script with its
    arguments."""
    fill = {"root": root, "conf": conf,
            "model": os.path.join(root, "models", MODEL_FILE)}
    args = [a.format(**fill) for a in args]
    if target.startswith("--"):
        cmd = [ME, target] + args
    elif target.endswith(".py"):
        cmd = [ME, "--child", os.path.join(REPO, target)] + args
    else:
        cmd = [ME, "--child", "-m", target] + args
    return cmd + (["-device", device] if device else [])


def _run(label, cmd, log_dir, card=""):
    """Run ``python <cmd>`` as a child; returns its record: wall, exit
    code, stdout, and what the child reported on its last line (peak RSS,
    kernel launches, the card's peak memory)."""
    cmd = [sys.executable] + cmd
    print(f"\n=== {label}: {' '.join(cmd)}", flush=True)
    start = time.time()
    res = subprocess.run(cmd, cwd=REPO, text=True, capture_output=True)
    wall = time.time() - start
    log_path = os.path.join(log_dir, label.replace(" ", "_") + ".log")
    with open(log_path, "w") as f:
        f.write(res.stdout + "\n--- stderr ---\n" + res.stderr)
    record = {"wall_s": wall}
    lines = res.stdout.strip().splitlines()
    if lines and lines[-1].startswith("{") and CHILD_TAG in lines[-1]:
        record.update(json.loads(lines.pop())[CHILD_TAG])
    done = (re.findall(r"Lecture done in ([\d.]+)s", res.stdout)
            or re.findall(rf"{LECTURE}: \d+ keyframes in ([\d.]+)s",
                          res.stdout)
            or re.findall(r"Total time: ([\d.]+)s", res.stdout)
            or re.findall(r"\[train\] \d+ steps in ([\d.]+)s", res.stdout))
    if done:
        record["in_run_s"] = float(done[-1])
    record["stdout"] = "\n".join(lines) + "\n"
    print("\n".join(lines[-4:]), flush=True)
    extra = "".join(
        [f", peak RSS {record['rss_mb']:.0f} MB"
         if record.get("rss_mb") is not None else "",
         f", card peak {record['card_peak_bytes'] / 2**20:.0f} MiB"
         if "card_peak_bytes" in record else "",
         f", launches {record['launches']}" if "launches" in record
         else ""])
    print(f"=== {label}: {wall:.1f}s{extra} (exit {res.returncode}) on "
          f"{card}", flush=True)
    if res.returncode != 0:
        print(res.stdout[-2000:] + res.stderr[-2000:], flush=True)
        raise RuntimeError(f"{label} failed (exit {res.returncode}) — see "
                           f"{log_path}")
    return record


def run_steps(root, conf, device=None, card="", after=None):
    """Every step of STEPS in order; returns {label: record}. ``after(label,
    record)`` runs after each step."""
    log_dir = os.path.join(root, "logs")
    os.makedirs(log_dir, exist_ok=True)
    records = {}
    for label, target, args in STEPS:
        records[label] = _run(label, step_command(target, args, root, conf,
                                                  device), log_dir, card)
        if after is not None:
            after(label, records[label])
    return records


def _split_device(argv):
    """(arguments without ``-device X``, X or None)."""
    args = list(argv)
    if "-device" not in args:
        return args, None
    i = args.index("-device")
    if i + 1 >= len(args):
        raise SystemExit("-device requires a value (e.g. -device cpu)")
    return args[:i] + args[i + 2:], args[i + 1]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] in (["--child"], ["--train"], ["--gt"]):
        rss = _PeakRss()
        rss.start()
        if argv[0] == "--child":
            run_child(argv[1:])
        else:
            args, device = _split_device(argv[1:])
            if argv[0] == "--train":
                train_phase(os.path.abspath(args[0]), device)
            else:
                gt_phase(os.path.abspath(args[0]))
        return child_report(rss)
    args, device = _split_device(argv)

    from lecturemath_tpu_torch.core.device import resolve_device

    # the device steps run on the card unless -device cpu: fail before the
    # lecture is rendered, not after
    resolve_device(device)
    root = os.path.abspath(args[0] if args else default_workdir())
    os.makedirs(root, exist_ok=True)
    card = card_line()
    print(f"card: {card}", flush=True)

    total_start = time.time()
    t0 = time.time()
    conf = build_workspace(root)
    workspace_s = time.time() - t0
    records = run_steps(root, conf, device, card)
    report(root, records, round(time.time() - total_start, 1), card,
           workspace_s)


REPORT_TITLE = "# Full-lecture drive of the PyTorch port on the card"
REPORT_PREAMBLE = (
    "Each section below is one run of `flagship_drive_torch.py`, as the "
    "drive wrote it: production widths (48..768) through the port's real "
    "CLIs — train -> 5 staged CLIs -> express -> GT authoring -> both eval "
    "protocols. A run replaces the section of its own frame count and "
    "resolution and keeps the others. The first step on the card in a fresh "
    "checkout includes the kernels' nvcc build. Nothing here was measured "
    "on a TPU: FLAGSHIP_DRIVE.md holds the JAX drive's numbers.")
RUN_HEADING = "## Run: "


def default_workdir():
    return os.path.join(tempfile.gettempdir(), "flagship_torch_ws")


def _reproduce_line():
    knobs = sorted(f"{key}={value}" for key, value in os.environ.items()
                   if key.startswith("LM_FLAGSHIP_"))
    return " ".join(knobs + ["python3 flagship_drive_torch.py [workdir]"])


def _merge_sections(path, heading, section):
    """The report at ``path`` with ``section`` in place of the one under
    ``heading`` (or added), sections ordered by the numbers in their
    headings."""
    sections = {}
    if os.path.exists(path):
        with open(path) as f:
            text = f.read()
        if text.startswith(REPORT_TITLE):
            for part in text.split("\n" + RUN_HEADING)[1:]:
                sections[RUN_HEADING + part.split("\n", 1)[0]] = \
                    (RUN_HEADING + part).rstrip("\n")
    sections[heading] = section

    def order(key):
        return [int(n) for n in re.findall(r"\d+", key)]

    return "\n\n".join([REPORT_TITLE, REPORT_PREAMBLE]
                        + [sections[key] for key in sorted(sections,
                                                           key=order)]) + "\n"


def report(root, records, total_wall, card, workspace_s, out=None):
    """Write this run's section of the drive's report into ``out``, else
    into the workdir under LM_FLAGSHIP_TINY and into FLAGSHIP_DRIVE_TORCH.md
    at the repository root otherwise. The sections of other frame counts or
    resolutions already there are kept. Returns the report's path."""
    train_stats = json.load(open(os.path.join(root, "train_stats.json")))
    gt_stats = json.load(open(os.path.join(root, "gt_stats.json")))
    kf_dir = os.path.join(root, "output", "summaries",
                          f"{DB_NAME}_{LECTURE}", "keyframes")
    n_summary_kf = len(os.listdir(kf_dir)) if os.path.isdir(kf_dir) else 0
    video = os.path.join(root, "videos", f"{LECTURE}.avi")
    express = records["express run_pipeline"]
    express_fps = (f"{N_FRAMES / express['in_run_s']:.2f} fps in the run "
                   f"({express['in_run_s']:.2f} s), "
                   f"{N_FRAMES / express['wall_s']:.2f} over the child's "
                   f"wall" if express.get("in_run_s") else "not printed")
    below_cap = WIDTH * HEIGHT <= 2.5e6

    heading = f"{RUN_HEADING}{N_FRAMES} frames of {WIDTH}x{HEIGHT}"
    lines = [
        heading,
        "",
        f"Reproduce with `{_reproduce_line()}` (the workdir defaults to "
        f"`flagship_torch_ws` in the temporary directory; each step's log "
        f"lands in <workdir>/logs/).",
        "",
        f"- Card: {card}",
        f"- Workload: {N_FRAMES} sampled frames @ {WIDTH}x{HEIGHT} "
        f"({WIDTH * HEIGHT / 1e6:.2f} MP, "
        f"{'below' if below_cap else 'above'} the 2.5 MP cap -> the net runs "
        f"{'UNHALVED' if below_cap else 'HALVED'}), {N_BOARDS} boards, "
        f"{N_BOARDS * GLYPHS_PER_BOARD} unique CCs, MJPG video "
        f"({os.path.getsize(video) / 1e6:.0f} MB)",
        f"- Model: FCN widths "
        f"{PRODUCTION_WIDTHS['DOWN_CONV_FILTERS'][0]}.."
        f"{PRODUCTION_WIDTHS['MIDDLE_CONV_FILTERS_MIDDLE']}, "
        f"pixel kernel 7 ({train_stats['checkpoint_mb']} MB checkpoint)",
        f"- Training: {train_stats['steps']} SGD steps @ batch "
        f"{train_stats['batch']} x {train_stats['crop']}^2 in "
        f"{train_stats['train_wall_s']}s; held-out pixel acc "
        f"{train_stats['pixel_acc']}",
        f"- GT tree: {gt_stats['keyframes']} keyframes, "
        f"{gt_stats['gt_ccs']} GT CCs, {gt_stats['segments']} segments",
        f"- Summary keyframes exported: {n_summary_kf}",
        f"- Express: {express_fps}",
        f"- Workspace (render + MJPG encode, in the drive's process): "
        f"{workspace_s:.1f}s",
        f"- Total drive wall: {total_wall}s",
        "",
        "### Step walls",
        "",
        "Each step is a child process: its wall includes the interpreter, "
        "the torch import, the CUDA context and the kernels' build or load "
        "(start-up = wall - in-run, where the CLI prints its own time). "
        "Peak RSS is the child's own peak resident set (/proc/self/statm "
        "sampled every 10 ms by a thread in the child); card peak is "
        "`torch.cuda.max_memory_allocated()` in the child; launches are "
        "the child's K1 (threshold_pack) / K2 (conv_same_nhwc) / K3 "
        "(cc_label) counts.",
        "",
        "| step | on the card | wall (s) | in-run (s) | peak RSS (MB) "
        "| card peak (MiB) | K1 / K2 / K3 launches | card |",
        "|---|---|---|---|---|---|---|---|",
    ]
    for label, rec in records.items():
        in_run = (f"{rec['in_run_s']:.2f}" if "in_run_s" in rec else "—")
        rss = (f"{rec['rss_mb']:.0f}" if rec.get("rss_mb") is not None
               else "—")
        on_card = "card_peak_bytes" in rec
        peak = (f"{rec['card_peak_bytes'] / 2**20:.0f}" if on_card else "—")
        launches = (" / ".join(str(rec["launches"][name]) for name in (
            "threshold_pack", "conv_same_nhwc", "cc_label"))
                    if "launches" in rec else "—")
        lines.append(f"| {label} | {'yes' if on_card else 'no'} | "
                     f"{rec['wall_s']:.1f} | {in_run} | {rss} | {peak} | "
                     f"{launches} | {card} |")
    lines += [
        "",
        "### eval: lecturenet_eval_keyframe_bin (CC + pixel metrics, "
        "trained flagship net vs GT)",
        "",
        "```",
        records["eval keyframe_bin"]["stdout"].strip(),
        "```",
        "",
        "### eval: eval_summaries (pipeline summary vs GT tree)",
        "",
        "```",
        records["eval summaries"]["stdout"].strip(),
        "```",
    ]
    if out is None:
        # tiny smokes report into the workdir; only the real-scale drive
        # owns the committed repo artifact
        out = os.path.join(root if TINY else REPO, REPORT)
    text = _merge_sections(out, heading, "\n".join(lines))
    with open(out, "w") as f:
        f.write(text)
    print(f"\nwrote {out}", flush=True)
    return out


if __name__ == "__main__":
    main()
