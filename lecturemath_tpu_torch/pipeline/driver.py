"""Pipeline driver: config + lecture DB + stage artifact relay + CLI filters.

Equivalent of the reference ConsoleUIProcess (reference:
AccessMath/preprocessing/user_interface/console_ui_process.py:13-290) with the
same CLI surface — ``script config [-l lecture...] [-d dataset...]
[-i prefix] [-o prefix] [-key value]`` — and the same on-disk artifact tree
(<OUTPUT_PATH>/<db.temporal>/<prefix><lecture_id>.dat), so reference configs
and databases run unchanged.

Conscious fix vs the reference: ``-o`` overrides the *output* prefix here
(the reference buggily overwrites the input prefix, console_ui_process.py:72-73).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterator, List, Optional, Sequence, Union

from ..core.artifacts import ArtifactStore
from ..core.config import Config, parse_cli_overrides
from ..core.metadata import LectureInfo, MetaDataDB
from ..core.timing import StageTimer, torch_trace

Prefixes = Union[None, str, List[str]]


class PipelineDriver:
    def __init__(self, config: Config, params: dict,
                 input_prefixes: Prefixes, output_prefixes: Prefixes):
        self.config = config
        self.params = params
        self.input_prefixes = input_prefixes
        self.output_prefixes = output_prefixes

        self.database: Optional[MetaDataDB] = None
        self.current_lecture: Optional[LectureInfo] = None
        self.timer = StageTimer()

    # --------------------------------------------------------------- setup

    @classmethod
    def from_config_path(cls, config_path: str, argv: Sequence[str],
                         input_keys: Prefixes, output_keys: Prefixes
                         ) -> "PipelineDriver":
        config = Config.from_file(config_path)

        def resolve(keys):
            if keys is None:
                return None
            if isinstance(keys, list):
                return [config.get(k) for k in keys]
            return config.get(keys)

        params = parse_cli_overrides(list(argv))
        driver = cls(config, params, resolve(input_keys), resolve(output_keys))

        # a bare "-i"/"-o" flag parses as the boolean True — catch the
        # forgotten value here instead of failing later on a non-string
        # artifact prefix
        for flag in ("i", "o"):
            if params.get(flag) is True:
                raise ValueError(f"-{flag} requires one or more artifact "
                                 f"prefixes (e.g. -{flag} tempo_binary_)")
        if "i" in params:
            driver.input_prefixes = params["i"]
        if "o" in params:
            driver.output_prefixes = params["o"]

        driver.initialize()
        return driver

    def initialize(self) -> None:
        db_path = self.config.get_str("VIDEO_DATABASE_PATH")
        self.database = MetaDataDB.from_file(db_path)

    # --------------------------------------------------------------- paths

    @property
    def output_root(self) -> str:
        return self.config.get_str("OUTPUT_PATH", "output")

    @property
    def temporal_dir(self) -> str:
        return os.path.join(self.output_root, self.database.output_temporal)

    @property
    def images_dir(self) -> str:
        return os.path.join(self.output_root, self.database.output_images)

    @property
    def summaries_dir(self) -> str:
        return os.path.join(self.output_root, self.database.output_summaries)

    @property
    def store(self) -> ArtifactStore:
        return ArtifactStore(self.temporal_dir)

    def video_paths(self, lecture: LectureInfo) -> List[str]:
        video_root = self.config.get_str("VIDEO_FILES_PATH", "")
        return [os.path.join(video_root, video["path"])
                for video in lecture.main_videos]

    def frame_source(self, lecture: LectureInfo):
        """Build the lecture's frame source: pre-exported image lists when
        the lecture input is a frame directory, video decode otherwise.

        Image-list mode (reference: console_ui_process.py:188
        start_image_list_preprocessing + image_list_processor.py:81) is
        selected when the OUTPUT_FRAME_EXPORT config key names a directory
        holding <lecture.title>/ frame exports, or when the lecture's main
        "video" path itself resolves to a directory (with an optional
        reference index.json for time/index metadata)."""
        from .video import ImageListSource, VideoFrameSource

        extension = self.config.get_str("FRAME_EXPORT_EXTENSION", ".png")
        export_root = self.config.get_str("OUTPUT_FRAME_EXPORT", "")
        if export_root:
            image_dir = os.path.join(export_root, lecture.title)
            if os.path.isdir(image_dir):
                return ImageListSource(image_dir, extension,
                                       lecture.forced_resolution)
        paths = self.video_paths(lecture)
        if len(paths) == 1 and os.path.isdir(paths[0]):
            return ImageListSource(paths[0], extension,
                                   lecture.forced_resolution)
        return VideoFrameSource(
            paths, self.config.get_float("SAMPLING_FPS", 1.0),
            lecture.forced_resolution,
            alignment=self.config.get_str("SAMPLING_ALIGNMENT", "start"))

    # ------------------------------------------------------------- lectures

    def iter_lectures(self) -> Iterator[LectureInfo]:
        # bare "-l"/"-d" flags (value forgotten) parse as the boolean True
        for flag, noun in (("l", "lecture title"), ("d", "dataset name")):
            if self.params.get(flag) is True:
                raise ValueError(f"-{flag} requires one or more {noun}s "
                                 f"(e.g. -{flag} lecture_01)")

        only_lectures = self.params.get("l")
        if only_lectures is not None and not isinstance(only_lectures, list):
            only_lectures = [only_lectures]
        if only_lectures is not None:
            only_lectures = [name.lower() for name in only_lectures]

        dataset_names = self.params.get("d")
        if dataset_names is not None and not isinstance(dataset_names, list):
            dataset_names = [dataset_names]
        dataset_lectures = None
        if dataset_names is not None:
            dataset_lectures = set()
            for name in dataset_names:
                dataset = self.database.get_dataset(name)
                if dataset is None:
                    raise ValueError(f"invalid dataset name <{name}>")
                dataset_lectures.update(t.lower() for t in dataset.lecture_titles)

        # multi-host sharding: "-shard i/n" keeps every n-th selected
        # lecture starting at i (lectures are embarrassingly parallel across
        # hosts over DCN; artifacts land in the shared output tree)
        shard_index, shard_count = 0, 1
        if "shard" in self.params:
            shard_index, shard_count = (int(part) for part in
                                        str(self.params["shard"]).split("/"))

        # dynamic alternative: "-queue dir" claims lectures first-come-
        # first-served through a shared claim directory (parallel/
        # work_queue.py) — long lectures no longer idle the other hosts
        queue_dir = self.params.get("queue")
        if queue_dir is not None and not isinstance(queue_dir, str):
            # a bare "-queue" flag parses as True — claiming into a
            # cwd-relative directory named "True" would silently give
            # every host its own private queue (duplicate work)
            raise ValueError("-queue requires a shared directory path "
                             "(e.g. -queue /shared/claims)")
        if queue_dir is not None and "shard" in self.params:
            raise ValueError("-shard and -queue are mutually exclusive")
        # "-requeue SECONDS": recycle claims from dead hosts (and failed
        # releases) before claiming — the operator surface over
        # work_queue.requeue_stale, so restarting a crashed fleet needs
        # no manual claim-file cleanup
        requeue_age = self.params.get("requeue")
        if requeue_age is not None:
            if queue_dir is None:
                raise ValueError("-requeue requires -queue <dir>")
            # a bare "-requeue" flag parses as True, and float(True) is
            # 1.0 — which would silently recycle every live claim in a
            # running fleet; non-positive ages are the same foot-gun
            if requeue_age is True:
                raise ValueError("-requeue requires a max claim age in "
                                 "seconds (e.g. -requeue 7200)")
            try:
                requeue_age = float(requeue_age)
            except (TypeError, ValueError):
                raise ValueError("-requeue requires a max claim age in "
                                 "seconds (e.g. -requeue 7200)") from None
            if requeue_age <= 0:
                raise ValueError("-requeue age must be positive seconds "
                                 f"(got {requeue_age})")
            from ..parallel.work_queue import requeue_stale

            recycled = requeue_stale(str(queue_dir), requeue_age)
            if recycled:
                print(f"Re-queued stale claims: {', '.join(recycled)}")

        position = 0
        for lecture in self.database.lectures:
            title = lecture.title.lower()
            if only_lectures is not None or dataset_lectures is not None:
                selected = bool(only_lectures and title in only_lectures)
                selected |= bool(dataset_lectures and title in dataset_lectures)
                if not selected:
                    print(f"Skipping <{lecture.title}>")
                    continue
            if position % shard_count != shard_index:
                position += 1
                print(f"Skipping <{lecture.title}> (other shard)")
                continue
            position += 1
            if queue_dir is not None:
                from ..parallel.work_queue import claim, release

                if not claim(str(queue_dir), lecture.title):
                    print(f"Skipping <{lecture.title}> (claimed elsewhere)")
                    continue
                print(f"Processing <{lecture.title}> (claimed)")
                self.current_lecture = lecture
                try:
                    yield lecture
                except GeneratorExit:
                    # consumer stopped (break or error unwinding) — we
                    # cannot tell whether this lecture completed; leave
                    # the claim in-progress for requeue_stale to recycle
                    raise
                release(str(queue_dir), lecture.title, ok=True)
                continue
            print(f"Processing <{lecture.title}>")
            self.current_lecture = lecture
            yield lecture

    # --------------------------------------------------------------- stages

    def load_inputs(self, lecture: LectureInfo) -> Any:
        if self.input_prefixes is None:
            return None
        if isinstance(self.input_prefixes, list):
            return [self.store.load(prefix, lecture.id)
                    for prefix in self.input_prefixes]
        return self.store.load(self.input_prefixes, lecture.id)

    def save_outputs(self, lecture: LectureInfo, results: Any) -> None:
        if self.output_prefixes is None:
            return
        if isinstance(self.output_prefixes, list):
            for prefix, result in zip(self.output_prefixes, results):
                self.store.save(result, prefix, lecture.id)
        else:
            self.store.save(results, self.output_prefixes, lecture.id)

    def trace(self):
        """The capture ``-trace <dir>`` asks for: a torch profiler trace,
        with the port's spans, into ``<dir>/trace.json`` (core/timing.py
        torch_trace); without the option, a no-op."""
        trace_dir = self.params.get("trace")
        return torch_trace(trace_dir if isinstance(trace_dir, str) else None)

    def run(self, process_fn: Callable[["PipelineDriver", LectureInfo, Any], Any]
            ) -> None:
        """Run a stage function over all selected lectures, relaying
        artifacts (the start_input_processing equivalent). Pass
        ``-trace <dir>`` on the CLI to capture a torch profiler trace of
        the stage."""
        with self.trace():
            for lecture in self.iter_lectures():
                inputs = self.load_inputs(lecture)
                with self.timer.measure(lecture.title):
                    results = process_fn(self, lecture, inputs)
                print(f"Lecture done in "
                      f"{self.timer.totals[lecture.title]:.2f}s")
                self.save_outputs(lecture, results)


def usage_check(argv: Sequence[str], require_config: bool = True) -> bool:
    if len(argv) < 2:
        print(f"Usage: python {argv[0]} config [options]")
        print("Options:")
        print("\t-l [lecture(s)] : process only the given lecture(s)")
        print("\t-d [dataset(s)] : process only the given dataset(s)")
        print("\t-i prefix       : override input artifact prefix")
        print("\t-o prefix       : override output artifact prefix")
        return False
    return True
