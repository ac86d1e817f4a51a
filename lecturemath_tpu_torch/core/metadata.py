"""Dataset registry: lectures, video paths, named train/test splits.

Reads the reference's AccessMath XML database format (reference:
AccessMath/data/meta_data_DB.py:6-146, AccessMath/data/lecture_info.py:3-123;
canonical instance lecture_data/db_LectureMath.xml) so existing lecture
databases work unchanged.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional


@dataclass
class LectureInfo:
    id: str
    title: str
    parameters: Dict[str, Any] = field(default_factory=dict)
    main_videos: List[Dict[str, Any]] = field(default_factory=list)
    aux_videos: List[Dict[str, Any]] = field(default_factory=list)
    metadata: Dict[str, str] = field(default_factory=dict)

    @property
    def forced_resolution(self) -> Optional[tuple]:
        if "forced_width" in self.parameters:
            return self.parameters["forced_width"], self.parameters["forced_height"]
        return None

    @classmethod
    def from_xml(cls, node: ET.Element) -> "LectureInfo":
        lecture = cls(
            id=node.findtext("Id"),
            title=node.findtext("Title"),
        )

        params = node.find("Parameters")
        if params is not None:
            force_res = params.find("ForceResolution")
            if force_res is not None:
                lecture.parameters["forced_width"] = int(force_res.findtext("Width"))
                lecture.parameters["forced_height"] = int(force_res.findtext("Height"))
            sync_window = params.findtext("SyncWindow")
            if sync_window is not None:
                lecture.parameters["sync_window"] = float(sync_window)
            binarization = params.findtext("Binarization")
            if binarization is not None:
                lecture.parameters["binarization"] = int(binarization)

        meta = node.find("MetaData")
        if meta is not None:
            for child in meta:
                lecture.metadata[child.tag.lower()] = child.text

        videos = node.find("Videos")
        if videos is not None:
            for group_tag, target in (("Main", lecture.main_videos),
                                      ("Auxiliary", lecture.aux_videos)):
                group = videos.find(group_tag)
                if group is None:
                    continue
                for video_node in group:
                    video = {child.tag.lower(): child.text for child in video_node}
                    video.update(video_node.attrib)
                    video.setdefault("type", "video")
                    video.setdefault("format", None)
                    video.setdefault("path", None)
                    target.append(video)

        return lecture


@dataclass
class DataSet:
    name: str
    lecture_titles: List[str]
    lectures: List[LectureInfo] = field(default_factory=list)

    def __contains__(self, lecture: LectureInfo) -> bool:
        return lecture in self.lectures or lecture.title in self.lecture_titles


class MetaDataDB:
    def __init__(self, name: str):
        self.name = name
        self.output_temporal = "temporal"
        self.output_images = "images"
        self.output_videos = "videos"
        self.output_annotations = "annotations"
        self.output_summaries = "summaries"
        self.lectures: List[LectureInfo] = []
        self.datasets: Dict[str, DataSet] = {}
        self.indexing = None  # Optional[IndexingInfo]

    @classmethod
    def from_file(cls, path: str) -> "MetaDataDB":
        return cls.from_xml(ET.parse(path).getroot())

    @classmethod
    def from_xml(cls, root: ET.Element) -> "MetaDataDB":
        data = root.find("DataBase")
        db = cls(data.findtext("Name"))

        outputs = data.find("OutputPaths")
        if outputs is not None:
            db.output_temporal = outputs.findtext("Temporal", db.output_temporal)
            db.output_images = outputs.findtext("Images", db.output_images)
            db.output_videos = outputs.findtext("Videos", db.output_videos)
            db.output_annotations = outputs.findtext("Annotations", db.output_annotations)
            db.output_summaries = outputs.findtext("Summaries", db.output_summaries)

        lectures_node = data.find("Lectures")
        if lectures_node is not None:
            for lecture_node in lectures_node.findall("Lecture"):
                db.lectures.append(LectureInfo.from_xml(lecture_node))

        by_title = {lecture.title.lower(): lecture for lecture in db.lectures}
        datasets_node = data.find("Datasets")
        if datasets_node is not None:
            for dataset_node in datasets_node:
                titles = [t.text for t in dataset_node.findall("LectureTitle")]
                dataset = DataSet(dataset_node.tag, titles)
                dataset.lectures = [by_title[t.lower()] for t in titles
                                    if t.lower() in by_title]
                db.datasets[dataset_node.tag.lower()] = dataset

        indexing_root = data.find("LectureIndexing")
        if indexing_root is not None and len(indexing_root):
            from ..data.indexing_info import IndexingInfo

            db.indexing = IndexingInfo.from_xml(indexing_root)

        return db

    def get_dataset(self, name: str) -> Optional[DataSet]:
        return self.datasets.get(name.lower())

    def get_lecture(self, title: str) -> Optional[LectureInfo]:
        title = title.lower()
        for lecture in self.lectures:
            if lecture.title.lower() == title:
                return lecture
        return None
