"""Math-indexing configuration block of the lecture database.

Equivalent of the reference's `IndexingInfo`
(reference: AccessMath/data/indexing_info.py:3-103): the
`<LectureIndexing>` node of db.xml describing symbol-recognition and
math-information-retrieval (Tangent-S / Tangent-V) resources. Parsed so
databases carrying the node round through `MetaDataDB` unchanged; the
indexing pipelines themselves are external to both frameworks.
"""

from __future__ import annotations

import xml.etree.ElementTree as ET
from dataclasses import dataclass
from typing import Optional


@dataclass
class IndexingInfo:
    recognizer_config_filename: str
    symbolic_mir_config_filename: str
    image_mir_config_filename: str

    use_explicit_junk: Optional[int] = None
    implicit_junk_threshold: Optional[float] = None

    mapping_sim_shape_filename: Optional[str] = None
    mapping_notes_to_rec_filename: Optional[str] = None
    mapping_to_ignore_notes_filename: Optional[str] = None
    mapping_rec_to_latex_filename: Optional[str] = None

    named_hw_classifiers_filename: Optional[str] = None
    named_latex_classifiers_filename: Optional[str] = None

    allow_default_recognizer: Optional[bool] = None

    hw_image_path: Optional[str] = None
    hw_tanv_config_path: Optional[str] = None
    latex_image_path: Optional[str] = None
    latex_tanv_config_path: Optional[str] = None

    visualization_server: Optional[str] = None

    @staticmethod
    def from_xml(root: ET.Element) -> "IndexingInfo":
        """Parse a `<LectureIndexing>` node
        (reference: indexing_info.py:32-103 from_XML_node)."""
        recognition = root.find("SymbolRecognition")
        mappings = recognition.find("LabelCorrections")
        named = recognition.find("PerLecture")
        mir = root.find("MathInformationRetrieval")
        export = root.find("ExportInfo")

        info = IndexingInfo(
            recognizer_config_filename=recognition.findtext("Recognizer"),
            symbolic_mir_config_filename=mir.findtext("Symbolic"),
            image_mir_config_filename=mir.findtext("ImageBased"),
        )
        info.use_explicit_junk = int(recognition.findtext("UseExplicitJunk"))
        info.implicit_junk_threshold = float(
            recognition.findtext("ImplicitJunk"))

        info.mapping_sim_shape_filename = mappings.findtext("SimilarShape")
        info.mapping_rec_to_latex_filename = mappings.findtext("RecToLatex")
        info.mapping_notes_to_rec_filename = mappings.findtext("NotesToRec")
        info.mapping_to_ignore_notes_filename = mappings.findtext(
            "NotesIgnore")

        info.named_hw_classifiers_filename = named.findtext("IndexHW")
        info.named_latex_classifiers_filename = named.findtext("IndexLaTeX")

        info.allow_default_recognizer = (
            int(export.findtext("AllowDefaultRec")) > 0)
        info.hw_image_path = export.findtext("ImagePathHW")
        info.latex_image_path = export.findtext("ImagePathLaTeX")
        info.hw_tanv_config_path = export.findtext("TangentVConfigHW")
        info.latex_tanv_config_path = export.findtext("TangentVConfigLaTeX")

        info.visualization_server = root.findtext("VisualizationServer")
        return info
