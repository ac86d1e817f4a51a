from .config import Config
from .metadata import MetaDataDB, LectureInfo, DataSet
from .artifacts import ArtifactStore
from .timing import StageTimer
